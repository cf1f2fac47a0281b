from tacotron2_subword_tpu_torch.text.text_to_sequence import Text2Seq
from tacotron2_subword_tpu_torch.text.g2p import G2P, G2PFst, default_g2p_config

__all__ = ["Text2Seq", "G2P", "G2PFst", "default_g2p_config"]
