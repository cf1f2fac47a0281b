"""The system under test: the port's batched serving entry,
``tacotron2_subword_tpu_torch.apps.inference.synthesize``, driven with the
weights and requests the benchmark made.  This file is the only one of the
benchmark that imports the program.

``SPANS`` names the module functions the serving entry calls, which the
traced run times from outside; ``KERNELS`` the names of the program's
hand-written kernels as they appear in a device trace; ``counters`` the
program's launch counters.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

TACOTRON = "tacotron2_subword_tpu_torch.models.tacotron2"
HIFIGAN = "tacotron2_subword_tpu_torch.models.hifigan"

# (module, function, span label); the serving entry looks each up on its
# module at call time
SPANS = ((TACOTRON, "infer", "acoustic"),
         (TACOTRON, "decoder_infer", "decode_loop"),
         (HIFIGAN, "generator_apply", "vocoder"))
KERNELS = {"k1": "dequant_int8_matmul"}


def module(name: str):
    return importlib.import_module(name)


class System:
    """The program, set up for one configuration and traffic mix."""

    def __init__(self, config: dict, mix: dict, tree: dict, device):
        from tacotron2_subword_tpu_torch.apps import inference
        from tacotron2_subword_tpu_torch.config import TacotronConfig
        from tacotron2_subword_tpu_torch.models import hifigan
        t = config["tacotron"]
        known = TacotronConfig.__dataclass_fields__
        self.cfg = TacotronConfig().replace(
            **{k: v for k, v in t.items() if k in known})
        h = config["hifigan"]
        self.h = hifigan.HifiganConfig(
            resblock=h["resblock"],
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]),
            num_mels=h["num_mels"], sampling_rate=h["sampling_rate"])
        self.params, self.bn, self.gen = (tree["params"], tree["bn"],
                                          tree["gen"])
        self.mix = mix
        self.device = torch.device(device)
        self._synthesize = inference.synthesize

    def serve(self, requests, generator: torch.Generator):
        """One batch through the serving entry: its output dict."""
        return self._synthesize(
            self.params, self.bn, self.gen, self.cfg, self.h, requests,
            generator=generator, device=self.device,
            max_steps=self.mix["max_steps"],
            gate_threshold=self.mix["gate_threshold"])


def counters() -> Dict[str, int]:
    from tacotron2_subword_tpu_torch.ops import quant
    return {"k1": quant.launches}
