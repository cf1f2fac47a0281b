"""The epilogue of HiFi-GAN's channels-last convolutions, with the
hand-written kernel K4.

One pass over a convolution's output ``y`` [R, C] (the R = B*T rows of a
channels-last [B, C, 1, T] activation, C contiguous), as PyTorch's own
kernels compute it, in this order:

    v = y + bias                       (the convolution's bias, [C])
    v = v + residual                   (a resblock's residual)
    v = mrf_sum + v                    (the multi-receptive-field sum)
    v = v / mrf_div                    (its average over the nk resblocks)
    out_pre <- v
    out_act <- leaky_relu(v, slope) or tanh(v)

Every step but the bias and the writes is optional; ``out_pre`` may be
``y`` or ``mrf_sum`` and ``out_act`` may be ``y`` (each element is read
before it is written).  ``v / mrf_div`` is torch's division by a Python
number: on the card a product with the f32 reciprocal, which the kernel
computes the same way.  Every tensor is f32, bf16 or f16, all one dtype;
in bf16 and f16 each step is computed in f32 and rounded to the dtype, as
torch rounds each op's output.

 - ``conv_epilogue`` launches K4 (``csrc/conv_epilogue.cu``
   ``t2s_conv_epilogue``) for CUDA tensors and runs the plain version for
   CPU tensors;
 - ``conv_epilogue_plain`` is the plain version: the same f32 operations
   as torch ops, so K4 is bit-equal to it on the card.

``launches`` counts K4's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.ops import _build

KERNEL = "conv_epilogue"
ACTS = {"lrelu": 1, "tanh": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
launches = 0  # K4 launches since the last reset (set to 0 to reset)


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, *,
                        residual: Optional[torch.Tensor] = None,
                        mrf_sum: Optional[torch.Tensor] = None,
                        mrf_div: int = 0,
                        out_pre: Optional[torch.Tensor] = None,
                        out_act: Optional[torch.Tensor] = None,
                        act: str = "lrelu", slope: float = 0.1) -> None:
    """The epilogue as torch ops (the module docstring's order)."""
    _check_args(y, bias, residual, mrf_sum, mrf_div, out_pre, out_act, act)
    v = y + bias
    if residual is not None:
        v = v + residual
    if mrf_sum is not None:
        v = mrf_sum + v
    if mrf_div:
        v = v / mrf_div
    if out_pre is not None:
        out_pre.copy_(v)
    if out_act is not None:
        out_act.copy_(torch.tanh(v) if act == "tanh"
                      else F.leaky_relu(v, slope))


def _check_args(y, bias, residual, mrf_sum, mrf_div, out_pre, out_act, act):
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if out_pre is None and out_act is None:
        raise ValueError("conv_epilogue writes nothing: give out_pre or "
                         "out_act")
    if mrf_div < 0:
        raise ValueError(f"mrf_div must be >= 0, got {mrf_div}")
    if y.dim() != 2 or bias.shape != (y.shape[1],):
        raise ValueError(f"y must be [R, C] and bias [C]; got "
                         f"{tuple(y.shape)} and {tuple(bias.shape)}")
    rows = {"residual": residual, "mrf_sum": mrf_sum, "out_pre": out_pre,
            "out_act": out_act}
    for name, t in rows.items():
        if t is not None and t.shape != y.shape:
            raise ValueError(f"{name} must be {tuple(y.shape)}, got "
                             f"{tuple(t.shape)}")
    if y.dtype not in DTYPES:
        raise TypeError(f"y must be float32, bfloat16 or float16, got "
                        f"{y.dtype}")
    for name, t in {"bias": bias, **rows}.items():
        if t is not None and t.dtype != y.dtype:
            raise TypeError(f"{name} must be {y.dtype} as y, got {t.dtype}")


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, *,
                  residual: Optional[torch.Tensor] = None,
                  mrf_sum: Optional[torch.Tensor] = None,
                  mrf_div: int = 0,
                  out_pre: Optional[torch.Tensor] = None,
                  out_act: Optional[torch.Tensor] = None,
                  act: str = "lrelu", slope: float = 0.1) -> None:
    """The epilogue (module docstring) into ``out_pre`` / ``out_act``.

    CPU tensors take the plain version; CUDA tensors launch K4 or raise."""
    global launches
    given = [t for t in (y, bias, residual, mrf_sum, out_pre, out_act)
             if t is not None]
    devices = {t.device for t in given}
    if devices == {torch.device("cpu")}:
        conv_epilogue_plain(y, bias, residual=residual, mrf_sum=mrf_sum,
                            mrf_div=mrf_div, out_pre=out_pre,
                            out_act=out_act, act=act, slope=slope)
        return
    _check_args(y, bias, residual, mrf_sum, mrf_div, out_pre, out_act, act)
    if len(devices) != 1 or y.device.type != "cuda":
        raise ValueError(f"every tensor must share one CUDA device or all "
                         f"be on the CPU; got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("every tensor must be contiguous")
    R, C = y.shape
    width = 4 * y.element_size()       # bytes of a 4-channel access
    vec = 4 if C % 4 == 0 and all(t.data_ptr() % width == 0 for t in given
                                  if t is not bias) else 1
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    with torch.cuda.device(y.device):
        code = lib.t2s_conv_epilogue(
            y.data_ptr(), bias.data_ptr(), ptr(residual), ptr(mrf_sum),
            ptr(out_pre), ptr(out_act), R, C, int(mrf_div),
            ACTS[act] if out_act is not None else 0, float(slope), vec,
            DTYPES[y.dtype], torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, code, "conv_epilogue")
    launches += 1


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.t2s_conv_epilogue
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
