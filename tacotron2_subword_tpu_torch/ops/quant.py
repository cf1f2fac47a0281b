"""Weight-only int8 quantization for the autoregressive decode loop.

Counterpart of ``tacotron2_subword_tpu/ops/quant.py``.  The decode-loop LSTM
weights are quantized once, outside the loop, to int8 with one f32 scale per
output channel (w ~= w_q * scale[n]); each step then streams int8 weights
and applies the scale after the f32-accumulated sum.  For bf16 activations
each product of a bf16 value and an int8 value is exact in f32, so the only
error is the weight rounding itself.

``matmul_dequant_int8`` launches the hand-written CUDA kernel K1
(``csrc/dequant_int8_matmul.cu``) for CUDA tensors and takes the plain torch
version only for tensors on the CPU.  ``launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tacotron2_subword_tpu_torch.ops import _build

KERNEL = "dequant_int8_matmul"
launches = 0  # K1 launches since the last reset (set to 0 to reset)


def quantize_int8(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``w`` with one scale per slice along
    every dim but ``axis`` (the contraction axis).

    Returns (w_q int8 of w's shape, scale f32 with ``axis`` removed).  Bit
    for bit the JAX package's result: amax, the 1e-8 floor, the division and
    round-half-to-even all happen in f32 in the same order."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8).to(torch.float32) / 127.0
    w_q = torch.clamp(torch.round(w.to(torch.float32) / scale), -127, 127)
    return w_q.to(torch.int8), scale.squeeze(axis)


def matmul_dequant_int8_plain(x: torch.Tensor, w_q: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: x [S,B,K] float, w_q [S,K,N] int8, scale [S,N]
    -> [S,B,N] f32, summed in f32 and scaled after the sum."""
    y = torch.einsum("sbk,skn->sbn", x.to(torch.float32),
                     w_q.to(torch.float32))
    return y * scale[:, None, :].to(torch.float32)


def _check_args(x, w_q, scale):
    if x.dim() != 3 or w_q.dim() != 3 or scale.dim() != 2:
        raise ValueError(f"want x [S,B,K], w_q [S,K,N], scale [S,N]; got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    S, B, K = x.shape
    if w_q.shape[:2] != (S, K) or tuple(scale.shape) != (S, w_q.shape[2]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"w_q must be int8 and scale f32, got {w_q.dtype}, "
                        f"{scale.dtype}")


def matmul_dequant_int8(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Stacked weight-dequantizing matmul: x [S,B,K] (bf16 or f32) x w_q
    [S,K,N] int8, scale [S,N] f32 -> [S,B,N] f32.

    CPU tensors take the plain version; CUDA tensors launch K1 or raise."""
    global launches
    _check_args(x, w_q, scale)
    devices = {x.device, w_q.device, scale.device}
    if devices == {torch.device("cpu")}:
        return matmul_dequant_int8_plain(x, w_q, scale)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"x, w_q and scale must share one CUDA device or "
                         f"all be on the CPU; got {sorted(map(str, devices))}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("x, w_q and scale must be contiguous")
    S, B, K = x.shape
    N = w_q.shape[2]
    y = torch.empty((S, B, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        n_ws = lib.t2s_dequant_int8_matmul_workspace(S, B, K, N)
        ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
              if n_ws else None)
        code = lib.t2s_dequant_int8_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), S, B, K, N,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "dequant_int8_matmul")
    launches += 1
    return y


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.t2s_dequant_int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        wsq = lib.t2s_dequant_int8_matmul_workspace
        wsq.argtypes = [ctypes.c_int] * 4
        wsq.restype = ctypes.c_longlong
    return lib
