"""Weight-only int8 quantization for the autoregressive decode loop.

Counterpart of ``tacotron2_subword_tpu/ops/quant.py``.  The decode-loop LSTM
weights are quantized once, outside the loop, to int8 with one f32 scale per
output channel (w ~= w_q * scale[n]); each step then streams int8 weights
and applies the scale after the f32-accumulated sum.  For bf16 activations
each product of a bf16 value and an int8 value is exact in f32, so the only
error is the weight rounding itself.

``matmul_dequant_int8`` launches the hand-written CUDA kernel K1
(``csrc/dequant_int8_matmul.cu``: tensor cores for bf16 x, CUDA cores for
f32 x) for CUDA tensors and takes the plain torch version only for tensors
on the CPU.  ``k1_plan`` makes the launch's host-side choices: rows of B per
block and the number of K splits, whose partial sums meet inside one
thread-block cluster, so a call is one launch and needs no workspace.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

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


class K1Plan(NamedTuple):
    """One K1 launch: ``bt`` rows of B per block, K cut into ``splits``
    ranges of ``k_per_split`` (the blocks of one output tile form a cluster
    of ``splits``), ``blocks`` in the grid."""
    bt: int
    splits: int
    k_per_split: int
    blocks: int


MAX_CLUSTER = 8          # portable thread-block cluster size
TC_TILE_N, TC_TILE_K = 128, 64   # bf16 x: columns of N per block, k per stage
F32_TILE_N, F32_CHUNK_K = 128, 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# K splits tried for bf16 x: the size of the thread-block cluster.  4 and
# 8 are left out: at (S, K, N) = (1, 4096, 4096) each took 1.06-1.27x the
# time of both its neighbours on the H100 (PERF.md, K1 split sweep).
TC_SPLITS = (1, 2, 3, 5, 6, 7)


def _default_capacity(sms: int) -> Callable[[int, int], int]:
    """Clusters of s blocks that fit at once when an SM holds two blocks,
    without the card's placement limits: the CPU's stand-in for
    ``cudaOccupancyMaxActiveClusters``."""
    return lambda bt, s: (2 * sms) // s


def k1_plan(S: int, B: int, K: int, N: int, x_bf16: bool, sms: int = 132,
            capacity: Optional[Callable[[int, int], int]] = None) -> K1Plan:
    """The launch K1 makes for this shape on a card with ``sms`` SMs.

    bf16 x: the smallest of 8/16/32/64/128 rows covering B (128 beyond); K
    cut into s of ``TC_SPLITS`` ranges of whole 64-row tiles, none empty,
    with all blocks in one wave (``capacity(bt, s)`` clusters at once), at
    the least (tiles per block) x (blocks per SM), the larger s on a tie.
    f32 x: 1/2/4/8 rows; K split in 256-row chunks until there are about
    two blocks per SM, at most 8 splits (one cluster)."""
    if not x_bf16:
        bt = 8 if B >= 8 else 4 if B >= 4 else 2 if B >= 2 else 1
        tiles = S * _cdiv(N, F32_TILE_N) * _cdiv(B, bt)
        units = max(1, _cdiv(K, F32_CHUNK_K))
        splits = max(1, min(MAX_CLUSTER, units,
                            _cdiv(2 * sms, max(tiles, 1))))
        per = _cdiv(units, splits)
        splits = _cdiv(units, per)
        return K1Plan(bt, splits, per * F32_CHUNK_K, tiles * splits)
    bt = next((t for t in (8, 16, 32, 64) if B <= t), 128)
    tiles = S * _cdiv(N, TC_TILE_N) * _cdiv(B, bt)
    units = max(1, _cdiv(K, TC_TILE_K))
    capacity = capacity or _default_capacity(sms)
    best = (units * _cdiv(tiles, sms), 1, units)
    for s in TC_SPLITS[1:]:
        per = _cdiv(units, s)
        if s > units or _cdiv(units, per) != s:
            continue          # a split would be empty
        if tiles * s > capacity(bt, s) * s:
            continue          # not one wave
        cost = per * _cdiv(tiles * s, sms)
        if cost <= best[0]:
            best = (cost, s, per)
    _, splits, per = best
    return K1Plan(bt, splits, per * TC_TILE_K, tiles * splits)


_sm_counts = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


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
    bf16 = x.dtype == torch.bfloat16
    lib = _lib()
    key = (x.device.index, S, B, K, N, bf16)
    plan = _plans.get(key)
    if plan is None:   # the decode asks for the same few shapes every step
        plan = _plans[key] = k1_plan(
            S, B, K, N, bf16, _sm_count(x.device),
            lambda bt, s: _max_clusters(lib, x.device, bt, s))
    with torch.cuda.device(x.device):
        code = lib.t2s_dequant_int8_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            S, B, K, N, int(bf16), plan.bt, plan.splits, plan.k_per_split,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "dequant_int8_matmul")
    launches += 1
    return y


_clusters = {}
_plans = {}


def _max_clusters(lib: ctypes.CDLL, device: torch.device, bt: int,
                  s: int) -> int:
    """Clusters of s blocks of the bf16 kernel at row tile bt that the card
    holds at once (cudaOccupancyMaxActiveClusters), cached."""
    key = (device.index, bt, s)
    if key not in _clusters:
        with torch.cuda.device(device):
            n = lib.t2s_k1_max_active_clusters(bt, s)
        if n < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for "
                               f"bt={bt}, cluster {s}")
        _clusters[key] = n
    return _clusters[key]


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.t2s_dequant_int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.t2s_k1_max_active_clusters.argtypes = [ctypes.c_int] * 2
        lib.t2s_k1_max_active_clusters.restype = ctypes.c_int
    return lib
