"""Soft-DTW on a distance matrix, with the hand-written kernels K2 and K3.

Counterpart of ``tacotron2_subword_tpu/ops/softdtw.py`` (Cuturi & Blondel
2017, as the reference's numba CUDA kernels compute it):

    R[i,j] = D[i,j] + softmin_gamma(R[i-1,j], R[i,j-1], R[i-1,j-1])

with R[-1,-1] = 0, every other edge +INF, an optional Sakoe-Chiba band
(|i-j| <= bandwidth on 1-based indices; bandwidth <= 0 means none) and
value = R[N-1,M-1].  E = d value / d D comes from the reversed wavefront.
INF is the finite sentinel 1e30, so only f32 is taken.

 - ``softdtw_grad(D, gamma, bw) -> (value, E)`` launches K2
   (``csrc/softdtw.cu`` ``t2s_softdtw_grad``, forward and backward in one
   launch) for a CUDA tensor; ``k2_plan`` picks its variant: R, D and E in
   shared memory where they fit in a block's 227 KB (128 x 128), else R in
   a device-memory workspace (allocated only then);
 - ``softdtw_value(D, gamma, bw) -> value`` launches K3
   (``t2s_softdtw_fwd``, forward only: a warp-pipelined wavefront that
   passes R between lanes by shuffles) for a CUDA tensor; ``k3_plan`` picks
   its warps and where the rows handed from warp to warp live;
 - ``softdtw_diff`` is differentiable: where D needs a gradient its forward
   runs K2 and keeps E for the backward, otherwise it runs K3;
 - ``softdtw`` is the plain implementation as a differentiable op (the JAX
   package's scan ``softdtw``), chosen with ``softdtw_impl="scan"``;
 - ``softdtw_distance`` (sequences -> value, as ``apps/evaluation.py``
   calls it) takes the kernels through ``softdtw_diff``.

A CPU tensor takes the kernels' plain versions (``softdtw_grad_plain``,
``softdtw_value_plain``); a CUDA tensor launches the kernel or raises.
``grad_launches`` and ``fwd_launches`` count K2's and K3's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from tacotron2_subword_tpu_torch.ops import _build

INF = 1e30
KERNEL = "softdtw"
grad_launches = 0  # K2 launches since the last reset (set to 0 to reset)
fwd_launches = 0   # K3 launches since the last reset


def euclidean_dist_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances: x [B,N,D], y [B,M,D] ->
    [B,N,M] (the cross term summed in f32), clamped at 0."""
    x2 = torch.sum(x * x, dim=-1)[:, :, None]
    y2 = torch.sum(y * y, dim=-1)[:, None, :]
    xy = torch.einsum("bnd,bmd->bnm", x.float(), y.float())
    return torch.clamp_min(x2 + y2 - 2 * xy, 0.0).to(x.dtype)


def band_mask(N: int, M: int, bandwidth: Optional[float],
              device=None) -> torch.Tensor:
    """[N, M] bool: True where |i-j| <= bandwidth (1-based), everywhere when
    bandwidth <= 0."""
    if bandwidth is None or bandwidth <= 0:
        return torch.ones((N, M), dtype=torch.bool, device=device)
    i = torch.arange(1, N + 1, device=device)[:, None]
    j = torch.arange(1, M + 1, device=device)[None, :]
    return (i - j).abs() <= bandwidth


def _softmin3(a, b, c, gamma: float):
    """-gamma * logsumexp(-[a, b, c] / gamma), stable."""
    r0, r1, r2 = -a / gamma, -b / gamma, -c / gamma
    rmax = torch.maximum(torch.maximum(r0, r1), r2)
    rsum = torch.exp(r0 - rmax) + torch.exp(r1 - rmax) + torch.exp(r2 - rmax)
    return -gamma * (torch.log(rsum) + rmax)


def _diagonals(D: torch.Tensor, bandwidth) -> torch.Tensor:
    """D [B,N,M] -> [P,B,N] with out[p,b,i] = D[b,i,p-i]; +INF off the grid
    and outside the band."""
    B, N, M = D.shape
    P = N + M - 1
    dev = D.device
    i = torch.arange(N, device=dev)
    j = torch.arange(P, device=dev)[:, None] - i[None, :]          # [P, N]
    valid = (j >= 0) & (j < M)
    Dm = torch.where(band_mask(N, M, bandwidth, dev)[None], D, INF)
    d = Dm[:, i[None, :], j.clamp(0, M - 1)]                       # [B, P, N]
    return torch.where(valid[None], d, INF).permute(1, 0, 2)


def _shift_down(r: torch.Tensor, fill: float) -> torch.Tensor:
    """Row i takes row i-1 (along the last axis); row 0 takes ``fill``."""
    return torch.cat([torch.full_like(r[:, :1], fill), r[:, :-1]], dim=1)


def _shift_up(r: torch.Tensor, fill: float) -> torch.Tensor:
    """Row i takes row i+1; the last row takes ``fill``."""
    return torch.cat([r[:, 1:], torch.full_like(r[:, :1], fill)], dim=1)


def _forward_scan(D: torch.Tensor, gamma: float, bandwidth, keep_r: bool):
    """Plain forward wavefront.  Returns (value [B], R diagonals [P,B,N] or
    None).  Dead cells (off the grid, outside the band) hold +INF."""
    B, N, M = D.shape
    diag_d = _diagonals(D, bandwidth)
    r1 = torch.full((B, N), INF, dtype=D.dtype, device=D.device)
    r2 = r1
    rs = [] if keep_r else None
    for p in range(diag_d.shape[0]):
        d_p = diag_d[p]
        dd = _shift_down(r2, 0.0 if p == 0 else INF)   # origin seed R[-1,-1]
        sm = _softmin3(_shift_down(r1, INF), r1, dd, gamma)
        r = torch.where(d_p >= INF / 2, INF, d_p + sm)
        if keep_r:
            rs.append(r)
        r1, r2 = r, r1
    return r1[:, N - 1], (torch.stack(rs) if keep_r else None)


def _backward_scan(D: torch.Tensor, r_diags: torch.Tensor, gamma: float,
                   bandwidth) -> torch.Tensor:
    """Plain reverse wavefront: E = d value / d D [B,N,M]."""
    B, N, M = D.shape
    P = N + M - 1
    diag_d = _diagonals(D, bandwidth)
    dz = torch.where(diag_d >= INF / 2, 0.0, diag_d)
    R = torch.where(r_diags >= INF / 2, -INF, r_diags)
    neg = torch.full((B, N), -INF, dtype=D.dtype, device=D.device)
    zero = torch.zeros((B, N), dtype=D.dtype, device=D.device)
    e1 = e2 = zero
    es = [None] * P
    for p in range(P - 1, -1, -1):
        r_p = R[p]
        r_n1, d_n1 = (R[p + 1], dz[p + 1]) if p + 1 < P else (neg, zero)
        r_n2, d_n2 = (R[p + 2], dz[p + 2]) if p + 2 < P else (neg, zero)
        # successors (i+1, j), (i, j+1), (i+1, j+1)
        ea = _shift_up(e1, 0.0) * torch.exp(
            (_shift_up(r_n1, -INF) - r_p - _shift_up(d_n1, 0.0)) / gamma)
        eb = e1 * torch.exp((r_n1 - r_p - d_n1) / gamma)
        ec = _shift_up(e2, 0.0) * torch.exp(
            (_shift_up(r_n2, -INF) - r_p - _shift_up(d_n2, 0.0)) / gamma)
        e = ea + eb + ec
        if p == P - 1:
            e = torch.cat([e[:, :N - 1], torch.ones_like(e[:, :1])], dim=1)
        e = torch.where(r_p <= -INF / 2, 0.0, e)   # dead cells, after the sum
        es[p] = e
        e1, e2 = e, e1
    e_diag = torch.stack(es, dim=1)                                # [B, P, N]
    i = torch.arange(N, device=D.device)[:, None]
    j = torch.arange(M, device=D.device)[None, :]
    return e_diag[:, i + j, i]


def softdtw_grad_plain(D: torch.Tensor, gamma: float = 1.0,
                       bandwidth: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: (value [B], E [B,N,M])."""
    value, r_diags = _forward_scan(D, gamma, bandwidth, keep_r=True)
    return value, _backward_scan(D, r_diags, gamma, bandwidth)


def softdtw_value_plain(D: torch.Tensor, gamma: float = 1.0,
                        bandwidth: float = 0.0) -> torch.Tensor:
    """Plain version of K3: value [B]."""
    return _forward_scan(D, gamma, bandwidth, keep_r=False)[0]


def _on_cuda(D: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version); True for a CUDA tensor that
    the kernels take; raises otherwise."""
    if D.dim() != 3:
        raise ValueError(f"want D [B, N, M], got {tuple(D.shape)}")
    if D.dtype != torch.float32:
        raise TypeError(f"soft-DTW takes f32 only (INF = 1e30), got {D.dtype}")
    if D.device.type == "cpu":
        return False
    if D.device.type != "cuda":
        raise ValueError(f"D must be on the CPU or a CUDA device, got "
                         f"{D.device}")
    if not D.is_contiguous():
        raise ValueError("D must be contiguous")
    return True


# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448


class K2Plan(NamedTuple):
    """K2's launch for one shape: the shared variant (``shared``) or the
    global one with ``workspace_floats`` of scratch for R; the backward's
    weights ``chunk`` diagonals at a time; ``smem_bytes`` of dynamic shared
    memory."""
    shared: bool
    chunk: int
    smem_bytes: int
    workspace_floats: int

    @property
    def variant(self) -> str:
        return "shared" if self.shared else "global"


def _even(n: int) -> int:
    return n + (n & 1)


K2_CHUNK = 16  # most diagonals whose backward weights are made at once


def k2_plan(B: int, N: int, M: int, variant: Optional[str] = None) -> K2Plan:
    """The shared variant where D and E [N, even(M)], the bordered R
    [N+2, even(M+2)] (f32; even row strides keep a diagonal walk free of
    bank conflicts) and the double-buffered weights of at least one
    diagonal [2, 3, N] fit in ``SMEM_LIMIT``; else the global one, with an
    R workspace of B (N+2) (M+2) floats.  The weight buffer takes up to
    ``K2_CHUNK`` diagonals per half, as many as fit.  ``variant``
    ("shared", "global") forces one; a variant that does not fit raises."""
    if variant not in (None, "shared", "global"):
        raise ValueError(f"variant must be shared or global, got {variant!r}")
    base = 4 * (2 * N * _even(M) + (N + 2) * _even(M + 2))
    per_diag = 24 * N
    fits = base + per_diag <= SMEM_LIMIT
    if variant == "shared" and not fits:
        raise ValueError(f"K2 shared variant needs {base + per_diag} B of "
                         f"shared memory at {N} x {M}; a block has "
                         f"{SMEM_LIMIT}")
    if variant == "shared" or (variant is None and fits):
        chunk = min(K2_CHUNK, (SMEM_LIMIT - base) // per_diag)
        return K2Plan(True, chunk, base + per_diag * chunk, 0)
    if per_diag > SMEM_LIMIT:
        raise ValueError(f"K2 takes N <= {SMEM_LIMIT // 24}, got {N}")
    chunk = min(K2_CHUNK, SMEM_LIMIT // per_diag)
    return K2Plan(False, chunk, per_diag * chunk, B * (N + 2) * (M + 2))


def softdtw_grad(D: torch.Tensor, gamma: float = 1.0, bandwidth: float = 0.0,
                 variant: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value [B], E = d value / d D [B,N,M]) for D [B,N,M] f32: K2 on a
    CUDA tensor (the variant ``k2_plan`` picks, or ``variant``), its plain
    version on a CPU tensor."""
    global grad_launches
    if not _on_cuda(D):
        return softdtw_grad_plain(D, gamma, bandwidth)
    B, N, M = D.shape
    plan = k2_plan(B, N, M, variant)
    value = torch.empty((B,), dtype=torch.float32, device=D.device)
    E = torch.empty((B, N, M), dtype=torch.float32, device=D.device)
    ws = (torch.empty((plan.workspace_floats,), dtype=torch.float32,
                      device=D.device) if plan.workspace_floats else None)
    lib = _lib()
    with torch.cuda.device(D.device):
        code = lib.t2s_softdtw_grad(
            D.data_ptr(), None if ws is None else ws.data_ptr(),
            E.data_ptr(), value.data_ptr(), B, N, M, float(gamma),
            float(bandwidth or 0.0), int(plan.shared), plan.chunk,
            plan.smem_bytes, torch.cuda.current_stream(D.device).cuda_stream)
    _build.check(lib, code, "softdtw_grad")
    grad_launches += 1
    return value, E


class K3Plan(NamedTuple):
    """K3's launch for one shape: ``warps`` warps of one row per lane,
    taking the ``ceil(N / 32)`` warp-rows in ``strips`` turns; the warp-to-
    warp handoff and the D stream every ``chunk`` columns; ``smem_bytes`` of
    dynamic shared memory; ``scratch_floats`` of device memory for the
    rows handed between warps (0: they live in shared memory)."""
    warps: int
    strips: int
    chunk: int
    smem_bytes: int
    scratch_floats: int


# K3's constants, as in csrc/softdtw.cu: the handoff / D chunk (kChunk), the
# D ring's row stride (kStride = kRing + 2), and the most warps a block
# gets (a warp-row more than that waits for a second strip).
K3_CHUNK = 8
K3_STRIDE = 66
K3_MAX_WARPS = 16


def _k3_smem_bytes(M: int, warps: int, bnd_shared: bool) -> int:
    """As ``fwd_smem_bytes`` in csrc/softdtw.cu: the handoff counters
    [warps] padded to 16 bytes, the D rings [warps, 32, K3_STRIDE] and,
    where they live on chip, the boundary rows [warps, M]; all 4 bytes."""
    return 4 * (-(-warps // 4) * 4 + warps * 32 * K3_STRIDE
                + (warps * M if bnd_shared else 0))


def k3_plan(B: int, N: int, M: int, warps: Optional[int] = None) -> K3Plan:
    """One warp per 32 rows, up to ``K3_MAX_WARPS`` (``warps`` forces a
    count, 1-32); the boundary rows [warps, M] in shared memory where the
    whole fits in ``SMEM_LIMIT``, else a scratch of B * warps * M floats.
    Raises on an empty shape, on N * M >= 2**31 (the kernel's int column
    counts) and on warps whose D rings alone do not fit."""
    if min(B, N, M) < 1:
        raise ValueError(f"K3 takes B, N, M >= 1, got {(B, N, M)}")
    if N * M >= 2 ** 31:
        raise ValueError(f"K3 takes N * M < 2**31, got {N} x {M}")
    rows = -(-N // 32)
    if warps is None:
        warps = min(rows, K3_MAX_WARPS)
    elif not 1 <= warps <= 32:
        raise ValueError(f"K3 takes 1-32 warps, got {warps}")
    if _k3_smem_bytes(M, warps, False) > SMEM_LIMIT:
        raise ValueError(f"K3's D rings for {warps} warps need "
                         f"{_k3_smem_bytes(M, warps, False)} B of shared "
                         f"memory; a block has {SMEM_LIMIT}")
    strips = -(-rows // warps)
    on_chip = _k3_smem_bytes(M, warps, True)
    if on_chip <= SMEM_LIMIT:
        return K3Plan(warps, strips, K3_CHUNK, on_chip, 0)
    return K3Plan(warps, strips, K3_CHUNK, _k3_smem_bytes(M, warps, False),
                  B * warps * M)


def softdtw_value(D: torch.Tensor, gamma: float = 1.0,
                  bandwidth: float = 0.0,
                  warps: Optional[int] = None) -> torch.Tensor:
    """value [B] for D [B,N,M] f32: K3 on a CUDA tensor (the launch
    ``k3_plan`` picks; ``warps`` forces its warp count), its plain version
    on a CPU tensor."""
    global fwd_launches
    if not _on_cuda(D):
        return softdtw_value_plain(D, gamma, bandwidth)
    B, N, M = D.shape
    plan = k3_plan(B, N, M, warps)
    value = torch.empty((B,), dtype=torch.float32, device=D.device)
    scratch = (torch.empty((plan.scratch_floats,), dtype=torch.float32,
                           device=D.device) if plan.scratch_floats else None)
    lib = _lib()
    with torch.cuda.device(D.device):
        code = lib.t2s_softdtw_fwd(
            D.data_ptr(), None if scratch is None else scratch.data_ptr(),
            value.data_ptr(), B, N, M, float(gamma), float(bandwidth or 0.0),
            plan.warps, plan.chunk, plan.smem_bytes,
            torch.cuda.current_stream(D.device).cuda_stream)
    _build.check(lib, code, "softdtw_fwd")
    fwd_launches += 1
    return value


def _needs_grad(D: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and D.requires_grad


class _SoftDTWKernels(torch.autograd.Function):
    """K2 in the forward, E kept for the backward g[:, None, None] * E."""

    @staticmethod
    def forward(ctx, D, gamma, bandwidth):
        value, E = softdtw_grad(D, gamma, bandwidth)
        ctx.save_for_backward(E)
        return value

    @staticmethod
    def backward(ctx, g):
        (E,) = ctx.saved_tensors
        return g[:, None, None] * E, None, None


class _SoftDTWPlain(torch.autograd.Function):
    """The plain implementation: forward wavefront keeping R, reverse
    wavefront in the backward."""

    @staticmethod
    def forward(ctx, D, gamma, bandwidth):
        value, r_diags = _forward_scan(D, gamma, bandwidth, keep_r=True)
        ctx.save_for_backward(D, r_diags)
        ctx.gamma, ctx.bandwidth = gamma, bandwidth
        return value

    @staticmethod
    def backward(ctx, g):
        D, r_diags = ctx.saved_tensors
        E = _backward_scan(D, r_diags, ctx.gamma, ctx.bandwidth)
        return g[:, None, None] * E, None, None


def softdtw_diff(D: torch.Tensor, gamma: float = 1.0,
                 bandwidth: float = 0.0) -> torch.Tensor:
    """Differentiable soft-DTW value [B] through the kernels (the JAX
    package's ``softdtw_pallas_diff``): K2 where D needs a gradient, K3
    where it does not (no autograd, or under ``torch.no_grad``)."""
    if _needs_grad(D):
        return _SoftDTWKernels.apply(D, gamma, bandwidth)
    return softdtw_value(D, gamma, bandwidth)


def softdtw(D: torch.Tensor, gamma: float = 1.0,
            bandwidth: float = 0.0) -> torch.Tensor:
    """Differentiable soft-DTW value [B] through the plain implementation
    (the JAX package's scan ``softdtw``)."""
    if _needs_grad(D):
        return _SoftDTWPlain.apply(D, gamma, bandwidth)
    return _forward_scan(D, gamma, bandwidth, keep_r=False)[0]


def softdtw_distance(x: torch.Tensor, y: torch.Tensor, *, gamma: float = 1.0,
                     bandwidth: float = 0.0,
                     normalize: bool = False) -> torch.Tensor:
    """Soft-DTW between batched sequences x [B,N,D] and y [B,M,D] through
    the kernels (``softdtw_diff``: K3 without a gradient, K2 with one); with
    ``normalize`` the divergence d(x,y) - (d(x,x) + d(y,y)) / 2."""
    dist = lambda a, b: euclidean_dist_matrix(a, b).contiguous()
    d_xy = softdtw_diff(dist(x, y), gamma, bandwidth)
    if not normalize:
        return d_xy
    d_xx = softdtw_diff(dist(x, x), gamma, bandwidth)
    d_yy = softdtw_diff(dist(y, y), gamma, bandwidth)
    return d_xy - 0.5 * (d_xx + d_yy)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.t2s_softdtw_grad.argtypes is None:
        f = ctypes.c_float
        lib.t2s_softdtw_grad.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [f, f, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_void_p])
        lib.t2s_softdtw_grad.restype = ctypes.c_int
        lib.t2s_softdtw_fwd.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [f, f, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_void_p])
        lib.t2s_softdtw_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.t2s_softdtw_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.t2s_softdtw_fwd.restype = ctypes.c_int
    return lib
