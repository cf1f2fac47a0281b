"""The port's kernels against their plain versions.  Imports no JAX, so it
also runs on a machine with a card and without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The tests marked ``cuda`` build and launch the CUDA kernels and skip where
there is no CUDA device."""

import math
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.ops import conv_epilogue as TE
from tacotron2_subword_tpu_torch.ops import quant as TQ
from tacotron2_subword_tpu_torch.ops import softdtw as TS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(S, B, K, N, x_dtype, seed, device="cpu"):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(S, B, K).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy(rng.randn(S, K, N).astype(np.float32))
    w_q, scale = TQ.quantize_int8(w, axis=1)
    return x.to(device), w_q.to(device), scale.to(device)


def _numpy_ref(x, w_q, scale):
    y = np.einsum("sbk,skn->sbn", x.float().cpu().numpy().astype(np.float64),
                  w_q.cpu().numpy().astype(np.float64))
    return y * scale.cpu().numpy()[:, None, :]


@pytest.mark.parametrize("S,B,K,N", [(2, 3, 46, 80), (1, 5, 37, 83),
                                     (3, 1, 1, 1)])
def test_plain_matches_float64_sum(S, B, K, N):
    """f32 sums of exact products against a float64 sum: 1e-5 relative."""
    x, w_q, scale = _inputs(S, B, K, N, torch.bfloat16, seed=0)
    y = TQ.matmul_dequant_int8(x, w_q, scale)
    ref = _numpy_ref(x, w_q, scale)
    assert y.shape == (S, B, N) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "shape", "rank"])
def test_wrapper_rejects_bad_arguments(bad):
    x, w_q, scale = _inputs(2, 3, 8, 16, torch.float32, seed=1)
    if bad == "x_dtype":
        x = x.to(torch.float16)
    elif bad == "w_dtype":
        w_q = w_q.to(torch.int16)
    elif bad == "shape":
        scale = scale[:, :-1]
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        TQ.matmul_dequant_int8(x, w_q, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,K,N", [(2, 4, 1792, 4096), (1, 4, 4096, 4096),
                                     (2, 3, 46, 80), (1, 5, 37, 83)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain_on_card(cuda_device, S, B, K, N, x_dtype):
    """K1 and the plain version sum the same f32 products in another order:
    max|d| <= 1e-4 * max|ref| (f32 x), 2e-3 * max|ref| (bf16 x)."""
    x, w_q, scale = _inputs(S, B, K, N, x_dtype, seed=2, device=cuda_device)
    before = TQ.launches
    y = TQ.matmul_dequant_int8(x, w_q, scale)
    ref = TQ.matmul_dequant_int8_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert TQ.launches == before + 1
    tol = (1e-4 if x_dtype == torch.float32 else 2e-3) * ref.abs().max()
    assert (y - ref).abs().max() <= tol


SDTW_SHAPES = [((8, 128, 128), 0.0), ((8, 256, 256), 0.0), ((3, 17, 15), 0.0),
               ((2, 20, 30), 0.0), ((2, 20, 30), 12.0), ((2, 24, 24), 5.0),
               ((2, 9, 9), 2.0), ((1, 1100, 900), 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bw", SDTW_SHAPES)
def test_softdtw_kernels_match_plain_on_card(cuda_device, shape, bw):
    """K2 (value, E) and K3 (value) against their plain versions: the same
    f32 operations in the same order, so |d value| <= 1e-5 * max(1,
    |value|) and |d E| <= 1e-5; each kernel run twice gives bit-equal
    results (a missing barrier shows as drift); E is 0 outside the band."""
    B, N, M = shape
    g = torch.Generator(device=cuda_device).manual_seed(N + M)
    x = torch.randn((B, N, 8), generator=g, device=cuda_device)
    y = torch.randn((B, M, 8), generator=g, device=cuda_device)
    D = TS.euclidean_dist_matrix(x, y)
    k2, k3 = TS.grad_launches, TS.fwd_launches
    v, E = TS.softdtw_grad(D, 1.0, bw)
    v_again, E_again = TS.softdtw_grad(D, 1.0, bw)
    v3 = TS.softdtw_value(D, 1.0, bw)
    v3_again = TS.softdtw_value(D, 1.0, bw)
    pv, pE = TS.softdtw_grad_plain(D, 1.0, bw)
    torch.cuda.synchronize()
    assert (TS.grad_launches, TS.fwd_launches) == (k2 + 2, k3 + 2)
    assert torch.equal(v, v_again) and torch.equal(E, E_again)
    assert torch.equal(v3, v3_again)
    tol = 1e-5 * pv.abs().clamp_min(1.0)
    assert ((v - pv).abs() <= tol).all() and ((v3 - pv).abs() <= tol).all()
    assert (E - pE).abs().max().item() <= 1e-5
    assert torch.isfinite(E).all()
    banned = ~TS.band_mask(N, M, bw, cuda_device)
    assert (E[:, banned] == 0).all()


# ---- host-side decisions (CPU) -------------------------------------------

@pytest.mark.parametrize("N,M,variant", [(128, 128, "shared"),
                                         (256, 256, "global"),
                                         (1100, 900, "global")])
def test_k2_fit_guard_and_workspace(N, M, variant):
    """K2 keeps D, R, E in shared memory where they fit in a block's 227 KB
    (the train step's 128 x 128) and asks for an R workspace only for the
    global variant (the CLI's 256 x 256 bucket, long utterances)."""
    B = 8
    plan = TS.k2_plan(B, N, M)
    assert plan.variant == variant
    assert 0 < plan.smem_bytes <= TS.SMEM_LIMIT and plan.chunk >= 1
    if variant == "shared":
        assert plan.workspace_floats == 0
        # D and E [N, even(M)], R [N+2, even(M+2)], weights [2, chunk, 3, N]
        assert plan.smem_bytes == 4 * (2 * N * M + (N + 2) * (M + 2)
                                       + 6 * N * plan.chunk)
    else:
        assert plan.workspace_floats == B * (N + 2) * (M + 2)
        assert plan.smem_bytes == 24 * N * plan.chunk
        with pytest.raises(ValueError):
            TS.k2_plan(B, N, M, variant="shared")
    forced = TS.k2_plan(B, N, M, variant="global")
    assert forced.variant == "global"
    assert forced.workspace_floats == B * (N + 2) * (M + 2)


K3_PLAN_SHAPES = [s for s, _ in SDTW_SHAPES] + [
    (1, 1, 1), (2, 1, 7), (2, 7, 1), (5, 33, 47), (1, 19369, 128),
    (1, 19369, 19369)]


@pytest.mark.parametrize("B,N,M", K3_PLAN_SHAPES)
def test_k3_plan_covers_rows_and_fits(B, N, M):
    """K3's plan: warp w takes warp-rows w, w + warps, ... (32 rows each) in
    ``strips`` turns, which covers every row exactly once; its shared memory
    (counters, D rings [warps, 32, 66], the boundary rows [warps, M] where
    they fit) stays within a block's 227 KB, and it asks for a scratch only
    where the boundary rows do not fit on chip."""
    plan = TS.k3_plan(B, N, M)
    assert 1 <= plan.warps <= TS.K3_MAX_WARPS and plan.chunk == TS.K3_CHUNK
    seen = np.zeros(N, dtype=np.int64)
    for w in range(plan.warps):
        for g in range(plan.strips):
            k = w + g * plan.warps
            seen[32 * k:32 * k + 32] += 1
    assert (seen == 1).all()
    assert (plan.strips - 1) * plan.warps * 32 < N
    assert 0 < plan.smem_bytes <= TS.SMEM_LIMIT
    rings = 4 * (-(-plan.warps // 4) * 4 + plan.warps * 32 * TS.K3_STRIDE)
    on_chip = rings + 4 * plan.warps * M
    if on_chip <= TS.SMEM_LIMIT:
        assert plan.scratch_floats == 0 and plan.smem_bytes == on_chip
    else:
        assert plan.scratch_floats == B * plan.warps * M
        assert plan.smem_bytes == rings
    if (B, N, M) in [s for s, _ in SDTW_SHAPES]:  # the card's shapes
        assert plan.scratch_floats == 0


@pytest.mark.parametrize("B,N,M,warps", [(1, 0, 5, None), (1, 5, 0, None),
                                         (0, 5, 5, None), (1, 64, 64, 0),
                                         (1, 64, 64, 33),
                                         (1, 2 ** 16, 2 ** 15, None)])
def test_k3_plan_rejects(B, N, M, warps):
    """Empty shapes, warp counts outside 1-32 and N * M >= 2**31 (the
    kernel counts columns in int) raise."""
    with pytest.raises(ValueError):
        TS.k3_plan(B, N, M, warps)


@pytest.mark.parametrize("S,B,K,N,splits", [(2, 4, 1792, 4096, 2),
                                            (1, 4, 4096, 4096, 7),
                                            (2, 128, 1792, 4096, 2),
                                            (1, 128, 4096, 4096, 7),
                                            (2, 129, 1792, 4096, 2),
                                            (3, 9, 300, 130, 5),
                                            (1, 5, 37, 83, 1)])
def test_k1_plan_one_launch_no_workspace(S, B, K, N, splits):
    """One K1 call is one launch: K is cut into ranges of whole tiles that
    are none of them empty, whose partial sums meet inside one cluster (at
    most 8 blocks), all blocks in one wave; no workspace is asked for."""
    plan = TQ.k1_plan(S, B, K, N, x_bf16=True, sms=132)
    assert "workspace" not in " ".join(TQ.K1Plan._fields)
    assert plan.splits == splits and plan.splits in TQ.TC_SPLITS
    assert plan.k_per_split % TQ.TC_TILE_K == 0
    assert (plan.splits - 1) * plan.k_per_split < max(K, 1)
    assert plan.splits * plan.k_per_split >= K
    assert plan.bt >= min(B, 128) and plan.bt in (8, 16, 32, 64, 128)
    tiles = S * -(-N // TQ.TC_TILE_N) * -(-B // plan.bt)
    assert plan.blocks == tiles * plan.splits <= 2 * 132
    f32 = TQ.k1_plan(S, B, K, N, x_bf16=False, sms=132)
    assert 1 <= f32.splits <= TQ.MAX_CLUSTER
    assert (f32.splits - 1) * f32.k_per_split < max(K, 1)


def test_lib_path_covers_headers(tmp_path):
    """The built library's name hashes every source and header under
    csrc/: an edited .cuh beside a kernel's .cu rebuilds it."""
    from tacotron2_subword_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    name = _build.KERNELS[0]
    before = _build._lib_path(name, csrc)
    assert before == _build._lib_path(name, csrc)
    (csrc / "common.cuh").write_text("#pragma once\n")
    with_header = _build._lib_path(name, csrc)
    assert with_header != before
    (csrc / "common.cuh").write_text("#pragma once\n// edited\n")
    assert _build._lib_path(name, csrc) not in (before, with_header)
    assert _build._lib_path(name) == _build._lib_path(name, _build.CSRC_DIR)


# ---- the redesigned kernels on the card ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S,B,K,N", [(2, 128, 1792, 4096), (1, 128, 4096, 4096),
                                     (2, 129, 1792, 4096), (3, 9, 300, 130),
                                     (2, 3, 46, 80), (1, 5, 37, 83),
                                     (1, 1, 64, 128)])
def test_k1_bf16_tensor_cores_on_card(cuda_device, S, B, K, N):
    """K1's tensor-core kernel (bf16 x) at B=128/129 and at ragged K, N and
    B: within 2e-3 * max|ref| of the plain version (tensor-core sums round
    in another order), one launch per call, and two runs bit-equal."""
    x, w_q, scale = _inputs(S, B, K, N, torch.bfloat16, seed=3,
                            device=cuda_device)
    before = TQ.launches
    y = TQ.matmul_dequant_int8(x, w_q, scale)
    y_again = TQ.matmul_dequant_int8(x, w_q, scale)
    ref = TQ.matmul_dequant_int8_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert TQ.launches == before + 2
    assert torch.equal(y, y_again)
    assert (y - ref).abs().max() <= 2e-3 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["shared", "global"])
@pytest.mark.parametrize("shape,bw", [s for s in SDTW_SHAPES
                                      if s[0][1] <= 128])
def test_softdtw_grad_variants_on_card(cuda_device, variant, shape, bw):
    """K2's shared-memory and global variants both equal the plain version
    bit for bit (the same f32 operations in the same order, gamma = 1) and
    themselves across two runs; E is 0 outside the band."""
    B, N, M = shape
    g = torch.Generator(device=cuda_device).manual_seed(N * M)
    x = torch.randn((B, N, 8), generator=g, device=cuda_device)
    y = torch.randn((B, M, 8), generator=g, device=cuda_device)
    D = TS.euclidean_dist_matrix(x, y)
    v, E = TS.softdtw_grad(D, 1.0, bw, variant=variant)
    v_again, E_again = TS.softdtw_grad(D, 1.0, bw, variant=variant)
    pv, pE = TS.softdtw_grad_plain(D, 1.0, bw)
    torch.cuda.synchronize()
    assert torch.equal(v, v_again) and torch.equal(E, E_again)
    assert torch.equal(v, pv) and torch.equal(E, pE)
    banned = ~TS.band_mask(N, M, bw, cuda_device)
    assert (E[:, banned] == 0).all()


K3_CARD_SHAPES = [((3, 17, 15), 0.0, None), ((2, 20, 30), 12.0, None),
                  ((2, 24, 24), 5.0, None), ((2, 9, 9), 2.0, None),
                  ((5, 33, 47), 0.0, None), ((1, 1, 1), 0.0, None),
                  ((2, 1, 7), 0.0, None), ((2, 7, 1), 0.0, None),
                  ((8, 128, 128), 0.0, None), ((8, 256, 256), 0.0, None),
                  ((1, 1100, 900), 0.0, None), ((2, 100, 70), 0.0, 1),
                  ((2, 100, 70), 20.0, 2), ((1, 130, 5), 0.0, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [1.0, 0.7])
@pytest.mark.parametrize("shape,bw,warps", K3_CARD_SHAPES)
def test_k3_bit_equal_on_card(cuda_device, shape, bw, warps, gamma):
    """K3 (the register wavefront) against its plain version: bit-equal at
    gamma = 1 (the same f32 operations in the same order), within 1e-5 *
    max(1, |value|) at gamma = 0.7 (the kernel divides, the plain version
    too, but libm and the card's expf/logf may differ in the last bit);
    two runs bit-equal; one launch per call.  Forced warp counts run
    several strips at small N (the hand-off back to warp 0)."""
    B, N, M = shape
    g = torch.Generator(device=cuda_device).manual_seed(7 * N + M)
    x = torch.randn((B, N, 8), generator=g, device=cuda_device)
    y = torch.randn((B, M, 8), generator=g, device=cuda_device)
    D = TS.euclidean_dist_matrix(x, y)
    before = TS.fwd_launches
    v = TS.softdtw_value(D, gamma, bw, warps=warps)
    v_again = TS.softdtw_value(D, gamma, bw, warps=warps)
    pv = TS.softdtw_value_plain(D, gamma, bw)
    torch.cuda.synchronize()
    assert TS.fwd_launches == before + 2
    assert torch.equal(v, v_again)
    if gamma == 1.0:
        assert torch.equal(v, pv)
    else:
        assert ((v - pv).abs() <= 1e-5 * pv.abs().clamp_min(1.0)).all()
    plan = TS.k3_plan(B, N, M, warps)
    lib = TS._lib()
    assert lib.t2s_softdtw_fwd_smem_bytes(
        M, plan.warps, int(plan.scratch_floats == 0)) == plan.smem_bytes


# ---- K4, the channels-last convolutions' epilogue -------------------------

# each mode: the epilogue's arguments (by which operands it reads and
# writes) and the generator path's own ops on the same tensors
EPI_MODES = {
    "bias": (dict(out_pre="new"), lambda y, b, r, s: (y + b, None)),
    "lrelu-in-place": (dict(out_act="y"),
                       lambda y, b, r, s: (None, F.leaky_relu(y + b, 0.1))),
    "residual": (dict(residual=True, out_pre="y", out_act="new"),
                 lambda y, b, r, s: ((y + b) + r,
                                     F.leaky_relu((y + b) + r, 0.1))),
    "mrf-add": (dict(residual=True, mrf_sum=True, out_pre="mrf_sum"),
                lambda y, b, r, s: (s + ((y + b) + r), None)),
    "mrf-average": (dict(residual=True, mrf_sum=True, mrf_div=3,
                         out_act="y"),
                    lambda y, b, r, s: (None, F.leaky_relu(
                        (s + ((y + b) + r)) / 3, 0.1))),
    "mrf-average-0.01": (dict(residual=True, mrf_sum=True, mrf_div=3,
                              out_act="new", slope=0.01),
                         lambda y, b, r, s: (None, F.leaky_relu(
                             (s + ((y + b) + r)) / 3, 0.01))),
    "average-of-one": (dict(residual=True, mrf_div=1, out_act="y"),
                       lambda y, b, r, s: (None, F.leaky_relu(
                           ((y + b) + r) / 1, 0.1))),
    "tanh": (dict(out_act="y", act="tanh"),
             lambda y, b, r, s: (None, torch.tanh(y + b))),
}


def _epi_run(fn, mode, R, C, device, offset=0, bias_offset=0, seed=0,
             dtype=torch.float32):
    """Run ``fn`` (the wrapper or the plain version) in ``mode`` on fresh
    seeded [R, C] inputs (``offset`` floats into their buffers, to take
    the 4-byte path; the bias ``bias_offset`` floats into its own, as a
    served generator's leaves lie in one buffer); returns (out_pre,
    out_act, the generator's ops)."""
    kw, ops = EPI_MODES[mode]
    g = torch.Generator().manual_seed(seed)

    def rows():
        buf = torch.randn(R * C + offset, generator=g) * 3
        return buf.to(device, dtype)[offset:].view(R, C)
    y, r, s = rows(), rows(), rows()
    b = (torch.randn(C + bias_offset, generator=g) * 0.5).to(
        device, dtype)[bias_offset:]
    ref = ops(y.clone(), b, r, s.clone())
    where = {None: None, "y": y, "mrf_sum": s}
    pre, act = (torch.empty_like(y) if kw.get(k) == "new"
                else where[kw.get(k)] for k in ("out_pre", "out_act"))
    fn(y, b, residual=r if kw.get("residual") else None,
       mrf_sum=s if kw.get("mrf_sum") else None,
       mrf_div=kw.get("mrf_div", 0), out_pre=pre, out_act=act,
       act=kw.get("act", "lrelu"), slope=kw.get("slope", 0.1))
    return pre, act, ref


EPI_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", EPI_DTYPES)
@pytest.mark.parametrize("mode", list(EPI_MODES))
def test_epilogue_plain_is_the_generators_ops(mode, dtype):
    """The plain version (what the wrapper runs on the CPU) is the
    generator path's ops, bit for bit, in place where its outputs alias
    its inputs."""
    pre, act, (ref_pre, ref_act) = _epi_run(TE.conv_epilogue, mode, 37, 12,
                                            "cpu", dtype=dtype)
    for got, ref in ((pre, ref_pre), (act, ref_act)):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert torch.equal(got, ref)


@pytest.mark.parametrize("bad", ["act", "no_output", "rows", "bias",
                                 "dtype", "mixed_dtypes", "div"])
def test_epilogue_rejects_bad_arguments(bad):
    y, b = torch.zeros(6, 4), torch.zeros(4)
    kw = dict(out_act=torch.empty(6, 4))
    if bad == "act":
        kw["act"] = "relu"
    elif bad == "no_output":
        kw = {}
    elif bad == "rows":
        kw["residual"] = torch.zeros(5, 4)
    elif bad == "bias":
        b = torch.zeros(3)
    elif bad == "dtype":
        y, b = y.double(), b.double()
    elif bad == "mixed_dtypes":
        b = b.bfloat16()
    else:
        kw["mrf_div"] = -1
    with pytest.raises((TypeError, ValueError)):
        TE.conv_epilogue(y, b, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", EPI_DTYPES + [torch.float16])
@pytest.mark.parametrize("mode", list(EPI_MODES))
@pytest.mark.parametrize("R,C,offset,bias_offset", [
    (4096, 32, 0, 0), (1000, 256, 0, 3), (999, 13, 0, 0), (7, 1, 0, 0),
    (333, 12, 1, 0), (1, 5, 0, 0)])
def test_epilogue_bit_equal_on_card(cuda_device, mode, R, C, offset,
                                    bias_offset, dtype):
    """K4 against its plain version in every mode and dtype, at 4-channel
    (C % 4 == 0, rows aligned, the bias aligned or not) and 1-channel
    (ragged C, or misaligned rows) accesses: bit-equal, since both make
    the same f32 operations in the same order and round each to the dtype;
    one launch per call."""
    before = TE.launches
    got = _epi_run(TE.conv_epilogue, mode, R, C, cuda_device, offset,
                   bias_offset, dtype=dtype)
    want = _epi_run(TE.conv_epilogue_plain, mode, R, C, cuda_device, offset,
                    bias_offset, dtype=dtype)
    torch.cuda.synchronize()
    assert TE.launches == before + 1
    for a, b in zip(got[:2], want[:2]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    for a, b in zip(got[:2], got[2]):  # and the generator path's own ops
        if a is not None:
            assert torch.equal(a, b)


def _default_scale_generator(h, seed, device):
    """A fused generator with every weight and bias U(+-1/sqrt(fan_in)),
    torch's default scale and the benchmark's."""
    g = torch.Generator().manual_seed(seed)
    tree = HG.fuse_generator(HG.init_generator(g, h, device="cpu"))

    def draw(p):
        bound = 1.0 / math.sqrt(p["w"].shape[1] * p["w"].shape[2])
        u = lambda t: ((torch.rand(t.shape, generator=g) * 2 - 1)
                       * bound).to(device)
        return {"w": u(p["w"]), "b": u(p["b"])}
    return {"conv_pre": draw(tree["conv_pre"]),
            "conv_post": draw(tree["conv_post"]),
            "ups": [draw(p) for p in tree["ups"]],
            "resblocks": [{k: [draw(c) for c in v] for k, v in rb.items()}
                          for rb in tree["resblocks"]]}


HIFIGAN_WIDTHS = {"v1": HG.HifiganConfig(),
                  "v2": HG.HifiganConfig(upsample_initial_channel=128)}


@pytest.mark.cuda
@pytest.mark.parametrize("version", list(HIFIGAN_WIDTHS))
def test_generator_channels_last_on_card(cuda_device, version):
    """The channels-last path (K4 after every convolution) against the
    generator's own path (autograd on; no parameter asks for a gradient)
    at V1's and V2's published widths and a served group's shape, 32 rows
    x 880 frames; ``generator_apply`` with autograd off takes the
    channels-last path whatever cuDNN's TF32 switch reads.  With TF32 off
    both are f32 and differ only in the order of the convolutions' sums:
    max|d| <= 1e-5 * max|ref|.  With TF32 on, as served, the benchmark's
    wav_gap between them must stay under the sma cell's limit (7e-5 of
    full scale).  The channels-last call's trace holds K4, and
    cuDNN's layout transposes no longer wrap the convolutions: the
    generator path makes two or more a convolution (176 at V1's widths),
    this one at most one for ten convolutions (where cuDNN's heuristics
    still pick an NCHW-output kernel for a shape)."""
    from tacotron2_subword_tpu_torch.apps.inference import MAX_WAV_VALUE
    h = HIFIGAN_WIDTHS[version]
    params = _default_scale_generator(h, seed=12, device=cuda_device)
    mel = (torch.randn((32, 80, 880), generator=torch.Generator()
                       .manual_seed(13)) * 2.0 - 5.0).to(cuda_device)
    n_convs = 2 + len(h.upsample_rates) * (1 + 2 * sum(
        len(d) for d in h.resblock_dilation_sizes))
    tf32 = torch.backends.cudnn.allow_tf32
    gaps = {}
    try:
        for allow in (False, True):
            torch.backends.cudnn.allow_tf32 = allow
            with torch.enable_grad():
                ref = HG.generator_apply(params, h, mel)
            before = TE.launches
            with torch.inference_mode():
                got = HG.generator_apply(params, h, mel)
            torch.cuda.synchronize()
            assert TE.launches == before + n_convs
            assert got.shape == ref.shape and got.is_contiguous()
            d = (got - ref).double()
            rms = d.reshape(32, -1, 256).pow(2).mean(-1).sqrt().max().item()
            gaps[allow] = (d.abs().max().item() / ref.abs().max().item(),
                           rms * MAX_WAV_VALUE / 32768.0)
            del ref, got, d
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            HG.generator_apply(params, h, mel)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    transposes = sum(c for n, c in counts.items()
                     if "nchwToNhwc" in n or "nhwcToNchw" in n)
    print(f"{version}: channels-last vs generator path, max|d| / max|ref| "
          f"and wav_gap: TF32 off {gaps[False]}, TF32 on {gaps[True]}; "
          f"{transposes} cuDNN layout transposes in {n_convs} convolutions")
    assert gaps[False][0] <= 1e-5
    assert gaps[True][1] <= 7e-5
    assert sum(c for n, c in counts.items()
               if "conv_epilogue_kernel" in n) == n_convs
    assert transposes <= n_convs // 10


@pytest.mark.cuda
def test_generator_channels_last_bf16_on_card(cuda_device):
    """The channels-last path in bf16 (weights and mel, as ``bench.
    run_vocoders`` serves it) against the generator path in bf16 at V1's
    widths, 4 rows x 256 frames: both round every op to bf16, in other
    places inside the convolutions, so max|d| <= 0.05 * max|ref| (a few
    bf16 steps at full scale): a wrong layout or order reads O(1)."""
    from tacotron2_subword_tpu_torch.utils.tree import cast_floats
    h = HIFIGAN_WIDTHS["v1"]
    params = cast_floats(_default_scale_generator(h, seed=14,
                                                  device=cuda_device),
                         torch.bfloat16)
    mel = (torch.randn((4, 80, 256), generator=torch.Generator()
                       .manual_seed(15)) * 2.0 - 5.0).to(cuda_device,
                                                         torch.bfloat16)
    with torch.enable_grad():
        ref = HG.generator_apply(params, h, mel)
    with torch.inference_mode():
        got = HG.generator_apply(params, h, mel)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.bfloat16
    gap = ((got.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    print(f"v1 bf16: channels-last vs generator path, max|d| / max|ref| "
          f"{gap}")
    assert gap <= 0.05
