"""The port's kernels against their plain versions.  Imports no JAX, so it
also runs on a machine with a card and without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The tests marked ``cuda`` build and launch the CUDA kernels and skip where
there is no CUDA device."""

import shutil

import numpy as np
import pytest
import torch

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
