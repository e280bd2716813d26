"""Kernels K1-K5, P1, P2, S1 and R1 against their plain PyTorch versions on
the GPU, the PyTorch-op paths (padded-CSR BP, damped and tanh rounds, the
calibration histogram) against themselves on the CPU, and the multi-code
and shot-mesh paths on the card (K1 and K2 at the multi-code shapes),
BatchDecoder and the code-capacity round on the card against the CPU.

Needs a CUDA card and nvcc (the kernels are built from qldpc_tpu_torch/csrc
on first use); every test skips without a card. Imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:
``python -m pytest tests/test_torch_cuda.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import (bp, bp_lift_cuda, bp_lift_layered_cuda,
                                 calibrate, gather, osd_cuda, sampler)
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.osd import _gather_pack, _pack_columns
from qldpc_tpu_torch.ops.sampler import trial_batch
from qldpc_tpu_torch.parallel import engine, mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bundles(cuda):
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=6)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    seq = alpha_schedule("dynamical", 50)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = [engine._make_basis(circ, M, b, seq, osd_order=2,
                                            device=dev) for b in "ZX"]
    return circ, M, out


def _syndromes(M, basis, B, seed):
    H = (M[f"Hdec{basis}"] != 0).astype(np.uint8)
    rng = np.random.default_rng(seed)
    errs = (rng.random((B, H.shape[1])) < M[f"channel_probs{basis}"])
    return H, ((errs.astype(np.int8) @ H.T) % 2).astype(np.int8)


@pytest.mark.parametrize("B", [256, 37, 1])
@pytest.mark.parametrize("basis", ["Z", "X"])
def test_bp_kernel_matches_plain(cuda, bundles, basis, B):
    """K1 against its plain version on every output, at a batch that is not
    a multiple of the shots an SM holds (37) and at one shot; the larger
    batches hold converged and unconverged shots side by side."""
    circ, M, decs = bundles
    dec = decs[str(cuda)]["ZX".index(basis)]
    _, syn = _syndromes(M, basis, B, 1)
    syn = torch.as_tensor(syn, device=cuda)
    before = bp_lift_cuda.decode_batch_lift_cuda.launches
    a = bp_lift_cuda.decode_batch_lift_cuda(dec.lifted, syn, dec.prior,
                                            dec.alpha_seq, 50)
    torch.cuda.synchronize()
    assert bp_lift_cuda.decode_batch_lift_cuda.launches == before + 1
    b = bp_lift_cuda.decode_batch_lift_plain(dec.lifted, syn, dec.prior,
                                             dec.alpha_seq, 50)
    for k in ("hard", "converged", "iterations", "values"):
        assert torch.equal(a[k], b[k]), k
    if B > 1:
        assert a["converged"].any() and not a["converged"].all()


def test_bp_kernel_device_memory_branch(cuda, bundles, monkeypatch):
    """K1 with its per-shot state in device memory (the branch a graph
    larger than a block's shared memory takes) equals the plain version."""
    circ, M, decs = bundles
    dec = decs[str(cuda)][0]
    _, syn = _syndromes(M, "Z", 37, 2)
    syn = torch.as_tensor(syn, device=cuda)
    monkeypatch.setattr(bp_lift_cuda, "_SMEM_LIMIT", 0)
    a = bp_lift_cuda.decode_batch_lift_cuda(dec.lifted, syn, dec.prior,
                                            dec.alpha_seq, 50)
    torch.cuda.synchronize()
    b = bp_lift_cuda.decode_batch_lift_plain(dec.lifted, syn, dec.prior,
                                             dec.alpha_seq, 50)
    for k in ("hard", "converged", "iterations", "values"):
        assert torch.equal(a[k], b[k]), k


def test_bp_kernel_launch_info(cuda, bundles):
    """K1's shape: no spills, and the shots an SM holds at [[72]]."""
    circ, M, decs = bundles
    info = bp_lift_cuda.flood_launch_info(decs[str(cuda)][0].lifted, cuda)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2
    assert info["state_in"] == "shared memory"


@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("full_jordan", [False, True])
def test_elim_kernel_matches_plain(cuda, bundles, exit_on_valid,
                                   full_jordan):
    circ, M, decs = bundles
    dec = decs[str(cuda)][0]
    H, syn = _syndromes(M, "Z", 64, 2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    llr = torch.randn((64, H.shape[1]), generator=gen, device=cuda)
    cols = torch.sort(llr.abs(), dim=1, stable=True).indices[:, :dec.K]
    Hp = _gather_pack(dec.H.T.contiguous(), cols, dec.K, words_major=True)
    s = torch.as_tensor(syn, device=cuda).to(torch.int32)
    before = osd_cuda.eliminate_blocks_v1.launches
    a = osd_cuda.eliminate_blocks_v1(_columns(Hp), s, dec.K, H.shape[0],
                                     rank=dec.rank, full_jordan=full_jordan,
                                     exit_on_valid=exit_on_valid,
                                     return_steps=True)
    torch.cuda.synchronize()
    assert osd_cuda.eliminate_blocks_v1.launches == before + 1
    b = osd_cuda.eliminate_blocks_plain(Hp, s, dec.K, H.shape[0],
                                        rank=dec.rank,
                                        full_jordan=full_jordan,
                                        exit_on_valid=exit_on_valid,
                                        return_steps=True)
    for name, x, y in zip(("Hp", "s", "prow", "used", "colofrow", "steps"),
                          a, b):
        assert torch.equal(x, y), name


def _elim_case(cuda, bundles, B, seed, K):
    """B [[72]] basis-Z shots packed at K columns of a random order."""
    circ, M, decs = bundles
    dec = decs[str(cuda)][0]
    H, syn = _syndromes(M, "Z", B, seed)
    rng = np.random.default_rng(seed)
    cols = torch.as_tensor(np.stack([rng.permutation(H.shape[1])
                                     for _ in range(B)]), device=cuda)
    Hp = _gather_pack(dec.H.T.contiguous(), cols[:, :K], K, words_major=True)
    s = torch.as_tensor(syn, device=cuda).to(torch.int32)
    return dec, Hp, s


def _columns(Hp):
    """G1's column layout, which the eliminators take, of words-major Hp
    (B, W, M) (the plain bit transpose, at the kernels' stride)."""
    _, W, M = Hp.shape
    return osd_cuda.words_to_columns(Hp, osd_cuda.column_stride(W, M,
                                                                Hp.device))


def _elim_equal(a, b):
    for name, x, y in zip(("Hp", "s", "prow", "used", "colofrow", "steps"),
                          a, b):
        assert torch.equal(x, y), name


# each eliminator's wrapper and the plain version it must equal
_ELIM = {"K2": (osd_cuda.eliminate_blocks_v1, osd_cuda.eliminate_blocks_plain),
         "K4": (osd_cuda.eliminate_blocks_fused,
                osd_cuda.eliminate_blocks_fused_plain),
         "K5": (osd_cuda.eliminate_blocks_pair,
                osd_cuda.eliminate_blocks_plain)}


def _elim_against_plain(kernel, Hp, s, K, m, **kw):
    """``kernel`` on words-major Hp's column layout against its plain
    version on Hp, every output; returns the kernel's outputs."""
    fn, plain = _ELIM[kernel]
    before = fn.launches
    a = fn(_columns(Hp), s, K, m, return_steps=True, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _elim_equal(a, plain(Hp, s, K, m, return_steps=True, **kw))
    return a


def _batches(cuda, bundles, kernel, B, exit_on_valid):
    dec, Hp, s = _elim_case(cuda, bundles, B, 7, 512)
    _elim_against_plain(kernel, Hp, s, 512, Hp.shape[2], rank=dec.rank,
                        exit_on_valid=exit_on_valid)


def _shots_exit_apart(cuda, bundles, kernel):
    dec, Hp, s = _elim_case(cuda, bundles, 48, 8, 512)
    rng = np.random.default_rng(8)
    s[::3] = 0
    s[1::3] = torch.as_tensor(rng.integers(0, 2, s[1::3].shape),
                              device=cuda, dtype=torch.int32)
    a = _elim_against_plain(kernel, Hp, s, 512, Hp.shape[2], rank=dec.rank)
    assert a[5].min() == 0 and a[5].max() >= dec.rank


def _ragged_rows_past_m(cuda, bundles, kernel, exit_on_valid):
    dec, Hp, s = _elim_case(cuda, bundles, 40, 9, 256)
    m = Hp.shape[2]
    gen = torch.Generator(device=cuda).manual_seed(9)
    Hp = torch.cat([Hp, torch.randint(-2**31, 2**31 - 1, (40, 8, 45),
                                      generator=gen, device=cuda,
                                      dtype=torch.int32)], 2)
    s = torch.cat([s, torch.randint(0, 2, (40, 45), generator=gen,
                                    device=cuda, dtype=torch.int32)], 1)
    _elim_against_plain(kernel, Hp, s, 256, m, rank=dec.rank,
                        exit_on_valid=exit_on_valid)


def _device_memory_branch(cuda, bundles, monkeypatch, kernel, full_jordan):
    dec, Hp, s = _elim_case(cuda, bundles, 37, 10, 256)
    kw = dict(rank=dec.rank, full_jordan=full_jordan)
    m = Hp.shape[2]
    a = _elim_against_plain(kernel, Hp, s, 256, m, **kw)
    info = osd_cuda.elim_launch_info(37, 8, m, cuda, kernel)
    monkeypatch.setattr(osd_cuda, "_SMEM_LIMIT", 0)
    d = _elim_against_plain(kernel, Hp, s, 256, m, **kw)
    assert info["columns_in"] == "shared memory"
    assert osd_cuda.elim_launch_info(37, 8, m, cuda, kernel)["columns_in"] \
        == "device memory"
    _elim_equal(d, a)


def _three_words_a_lane(cuda, kernel, exit_on_valid):
    rng = np.random.default_rng(12)
    B, W, M, m = 9, 32, 2100, 2090
    bits = rng.random((B, 32 * W, M)) < 0.004
    words = (bits.reshape(B, W, 32, M).astype(np.int64)
             << np.arange(32)[None, None, :, None]).sum(2)
    Hp = torch.as_tensor(np.where(words >= 2**31, words - 2**32, words),
                         dtype=torch.int32, device=cuda)
    s = torch.as_tensor(rng.integers(0, 2, (B, M)), dtype=torch.int32,
                        device=cuda)
    info = osd_cuda.elim_launch_info(B, W, M, cuda, kernel)
    assert info["words_per_lane"] == 3 and info["local_bytes"] == 0
    assert info["columns_in"] == "device memory"
    _elim_against_plain(kernel, Hp, s, 32 * W, m,
                        exit_on_valid=exit_on_valid)


@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("B", [1, 37])
def test_elim_kernel_batches(cuda, bundles, B, exit_on_valid):
    """One shot, and a batch that is no multiple of the shots a block
    holds, at the prefix width."""
    _batches(cuda, bundles, "K2", B, exit_on_valid)


def test_elim_kernel_shots_exit_apart(cuda, bundles):
    """Shots of one block stop at very different steps: zero residuals at
    step 0, syndromes of sampled errors early, random syndromes (mostly
    outside the column span) only at the rank or the last column."""
    _shots_exit_apart(cuda, bundles, "K2")


@pytest.mark.parametrize("exit_on_valid", [False, True])
def test_elim_kernel_ragged_rows_past_m(cuda, bundles, exit_on_valid):
    """M = m + 45 rows (no whole number of words): the rows past m carry
    bits and residuals, are XORed and never pivot."""
    _ragged_rows_past_m(cuda, bundles, "K2", exit_on_valid)


@pytest.mark.parametrize("full_jordan", [False, True])
def test_elim_kernel_device_memory_branch(cuda, bundles, monkeypatch,
                                          full_jordan):
    """The columns in a device-memory slab (the branch wider matrices take)
    give the shared-memory launch's outputs bit for bit, at stage-1 width."""
    _device_memory_branch(cuda, bundles, monkeypatch, "K2", full_jordan)


@pytest.mark.parametrize("exit_on_valid", [False, True])
def test_elim_kernel_three_words_a_lane(cuda, exit_on_valid):
    """2100 rows: each lane holds 3 row words of a column (as at
    [[288,12,18]]), on the device-memory branch at 32 words."""
    _three_words_a_lane(cuda, "K2", exit_on_valid)


def test_elim_kernel_launch_info(cuda):
    """K2's shape at [[144]]'s stage-1 width: no spills, one word a lane,
    several shots per SM in shared memory."""
    info = osd_cuda.elim_launch_info(481, 8, 1008, cuda)
    assert info["local_bytes"] == 0 and info["words_per_lane"] == 1
    assert info["columns_in"] == "shared memory"
    assert info["shots_per_sm"] >= 4 and info["shots_per_block"] >= 2


_BUILT = {}


def _built(name: str, cycles: int, p: float):
    """(circuit, decoding matrices) of a code, built once a module."""
    key = (name, cycles, p)
    if key not in _BUILT:
        code = qt.get_code(name)
        circ = qt.SyndromeCircuit(code, num_cycles=cycles)
        _BUILT[key] = circ, qt.build_decoding_matrices(circ, code.Lx,
                                                       code.Lz, p)
    return _BUILT[key]


@pytest.fixture(scope="module")
def basis_rerun_288(cuda):
    """[[288,12,18]] basis Z at p=0.005 (18 cycles): B=37 syndromes of
    sampled errors, packed at the width of osd_batch's basis rerun (the
    3,584 reliability-ordered columns with the column basis appended), and
    the decoder's rank."""
    from qldpc_tpu_torch.models import gf2
    from qldpc_tpu_torch.ops.osd import choose_K
    circ, M = _built("[[288, 12, 18]]", 18, 0.005)
    H = (M["HdecZ"] != 0).astype(np.uint8)
    m, n = H.shape
    rng = np.random.default_rng(14)
    errs = rng.random((37, n)) < M["channel_probsZ"]
    Ht = torch.as_tensor(H, device=cuda)
    s = ((torch.as_tensor(errs, dtype=torch.float32, device=cuda)
          @ Ht.T.float()) % 2).to(torch.int32)
    prior = torch.as_tensor(qt.channel_llrs(M["channel_probsZ"]),
                            dtype=torch.float32, device=cuda)
    noise = torch.as_tensor(rng.standard_normal((37, n)),
                            dtype=torch.float32, device=cuda)
    cols = torch.sort((prior * (1 + 0.1 * noise)).abs(), dim=1,
                      stable=True).indices
    K = choose_K(m, n)
    basis = gf2.column_basis(H)
    R = len(basis)
    Hb = torch.zeros((m, -(-R // 32) * 32), dtype=torch.uint8, device=cuda)
    Hb[:, :R] = Ht[:, torch.as_tensor(basis, device=cuda)]
    HbT = _pack_columns(Hb).T.contiguous()
    Hp = torch.cat([_gather_pack(Ht.T.contiguous(), cols[:, :K], K,
                                 words_major=True),
                    HbT[None].expand(37, *HbT.shape)], 1)
    return Hp, s, K + R, m, gf2.rank_fast(H)


@pytest.mark.parametrize("exit_on_valid", [False, True])
def test_elim_kernel_at_288_basis_rerun(cuda, basis_rerun_288, exit_on_valid):
    """K2 at [[288,12,18]]'s basis-rerun width (prefix plus basis, three
    row words a lane, columns in device memory) equals its plain version
    on every output."""
    Hp, s, Kw, m, rank = basis_rerun_288
    assert Hp.shape[1] * 32 >= Kw > 3584
    info = osd_cuda.elim_launch_info(*Hp.shape, cuda)
    assert info["words_per_lane"] == 3 and info["local_bytes"] == 0
    assert info["columns_in"] == "device memory"
    _elim_against_plain("K2", Hp, s, Kw, m, rank=rank,
                        exit_on_valid=exit_on_valid)


# K4 and K5 on K2's cases: batches (odd ones leave K5's last team one
# shot), shots exiting apart (hundreds of columns within a K5 pair), ragged
# rows past m, the device-memory branch, three row words a lane
@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_alt_elim_kernel_batches(cuda, bundles, kernel, B, exit_on_valid):
    _batches(cuda, bundles, kernel, B, exit_on_valid)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_alt_elim_kernel_shots_exit_apart(cuda, bundles, kernel):
    _shots_exit_apart(cuda, bundles, kernel)


@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_alt_elim_kernel_ragged_rows_past_m(cuda, bundles, kernel,
                                            exit_on_valid):
    _ragged_rows_past_m(cuda, bundles, kernel, exit_on_valid)


@pytest.mark.parametrize("full_jordan", [False, True])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_alt_elim_kernel_device_memory_branch(cuda, bundles, monkeypatch,
                                              kernel, full_jordan):
    _device_memory_branch(cuda, bundles, monkeypatch, kernel, full_jordan)


@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_alt_elim_kernel_three_words_a_lane(cuda, kernel, exit_on_valid):
    _three_words_a_lane(cuda, kernel, exit_on_valid)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_alt_elim_kernel_launch_info(cuda, kernel):
    """K4's and K5's shape at [[144]]'s stage-1 width: no spills, one word
    a lane, shared memory, K5 two shots a team."""
    info = osd_cuda.elim_launch_info(481, 8, 1008, cuda, kernel)
    assert info["local_bytes"] == 0 and info["words_per_lane"] == 1
    assert info["columns_in"] == "shared memory"
    assert info["shots_per_team"] == (2 if kernel == "K5" else 1)
    assert info["shots_per_sm"] >= 4


def test_pooled_round_gpu_matches_cpu(cuda, bundles):
    """The same randoms through the kernels on the card and the plain
    versions on the CPU give identical per-shot flags."""
    circ, M, decs = bundles
    gen = torch.Generator(device=cuda).manual_seed(5)
    from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
    randoms = [sample_gate_randoms(gen, 128, circ.num_error_locs, 0.006)
               for _ in range(2)]
    outs = {}
    for dev in ("cpu", str(cuda)):
        dz, dx = decs[dev]
        fn = engine.make_pooled_round_fn(dz, dx, circ.num_error_locs, 0.006,
                                         128, 50, 2, 2)
        outs[dev] = fn(None, randoms=[tuple(x.to(dev) for x in r)
                                      for r in randoms])
    for k, v in outs["cpu"].items():
        assert torch.equal(v, outs[str(cuda)][k].cpu()), k


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_layered_kernel_matches_plain(cuda, bundles, basis):
    circ, M, decs = bundles
    dec = decs[str(cuda)]["ZX".index(basis)]
    _, syn = _syndromes(M, basis, 256, 3)
    syn = torch.as_tensor(syn, device=cuda)
    fn = bp_lift_layered_cuda.decode_batch_lift_layered_cuda
    before = fn.launches
    a = fn(dec.lifted, syn, dec.prior, dec.alpha_seq, 50)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    b = bp_lift_layered_cuda.decode_batch_lift_layered_plain(
        dec.lifted, syn, dec.prior, dec.alpha_seq, 50)
    for k in ("hard", "converged", "iterations", "values"):
        assert torch.equal(a[k], b[k]), k
    assert a["converged"].any() and not a["converged"].all()


def test_layered_kernel_device_memory_branch(cuda, bundles, monkeypatch):
    """K3 with its per-shot state in device memory (the branch a graph
    larger than a block's shared memory takes) equals the plain version."""
    circ, M, decs = bundles
    dec = decs[str(cuda)][0]
    _, syn = _syndromes(M, "Z", 37, 2)
    syn = torch.as_tensor(syn, device=cuda)
    monkeypatch.setattr(bp_lift_cuda, "_SMEM_LIMIT", 0)
    a = bp_lift_layered_cuda.decode_batch_lift_layered_cuda(
        dec.lifted, syn, dec.prior, dec.alpha_seq, 50)
    torch.cuda.synchronize()
    b = bp_lift_layered_cuda.decode_batch_lift_layered_plain(
        dec.lifted, syn, dec.prior, dec.alpha_seq, 50)
    for k in ("hard", "converged", "iterations", "values"):
        assert torch.equal(a[k], b[k]), k


def test_layered_kernel_launch_info(cuda, bundles):
    """K3's shape: no spills, state in shared memory, and at least two shots
    an SM at [[72]]."""
    circ, M, decs = bundles
    info = bp_lift_layered_cuda.layered_launch_info(
        decs[str(cuda)][0].lifted, cuda)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2
    assert info["state_in"] == "shared memory"


@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("full_jordan", [False, True])
@pytest.mark.parametrize("kernel", ["fused", "pair"])
def test_alternative_elim_kernels_match_plain(cuda, bundles, kernel,
                                              exit_on_valid, full_jordan):
    """K4 against its plain version, K5 against K2's, every output; an odd
    batch leaves K5's last block one shot."""
    circ, M, decs = bundles
    dec = decs[str(cuda)][0]
    H, syn = _syndromes(M, "Z", 63, 4)
    gen = torch.Generator(device=cuda).manual_seed(1)
    llr = torch.randn((63, H.shape[1]), generator=gen, device=cuda)
    cols = torch.sort(llr.abs(), dim=1, stable=True).indices[:, :dec.K]
    Hp = _gather_pack(dec.H.T.contiguous(), cols, dec.K, words_major=True)
    s = torch.as_tensor(syn, device=cuda).to(torch.int32)
    fn, plain = {
        "fused": (osd_cuda.eliminate_blocks_fused,
                  osd_cuda.eliminate_blocks_fused_plain),
        "pair": (osd_cuda.eliminate_blocks_pair,
                 osd_cuda.eliminate_blocks_plain)}[kernel]
    kw = dict(rank=dec.rank, full_jordan=full_jordan,
              exit_on_valid=exit_on_valid, return_steps=True)
    before = fn.launches
    a = fn(_columns(Hp), s, dec.K, H.shape[0], **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    b = plain(Hp, s, dec.K, H.shape[0], **kw)
    for name, x, y in zip(("Hp", "s", "prow", "used", "colofrow", "steps"),
                          a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("bp_variant, version", [
    ("layered", 1), ("minsum", 2), ("minsum", 3)])
def test_pooled_round_variants_gpu_matches_cpu(cuda, bundles, monkeypatch,
                                               bp_variant, version):
    """The layered path (K3) and the eliminator generations (K4, K5) give
    the CPU plain versions' flags on the same randoms."""
    circ, M, decs = bundles
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", version)
    gen = torch.Generator(device=cuda).manual_seed(6)
    from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
    randoms = [sample_gate_randoms(gen, 128, circ.num_error_locs, 0.006)
               for _ in range(2)]
    outs = {}
    for dev in ("cpu", str(cuda)):
        dz, dx = decs[dev]
        fn = engine.make_pooled_round_fn(dz, dx, circ.num_error_locs, 0.006,
                                         128, 50, 2, 2, bp_variant=bp_variant)
        outs[dev] = fn(None, randoms=[tuple(x.to(dev) for x in r)
                                      for r in randoms])
    for k, v in outs["cpu"].items():
        assert torch.equal(v, outs[str(cuda)][k].cpu()), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, lanes", [
    (1024, 128), (35280, 128), (8192, 512), (1000, 400), (37, 5),
    (35280, 130), (1000, 13)])
def test_gather_iter_kernel_matches_plain(cuda, dtype, rows, lanes):
    """P1 with indices that differ per lane, blocks of one and of several
    lanes, a ragged last block and a ragged last cluster (130 lanes), and
    row strides off a 16-byte boundary (5 and 13 lanes): the tile exact,
    the sums within the summation-order tolerance."""
    rng = np.random.default_rng(rows + lanes)
    x = torch.as_tensor(rng.standard_normal((rows, lanes)),
                        device=cuda).to(dtype)
    idx = torch.as_tensor(rng.integers(0, rows, (rows, lanes)),
                          dtype=torch.int32, device=cuda)
    before = gather.gather_iterate.launches
    total, tile = gather.gather_iterate(x, idx, 30)
    torch.cuda.synchronize()
    assert gather.gather_iterate.launches == before + 1
    p_total, p_tile = gather.gather_iterate_plain(x, idx, 30)
    assert torch.equal(tile, p_tile)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    assert total.dtype == dtype and total.shape == (1, lanes)
    assert torch.allclose(total.float(), p_total.float(), rtol=rtol, atol=0)


@pytest.mark.parametrize("iters", [0, 1])
def test_gather_iter_kernel_zero_and_one_round(cuda, iters):
    """P1 in bfloat16 at 35,280 rows with no round (the cluster's load and
    store alone) and with one."""
    rng = np.random.default_rng(iters)
    x = torch.as_tensor(rng.standard_normal((35280, 128)),
                        device=cuda).to(torch.bfloat16)
    idx = torch.as_tensor(rng.integers(0, 35280, (35280, 128)),
                          dtype=torch.int32, device=cuda)
    total, tile = gather.gather_iterate(x, idx, iters)
    torch.cuda.synchronize()
    p_total, p_tile = gather.gather_iterate_plain(x, idx, iters)
    assert torch.equal(tile, p_tile)
    assert torch.allclose(total.float(), p_total.float(), rtol=1e-2, atol=0)


def test_gather_iter_launch_uses_a_cluster(cuda):
    """[[144]]'s edge-slot grid launches in clusters, each block one lane
    column on 512 threads, 72 elements a thread, without spills, and all
    its clusters on the card at once (one wave)."""
    for dtype in (torch.float32, torch.bfloat16):
        info = gather.launch_info(35280, 128, dtype, cuda)
        assert (info["lanes"], info["threads"], info["stage"]) == (1, 512, 72)
        assert info["cluster"] >= 2 and info["blocks"] == 128
        assert info["local_bytes"] == 0
        assert info["active_clusters"] >= info["clusters"]


def test_gather_iter_kernel_refuses_a_column_too_tall(cuda):
    x = torch.zeros((40000, 8), device=cuda)
    idx = torch.zeros((40000, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        gather.gather_iterate(x, idx, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", [(8, 128), (1024, 128), (64, 256),
                                   (33, 70), (4096, 1024), (1, 1)])
def test_take_along_kernel_matches_plain(cuda, dtype, axis, shape):
    rng = np.random.default_rng(shape[0] * 7 + axis)
    x = torch.as_tensor(rng.integers(-1000, 1000, shape),
                        device=cuda).to(dtype)
    idx = torch.as_tensor(rng.integers(0, shape[axis], shape),
                          dtype=torch.int32, device=cuda)
    before = gather.take_along.launches
    out = gather.take_along(x, idx, axis)
    torch.cuda.synchronize()
    assert gather.take_along.launches == before + 1
    assert torch.equal(out, gather.take_along_plain(x, idx, axis))
    assert torch.equal(out, torch.take_along_dim(x, idx.long(), axis))


@pytest.mark.parametrize("case", ["float32", "damping", "bfloat16", "tanh"])
def test_generic_bp_gpu_matches_cpu(cuda, bundles, case):
    """The padded-CSR decoder gives the same bits on the card as on the
    CPU (float32, damped, bfloat16); tanh BP the same decisions."""
    _, M = bundles[:2]
    H, syn = _syndromes(M, "Z", 96, 4)
    prior = torch.as_tensor(qt.channel_llrs(M["channel_probsZ"]),
                            dtype=torch.float32)
    seq = torch.as_tensor(alpha_schedule("dynamical", 30))
    outs = {}
    for dev in ("cpu", cuda):
        g = bp.TannerGraph.from_dense(H, device=dev)
        args = (torch.as_tensor(syn, device=dev), prior.to(dev))
        if case == "tanh":
            out = bp.decode_batch_tanh(g, *args, 30)
        else:
            kw = dict(damping=dict(damping=0.8),
                      bfloat16=dict(msg_dtype=torch.bfloat16)).get(case, {})
            out = bp.decode_batch(g, *args, seq.to(dev), 30, **kw)
        outs[str(dev)] = {k: v.cpu() for k, v in out.items()}
    a, b = outs["cpu"], outs[str(cuda)]
    assert a["converged"].any() and not a["converged"].all()
    for k in (("hard", "converged", "iterations") if case == "tanh"
              else a):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kw", [dict(damping=0.9), dict(bp_variant="tanh")])
def test_pooled_round_generic_gpu_matches_cpu(cuda, bundles, kw):
    """Damped (float32 messages) and tanh rounds: K2 on the card and the
    plain versions on the CPU give identical flags, and K1 is not
    launched."""
    circ, M, decs = bundles
    gen = torch.Generator(device=cuda).manual_seed(7)
    from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
    randoms = [sample_gate_randoms(gen, 128, circ.num_error_locs, 0.006)
               for _ in range(2)]
    outs = {}
    before = bp_lift_cuda.decode_batch_lift_cuda.launches
    for dev in ("cpu", str(cuda)):
        dz, dx = decs[dev]
        fn = engine.make_pooled_round_fn(dz, dx, circ.num_error_locs, 0.006,
                                         128, 50, 2, 2,
                                         msg_dtype=torch.float32, **kw)
        outs[dev] = fn(None, randoms=[tuple(x.to(dev) for x in r)
                                      for r in randoms])
    assert bp_lift_cuda.decode_batch_lift_cuda.launches == before
    for k, v in outs["cpu"].items():
        assert torch.equal(v, outs[str(cuda)][k].cpu()), k


def test_calibration_histogram_on_card(cuda):
    """The device histogram of the calibration fit gives numpy's densities
    on the card."""
    x = np.random.default_rng(3).normal(1.0, 5.0, 200_000)
    lo, hi = float(x.min()), float(x.max())
    want = np.histogram(x, bins=50, range=(lo, hi), density=True)
    got = calibrate._histogram(torch.as_tensor(x, device=cuda), lo, hi, 50)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# --- multi-code and the shot mesh ------------------------------------------

MULTI_CODES = ("[[90, 8, 10]]", "[[108, 8, 10]]")


@pytest.fixture(scope="module")
def multicode_bundles(cuda):
    """The multi-code configuration's codes at 10 cycles, p=0.004, maxIter
    20, OSD order 2: per code, (circuit, [dec_z, dec_x]) on the card."""
    seq = alpha_schedule("dynamical", 20)
    out = {}
    for name in MULTI_CODES:
        code = qt.get_code(name)
        circ = qt.SyndromeCircuit(code, num_cycles=10)
        M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.004)
        out[name] = (circ, [engine._make_basis(circ, M, b, seq, osd_order=2,
                                               device=cuda) for b in "ZX"])
    return out


@pytest.mark.parametrize("name", MULTI_CODES)
def test_kernels_at_multi_code_shapes(cuda, multicode_bundles, name):
    """K1 (both bases, 256 sampled shots, maxIter 20) and K2 (its BP-failed
    shots at the stage-1, prefix and full widths) against their plain
    versions on every output."""
    circ, decs = multicode_bundles[name]
    gen = torch.Generator(device=cuda).manual_seed(3)
    trials = trial_batch(gen, 0.004, decs[0].maps, decs[1].maps,
                         circ.num_error_locs, 256)
    for basis, dec in zip("zx", decs):
        syn = trials[f"syndrome_{basis}"]
        args = (dec.lifted, syn, dec.prior, dec.alpha_seq, 20)
        a = bp_lift_cuda.decode_batch_lift_cuda(*args)
        torch.cuda.synchronize()
        b = bp_lift_cuda.decode_batch_lift_plain(*args)
        for k in ("hard", "converged", "iterations", "values"):
            assert torch.equal(a[k], b[k]), (basis, k)
        fail = ~a["converged"]
        assert fail.any() and not fail.all()
        m, K, R = dec.H.shape[0], dec.K, dec.basis_cols.shape[0]
        residual = (syn[fail].to(torch.int32)
                    ^ ((a["hard"][fail].float() @ dec.HT).to(torch.int32)
                       & 1))
        cols = torch.sort(a["values"][fail].abs(), dim=1,
                          stable=True).indices
        HT = dec.H.T.contiguous()
        Hb = torch.zeros((m, -(-R // 32) * 32), dtype=torch.uint8,
                         device=cuda)
        Hb[:, :R] = dec.H[:, dec.basis_cols]
        prefix = _gather_pack(HT, cols[:, :K], K, words_major=True)
        full = torch.cat([prefix, _pack_columns(Hb).T.contiguous()[None]
                          .expand(len(cols), -1, -1)], 1)
        for Hp, Kw in ((_gather_pack(HT, cols[:, :256], 256,
                                     words_major=True), 256),
                       (prefix, K), (full, K + R)):
            for exit_on_valid in (False, True):
                _elim_against_plain("K2", Hp, residual, Kw, m, rank=dec.rank,
                                    exit_on_valid=exit_on_valid)


def test_run_multi_code_simulation_on_card(cuda):
    """Two codes on the card through K1 and K2 only, each stopped at its
    target; code 0 draws run_simulation's stream, so its tally equals a
    single-code run_simulation's on the same settings."""
    kw = dict(num_cycles=2, maxIter=5, osd_order=2, target_logical_errors=6,
              max_trials=400, batch_size=16, rounds_per_dispatch=2,
              base_seed=9, verbose=False)
    wrappers = (bp_lift_cuda.decode_batch_lift_cuda,
                osd_cuda.eliminate_blocks_v1,
                bp_lift_layered_cuda.decode_batch_lift_layered_cuda,
                osd_cuda.eliminate_blocks_fused, osd_cuda.eliminate_blocks_pair)
    before = [w.launches for w in wrappers]
    res = qt.run_multi_code_simulation(["[[72, 12, 6]]", "[[90, 8, 10]]"],
                                       0.01, **kw)
    used = [w.launches - b for w, b in zip(wrappers, before)]
    assert used[0] > 0 and used[1] > 0 and not any(used[2:]), used
    for name, r in res.items():
        assert r["logical_errors"] == 6 or r["num_trials"] == 400, (name, r)
        assert r["num_devices"] == 1
    code = qt.get_code("[[72, 12, 6]]")
    kw.pop("num_cycles")
    one = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.01,
                            num_cycles=2, ell=code.ell, m=code.m,
                            a_x_powers=code.a_x_powers,
                            a_y_powers=code.a_y_powers,
                            b_y_powers=code.b_y_powers,
                            b_x_powers=code.b_x_powers, **kw)
    r0 = res["[[72, 12, 6]]"]
    assert (one["num_trials"], one["logical_errors"]) == \
        (r0["num_trials"], r0["logical_errors"])


def test_two_shard_mesh_on_card(cuda, bundles):
    """Two shards on one card: shard 0 decodes the one-shard stream, the
    counts equal the flags' sums, the gather returns the flags in shard
    order, and run_simulation over the mesh stops exactly at its target."""
    circ, M, decs = bundles
    dz, dx = decs[str(cuda)]
    fn = engine.make_pooled_round_fn(dz, dx, circ.num_error_locs, 0.006, 64,
                                     50, 2, 2)
    two = mesh.shot_mesh(2)
    out = mesh.shard_rounds(fn, two)(engine._gens(7, two, cuda))
    one = fn(mesh.generator(7, device=cuda))
    for k, v in one.items():
        assert out[k].shape == (256,) and torch.equal(out[k][:128], v), k
    keys = ("any_err", "z_err", "x_err", "z_rankdef", "x_rankdef")
    g = mesh.gather_flags({k: out[k] for k in keys})
    for k in keys:
        assert out[f"{k}_count"] == int(out[k].sum()), k
        assert np.array_equal(g[k], out[k].cpu().numpy()), k
    code = qt.get_code("[[72, 12, 6]]")
    res = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.006,
                            num_cycles=6, maxIter=50, osd_order=2,
                            precomputed_matrices=M, target_logical_errors=40,
                            max_trials=4000, batch_size=32,
                            rounds_per_dispatch=2, base_seed=7, mesh=two,
                            verbose=False, ell=code.ell, m=code.m,
                            a_x_powers=code.a_x_powers,
                            a_y_powers=code.a_y_powers,
                            b_y_powers=code.b_y_powers,
                            b_x_powers=code.b_x_powers)
    assert res["logical_errors"] == 40 and res["num_devices"] == 2



def _bb_params(code):
    return dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                b_x_powers=code.b_x_powers)


@pytest.mark.parametrize("bp_variant", ["minsum", "layered"])
@pytest.mark.parametrize("basis", ["Z", "X"])
def test_batch_decoder_on_card(cuda, bundles, basis, bp_variant):
    """BatchDecoder on the card (K1 or K3, then K2) against itself on the
    CPU (the plain versions), through the padding path; the card's run
    launches its kernels."""
    circ, M, _ = bundles
    code = qt.get_code("[[72, 12, 6]]")
    kw = dict(num_cycles=6, maxIter=50, osd_order=2, precomputed_matrices=M,
              bp_variant=bp_variant, **_bb_params(code))
    H, syn = _syndromes(M, basis, 300, seed=5)
    syn = np.concatenate([syn, np.asarray(
        np.random.default_rng(6).random((100, H.shape[0])) < 0.02,
        np.int8)])  # noisy syndromes too: some shots need OSD
    cpu = qt.BatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, 0.006,
                          device="cpu", **kw).decode(syn, basis, 128)
    bp_wrap = (bp_lift_layered_cuda.decode_batch_lift_layered_cuda
               if bp_variant == "layered"
               else bp_lift_cuda.decode_batch_lift_cuda)
    bp_wrap.launches = osd_cuda.eliminate_blocks_v1.launches = 0
    card = qt.BatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, 0.006,
                           device=cuda, **kw).decode(syn, basis, 128)
    assert bp_wrap.launches > 0 and osd_cuda.eliminate_blocks_v1.launches > 0
    for key in ("logicals", "converged", "rank_deficient"):
        assert np.array_equal(card[key], cpu[key]), key
    assert 0 < cpu["converged"].sum() < len(syn)


@pytest.mark.parametrize("name", ["steane", "[[144,12,12]]"])
def test_code_capacity_round_on_card(cuda, name):
    """The code-capacity round on the card (K2 for OSD) against the CPU on
    the same error draws, fail and conv exact."""
    from qldpc_tpu_torch.parallel import code_capacity as cc
    if name == "steane":
        _, H, L, _ = cc.steane_code()
        p, B = 0.05, 4096
    else:
        code = qt.get_code("[[144, 12, 12]]")
        H, L, p, B = code.Hz, code.Lx, 0.05, 1024
    e = torch.rand((B, H.shape[1]), generator=torch.Generator()
                   .manual_seed(9)) < p
    want = cc._code_capacity_round(e, cc.capacity_decoder(H, p, L, 50, 2,
                                                          device="cpu"))
    osd_cuda.eliminate_blocks_v1.launches = 0
    got = cc._code_capacity_round(e.to(cuda), cc.capacity_decoder(
        H, p, L, 50, 2, device=cuda))
    assert osd_cuda.eliminate_blocks_v1.launches > 0
    for key in ("fail", "conv"):
        assert torch.equal(got[key].cpu(), want[key]), key
    res = cc.run_code_capacity(H, p, num_shots=3000, L=L, maxIter=50,
                               osd_order=2, batch_size=1024, device=cuda,
                               mesh=mesh.shot_mesh(2))
    assert res["num_shots"] == 3000 and 0 < res["logical_error_rate"] < 0.5


@pytest.mark.parametrize("span", [None, (5, 41), (0, 0)])
@pytest.mark.parametrize("width", [256, 512, 1024])
def test_gather_pack_kernel_matches_plain(cuda, bundles, width, span):
    """G1 against _gather_pack, bit-transposed into the column layout, on
    every live shot, at the stage-1, prefix and full widths of [[72]] (a
    partial last word at 1000 of 1024 columns), over the whole batch, a
    partial range and an empty one."""
    circ, M, decs = bundles
    dec = decs[str(cuda)][0]
    B, n = 64, dec.H.shape[1]
    rng = np.random.default_rng(width)
    cols = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(B)]),
                           device=cuda)
    K = width - 24 if width == 1024 else width
    live = None if span is None else torch.tensor(span, dtype=torch.int32,
                                                  device=cuda)
    before = osd_cuda.gather_pack.launches
    got = osd_cuda.gather_pack(dec.col_index, cols[:, :K], width, live=live)
    torch.cuda.synchronize()
    assert osd_cuda.gather_pack.launches == before + 1
    want = _columns(_gather_pack(dec.H.T.contiguous(), cols[:, :K], width,
                                 words_major=True))
    lo, hi = (0, B) if span is None else span
    assert got.shape == want.shape
    assert torch.equal(got[lo:hi], want[lo:hi])


@pytest.mark.parametrize("span", [(3, 29), (0, 0), (0, 64)])
@pytest.mark.parametrize("kernel", ["v1", "fused", "pair"])
def test_gated_elim_kernels_match_ungated(cuda, bundles, kernel, span):
    """K2, K4 and K5 gated to [lo, hi) equal their ungated launch on the
    live shots (K5's pairs split at both ends of the range); gated-off
    shots record no pivot and no step."""
    dec, Hp, s = _elim_case(cuda, bundles, 64, 11, 512)
    fn = getattr(osd_cuda, f"eliminate_blocks_{kernel}")
    m = dec.H.shape[0]
    live = torch.tensor(span, dtype=torch.int32, device=cuda)
    full = fn(_columns(Hp), s, 512, m, rank=dec.rank, return_steps=True)
    gated = fn(_columns(Hp), s, 512, m, rank=dec.rank, return_steps=True,
               live=live)
    lo, hi = span
    for name, x, y in zip(("Hp", "s", "prow", "used", "colofrow", "steps"),
                          gated, full):
        assert torch.equal(x[lo:hi], y[lo:hi]), name
    off = torch.ones(64, dtype=torch.bool, device=cuda)
    off[lo:hi] = False
    assert (gated[4][off] == -1).all() and (gated[5][off] == 0).all()
    assert not gated[3][off].any()


def test_steady_pooled_dispatch_reads_nothing_back(cuda, bundles):
    """A steady pooled dispatch (after a warm-up one) issues no host read:
    it runs under torch.cuda.set_sync_debug_mode("error"), and its flags
    equal the warm-up's on the same randoms."""
    circ, M, decs = bundles
    gen = torch.Generator(device=cuda).manual_seed(9)
    from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
    randoms = [sample_gate_randoms(gen, 256, circ.num_error_locs, 0.006)
               for _ in range(2)]
    dz, dx = decs[str(cuda)]
    fn = mesh.shard_rounds(engine.make_pooled_round_fn(
        dz, dx, circ.num_error_locs, 0.006, 256, 50, 2, 2), mesh.shot_mesh())
    want = fn([None], randoms=[randoms])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn([None], randoms=[randoms])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k, v in want.items():
        assert torch.equal(v, got[k]), k
    counts = mesh.read_counts([got])[0]
    assert counts["any_err_count"] == int(got["any_err"].sum()) > 0
    assert counts["osd_overflow_count"] == 0


def _osd_kernel_launches(fn, randoms, monkeypatch, tmp_path) -> tuple:
    """(flags, kernels launched inside ``engine._osd_fallback``) of one
    dispatch under the profiler: each kernel matched to the host call that
    launched it through its correlation id."""
    import json

    from torch.profiler import ProfilerActivity, profile, record_function
    real = engine._osd_fallback

    def ranged(*args, **kw):
        with record_function("osd_fallback"):
            return real(*args, **kw)

    monkeypatch.setattr(engine, "_osd_fallback", ranged)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn([None], randoms=[randoms])
        torch.cuda.synchronize()
    monkeypatch.setattr(engine, "_osd_fallback", real)
    path = tmp_path / "osd_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == "osd_fallback"
              and e.get("cat") == "user_annotation"]
    inside = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and any(s <= e["ts"] <= t for s, t in ranges)}
    return out, sum(e.get("cat") == "kernel"
                    and (e.get("args") or {}).get("correlation") in inside
                    for e in events)


def test_default_osd_chunk_at_144_bench_shape(cuda, monkeypatch, tmp_path):
    """[[144,12,12]], p=0.004, 4 rounds of 1024 shots: one pooled dispatch
    at the default OSD chunk (the whole pool, one chunk a basis) gives the
    flags of chunks of pool // 8 on the same randoms, flag for flag, with
    about an eighth of their OSD kernel launches, and a steady one reads
    nothing back."""
    from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
    circ, M = _built("[[144, 12, 12]]", 12, 0.004)
    seq = alpha_schedule("dynamical", 50)
    decs = [engine._make_basis(circ, M, b, seq, osd_order=2, device=cuda)
            for b in "ZX"]
    pool = 4 * 1024
    assert engine.pooled_osd_chunk(pool, decs, 2) == pool
    gen = torch.Generator(device=cuda).manual_seed(21)
    randoms = [sample_gate_randoms(gen, 1024, circ.num_error_locs, 0.004)
               for _ in range(4)]
    fns = {chunk: mesh.shard_rounds(engine.make_pooled_round_fn(
        *decs, circ.num_error_locs, 0.004, 1024, 50, 2, 4,
        osd_chunk=chunk), mesh.shot_mesh()) for chunk in (None, pool // 8)}
    for fn in fns.values():
        fn([None], randoms=[randoms])              # warm-up
    launches = {}
    for chunk, fn in fns.items():
        out, launches[chunk] = _osd_kernel_launches(fn, randoms, monkeypatch,
                                                    tmp_path)
        fns[chunk] = (fn, out)
    want, got = fns[pool // 8][1], fns[None][1]
    for k, v in want.items():
        assert torch.equal(v, got[k]), k
    assert int(got["osd_overflow"].sum()) == 0
    assert 0 < int((~got["z_conv"]).sum())
    print(f"OSD kernel launches: default {launches[None]}, pool // 8 "
          f"{launches[pool // 8]}")
    assert 500 <= launches[None] <= 800
    assert launches[pool // 8] > 6 * launches[None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steady = fns[None][0]([None], randoms=[randoms])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k, v in want.items():
        assert torch.equal(v, steady[k]), k


def test_traced_dispatch_reads_nothing_and_counts_as_the_cpu(cuda, bundles,
                                                             monkeypatch):
    """With the program's telemetry on, a steady pooled dispatch still
    issues no host read and launches what it launches off; its spans and
    counters (BP iterations, OSD live counts, eliminator live shots and
    column steps) equal the CPU's plain path's on the same randoms; the
    eliminator's profiler range is entered once a launch under a profiler
    and never without one."""
    from torch.profiler import ProfilerActivity, profile

    from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
    from qldpc_tpu_torch.utils import telemetry
    circ, M, decs = bundles
    gen = torch.Generator(device=cuda).manual_seed(10)
    randoms = [sample_gate_randoms(gen, 128, circ.num_error_locs, 0.006)
               for _ in range(2)]
    traced = {}
    for dev in ("cpu", str(cuda)):
        dz, dx = decs[dev]
        fn = mesh.shard_rounds(engine.make_pooled_round_fn(
            dz, dx, circ.num_error_locs, 0.006, 128, 50, 2, 2),
            mesh.shot_mesh())
        rnd = [tuple(t.to(dev) for t in r) for r in randoms]
        want = fn([None], randoms=[rnd])
        launches = osd_cuda.eliminate_blocks_v1.launches
        telemetry.reset()
        telemetry.enable()
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn([None], randoms=[rnd])
        finally:
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode(0)
            telemetry.disable()
        for k, v in want.items():
            assert torch.equal(v, got[k]), k
        spans = telemetry.export()["spans"]
        telemetry.reset()
        traced[dev] = [(sp["name"], sp["parent"], sp["counters"])
                       for sp in spans]
        elims = [sp for sp in spans if sp["name"] == "elim"]
        if dev != "cpu":
            assert len(elims) == \
                osd_cuda.eliminate_blocks_v1.launches - launches
    assert traced["cpu"] == traced[str(cuda)]
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or real(*a, **k))
    fn([None], randoms=[rnd])
    torch.cuda.synchronize()
    assert not entered
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn([None], randoms=[rnd])
        torch.cuda.synchronize()
    ranges = sum(e.count for e in prof.key_averages()
                 if e.key.startswith(osd_cuda.K2_RANGE))
    assert ranges == len(elims)


# The column hand-off: G1's column layout, and K2, K4 and K5 from it
@pytest.mark.parametrize("M", [100, 288, 1008, 1024, 2880, 4096])
@pytest.mark.parametrize("kernel", ["K2", "K4", "K5"])
def test_column_layout_is_the_kernels_rule(cuda, kernel, M):
    """The stride the card reports (each kernel's *_sizes) equals the plain
    versions' copy of the rule: ceil(M/32) made odd."""
    assert osd_cuda.column_stride(8, M, cuda, kernel) == \
        osd_cuda.column_stride(8, M, "cpu")


@pytest.mark.parametrize("span", [None, (5, 41), (0, 0)])
@pytest.mark.parametrize("width", [256, 1024])
@pytest.mark.parametrize("B", [1, 63])
def test_gather_pack_columns_matches_plain(cuda, bundles, B, width, span):
    """G1 equals its plain version (the bit transpose of _gather_pack) on
    every live shot, with the stride's padding word and the columns past K
    zero, at one shot and at an odd batch (exactly B shots, no padding)."""
    circ, M, decs = bundles
    dec = decs[str(cuda)][0]
    n = dec.H.shape[1]
    rng = np.random.default_rng(width + 1)
    cols = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(B)]),
                           device=cuda)
    K = width - 24 if width == 1024 else width
    live = None if span is None else torch.tensor(span, dtype=torch.int32,
                                                  device=cuda)
    before = osd_cuda.gather_pack.launches
    got = osd_cuda.gather_pack(dec.col_index, cols[:, :K], width, live=live)
    torch.cuda.synchronize()
    assert osd_cuda.gather_pack.launches == before + 1
    want = osd_cuda.gather_pack_plain(dec.col_index, cols[:, :K], width)
    m = dec.H.shape[0]
    S = osd_cuda.column_stride(width // 32, m, cuda)
    assert got.shape == want.shape == (B, width, S)
    lo, hi = (0, B) if span is None else (min(span[0], B), min(span[1], B))
    assert torch.equal(got[lo:hi], want[lo:hi])
    assert not got[lo:hi, K:].any() and not got[lo:hi, :, -(-m // 32):].any()


@pytest.mark.parametrize("want_matrix", [True, False])
@pytest.mark.parametrize("branch", ["shared", "device"])
@pytest.mark.parametrize("kernel", ["K2", "K4", "K5"])
def test_elim_kernels_from_columns(cuda, bundles, monkeypatch, kernel,
                                   branch, want_matrix):
    """Each eliminator from G1's column output gives every output of its
    plain version on the words-major matrix, bit for bit, with its columns
    in shared memory (copied in) and on the device-memory branch
    (eliminated in place: the launch consumes its input); without
    want_matrix it writes no reduced matrix."""
    dec, Hp, s = _elim_case(cuda, bundles, 37, 13, 256)
    fn, plain = _ELIM[kernel]
    m = Hp.shape[2]
    if branch == "device":
        monkeypatch.setattr(osd_cuda, "_SMEM_LIMIT", 0)
    info = osd_cuda.elim_launch_info(37, 8, m, cuda, kernel)
    assert info["columns_in"] == ("device memory" if branch == "device"
                                  else "shared memory")
    kw = dict(rank=dec.rank, return_steps=True)
    cols = _columns(Hp)
    before = fn.launches
    got = fn(cols, s, 256, m, want_matrix=want_matrix, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(Hp, s, 256, m, **kw)
    if not want_matrix:
        assert got[0] is None
        got, ref = got[1:], ref[1:]
    _elim_equal(got, ref)
    # in place on the device-memory branch only
    assert torch.equal(cols, _columns(Hp)) == (branch == "shared")


@pytest.mark.parametrize("kernel", ["K2", "K4", "K5"])
def test_elim_kernels_from_columns_gated(cuda, bundles, kernel):
    """Column input gated to a range (K5's pairs split at both ends) equals
    the plain version gated the same way on the live shots."""
    dec, Hp, s = _elim_case(cuda, bundles, 64, 11, 512)
    fn, plain = _ELIM[kernel]
    m = dec.H.shape[0]
    live = torch.tensor((3, 29), dtype=torch.int32, device=cuda)
    kw = dict(rank=dec.rank, return_steps=True, live=live)
    a = fn(_columns(Hp), s, 512, m, **kw)
    b = plain(Hp, s, 512, m, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x[3:29], y[3:29])


@pytest.mark.parametrize("kernel", ["K2", "K4", "K5"])
def test_elim_kernels_from_columns_at_288_basis_rerun(cuda, basis_rerun_288,
                                                      kernel):
    """At [[288,12,18]]'s basis-rerun width (three row words a lane, the
    columns in device memory: eliminated in place) each eliminator equals
    its plain version on every output."""
    Hp, s, Kw, m, rank = basis_rerun_288
    _elim_against_plain(kernel, Hp, s, Kw, m, rank=rank)


def test_prepared_launch_consumes_column_input_in_device_memory(
        cuda, bundles, monkeypatch):
    """A prepared K2 launch reruns from its inputs in shared memory; on the
    device-memory branch it says it consumes them, and with the input
    restored before each launch every launch gives the same outputs."""
    dec, Hp, s = _elim_case(cuda, bundles, 37, 15, 256)
    cols = _columns(Hp)
    m = Hp.shape[2]
    want = osd_cuda.eliminate_blocks_plain(Hp, s, 256, m, rank=dec.rank,
                                           return_steps=True)
    for limit in (osd_cuda._SMEM_LIMIT, 0):
        monkeypatch.setattr(osd_cuda, "_SMEM_LIMIT", limit)
        x = cols.clone()
        launch, finish = osd_cuda.prepare_elim_launch(x, s, 256, m,
                                                      rank=dec.rank)
        assert launch.consumes_input == (limit == 0)
        outs = []
        for _ in range(2):
            x.copy_(cols)
            launch()
            outs.append([t.clone() for t in finish(True)])
        _elim_equal(outs[0], outs[1])
        _elim_equal(outs[0], want)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_osd_batch_layouts_agree_on_card(cuda, bundles, monkeypatch,
                                         version):
    """osd_batch through G1's column hand-off on the card equals the CPU's,
    under K2, K4 and K5."""
    from qldpc_tpu_torch.ops.osd import osd_batch
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", version)
    circ, M, decs = bundles
    out = {}
    for dev in ("cpu", str(cuda)):
        dec = decs[dev][0]
        H, syn = _syndromes(M, "Z", 96, 21)
        gen = np.random.default_rng(21)
        llr = torch.as_tensor(gen.standard_normal((96, H.shape[1])),
                              dtype=torch.float32, device=dev)
        out[dev] = osd_batch(
            dec.H, dec.HT, torch.as_tensor(syn, device=dev), llr,
            (llr < 0).to(torch.int8), dec.K, order=2, num_test=12,
            rank=dec.rank, basis_cols=dec.basis_cols,
            col_index=dec.col_index)
    for k, v in out["cpu"].items():
        assert torch.equal(v, out[str(cuda)][k].cpu()), k


# S1: a round's syndromes from its draws (csrc/trial_syndromes.cu)
S1_SHAPES = {"[[72]] c3": ("[[72, 12, 6]]", 3, (37, 300)),
             "[[90]] c10": ("[[90, 8, 10]]", 10, (37, 1024)),
             "[[108]] c10": ("[[108, 8, 10]]", 10, (37, 1024)),
             "[[144]] c12": ("[[144, 12, 12]]", 12, (37, 1024)),
             "[[288]] c18": ("[[288, 12, 18]]", 18, (37,))}


@pytest.fixture(scope="module")
def s1_maps(cuda):
    """Per shape, a function giving (gate locations, [maps_z, maps_x]) on
    the card, each built once."""
    from qldpc_tpu_torch.ops.sampler import make_trial_maps
    made = {}

    def get(shape):
        if shape not in made:
            name, cycles, _ = S1_SHAPES[shape]
            circ, M = _built(name, cycles, 0.005 if "288" in name else 0.004)
            made[shape] = (circ.num_error_locs,
                           [make_trial_maps(circ, M, b, device=cuda)
                            for b in "ZX"])
        return made[shape]
    return get


@pytest.mark.parametrize("p", [0.0, 0.004, 0.05, 1.0])
@pytest.mark.parametrize("shape", list(S1_SHAPES))
def test_trial_syndromes_kernel_matches_plain(cuda, s1_maps, shape, p):
    """S1's four outputs equal the plain version's bit for bit in both
    frames (at p = 1 every gate location errs, so every row's count is far
    above 1), its ``sampling.flips`` equals the plain fault bits' count, and
    ``trial_batch`` launches it once. [[90]]'s rows (9,000 bytes) start off
    a 16-byte boundary every other shot."""
    from qldpc_tpu_torch.utils import telemetry
    n, maps = s1_maps(shape)
    for B in S1_SHAPES[shape][2]:
        gen = torch.Generator(device=cuda).manual_seed(B)
        err, pauli, cat2 = sampler.sample_gate_randoms(gen, B, n, p)
        if p == 1.0:
            err = torch.ones_like(err)
        want = sampler.trial_syndromes_plain(err, pauli, cat2, *maps)
        flips = sum(int(sampler.fault_bits(err, pauli, cat2, m, b).sum())
                    for m, b in zip(maps, "ZX"))
        launches = sampler.trial_syndromes.launches
        telemetry.reset()
        telemetry.enable()
        try:
            with telemetry.span("sampling"):
                got = trial_batch(None, p, *maps, n, B, (err, pauli, cat2))
        finally:
            telemetry.disable()
        counters = telemetry.export()["spans"][0]["counters"]
        telemetry.reset()
        torch.cuda.synchronize()
        assert sampler.trial_syndromes.launches == launches + 1
        for k, v in want.items():
            g = got[k]
            assert g.dtype == torch.int8 and g.is_contiguous(), k
            assert g.shape == v.shape and torch.equal(g, v), (B, k)
        assert counters == {"sampling.flips": flips}
        assert (flips > 0) == (p > 0)
        # telemetry off: the same outputs, no counter
        again = trial_batch(None, p, *maps, n, B, (err, pauli, cat2))
        for k, v in want.items():
            assert torch.equal(again[k], v), k


def test_pooled_round_launches_s1_once_a_round(cuda, bundles, monkeypatch):
    """A pooled dispatch of 3 rounds launches S1 three times and never runs
    the plain version's product."""
    circ, M, decs = bundles
    dz, dx = decs[str(cuda)]
    fn = engine.make_pooled_round_fn(dz, dx, circ.num_error_locs, 0.006,
                                     64, 50, 2, 3)

    def product(*args):
        raise AssertionError("the plain signature product ran on the card")

    monkeypatch.setattr(sampler, "augmented_bits", product)
    launches = sampler.trial_syndromes.launches
    fn(torch.Generator(device=cuda).manual_seed(4))
    torch.cuda.synchronize()
    assert sampler.trial_syndromes.launches == launches + 3


# R1: the BP residual syndrome and its weight (csrc/bp_residual.cu)
def _r1_cells() -> dict:
    """Every code of every benchmark cell as R1 meets it, read from
    BENCHMARK.json and the configuration and traffic files it names:
    {cell[ code]: (code, cycles, p, shots a round, maxIter, BP schedule)}."""
    root = Path(__file__).resolve().parents[1]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    configs = {c["name"]: json.loads((root / c["file"]).read_text())
               for c in bench["configs"]}
    cells = {}
    for w in bench["workloads"]:
        cfg = configs[w["config"]]
        p = json.loads((root / "perfbench" / "traffic"
                        / f"{w['traffic']}.json").read_text())["p"]
        dec = cfg["decoder"]
        variant = "layered" if dec["bp"].startswith("layered") else "minsum"
        codes = cfg.get("codes", [cfg])
        for c in codes:
            name = w["name"] + (f" {c['code']['name']}" if len(codes) > 1
                                else "")
            cells[name] = (c["code"]["name"], c["num_cycles"], p,
                           cfg["dispatch"]["batch"], dec["max_iter"],
                           variant)
    return cells


R1_CELLS = _r1_cells()


def _r1_against_plain(syn, hard, dec):
    """R1 on (syn, hard) equals its plain version on the residual and the
    weight, launches once, and counts ``osd.hard_ones`` as the set bits
    of ``hard`` with telemetry on."""
    from qldpc_tpu_torch.utils import telemetry
    want = osd_cuda.bp_residual_plain(syn, hard, dec.HT)
    launches = osd_cuda.bp_residual.launches
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.span("osd.order"):
            got = osd_cuda.bp_residual(syn, hard, dec.HT, dec.col_index)
    finally:
        telemetry.disable()
    counters = telemetry.export()["spans"][0]["counters"]
    telemetry.reset()
    torch.cuda.synchronize()
    assert osd_cuda.bp_residual.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        assert g.shape == w.shape and torch.equal(g, w)
    assert counters == {"osd.hard_ones": int((hard.to(torch.int8) & 1)
                                             .sum())}
    again = osd_cuda.bp_residual(syn, hard, dec.HT, dec.col_index)
    for g, w in zip(again, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("cell", list(R1_CELLS))
def test_bp_residual_kernel_matches_plain(cuda, cell):
    """R1 against its plain version in both bases on a round of the cell's
    shots from ``trial_batch`` through K1 (K3 under the layered schedule)
    at its maxIter, as the pooled OSD reads them."""
    name, cycles, p, B, max_iter, variant = R1_CELLS[cell]
    circ, M = _built(name, cycles, p)
    seq = alpha_schedule("dynamical", max_iter)
    decs = [engine._make_basis(circ, M, b, seq, osd_order=2, device=cuda)
            for b in "ZX"]
    gen = torch.Generator(device=cuda).manual_seed(B + cycles)
    trials = trial_batch(gen, p, decs[0].maps, decs[1].maps,
                         circ.num_error_locs, B)
    for basis, dec in zip("zx", decs):
        syn = trials[f"syndrome_{basis}"]
        bp_out = engine._bp_one_basis(syn, dec, max_iter,
                                      bp_variant=variant)
        res, _ = _r1_against_plain(syn, bp_out["hard"], dec)
        conv = bp_out["converged"]
        assert conv.any() and not conv.all()
        # a converged shot's hard decision reproduces its syndrome
        assert int(res[conv].sum()) == 0


@pytest.mark.parametrize("B", [1, 37, 300])
def test_bp_residual_kernel_adversarial(cuda, B):
    """R1 against its plain version at [[72,12,6]] over 3 cycles (180 rows,
    not a multiple of 32; 1,153 columns, so rows start off a 16-byte
    boundary), on a row of no set column, a row of every column, random
    densities, bytes other than 0 and 1, and a batch starting mid-tensor."""
    circ, M = _built("[[72, 12, 6]]", 3, 0.006)
    dec = engine._make_basis(circ, M, "Z", alpha_schedule("dynamical", 10),
                             device=cuda)
    m, n = dec.H.shape
    assert m % 32
    g = torch.Generator(device=cuda).manual_seed(B)
    dens = torch.rand((B + 1, 1), generator=g, device=cuda)
    hard = (torch.rand((B + 1, n), generator=g, device=cuda)
            < dens).to(torch.int8)
    hard[0] = 1
    if B > 1:
        hard[1] = 0
        hard[2] = torch.randint(-3, 4, (n,), generator=g, device=cuda,
                                dtype=torch.int8)
    syn = (torch.rand((B + 1, m), generator=g, device=cuda)
           < 0.5).to(torch.int8)
    _r1_against_plain(syn[:B], hard[:B], dec)
    _r1_against_plain(syn[1:], hard[1:], dec)  # base off 16 bytes
    zero = torch.zeros((B, n), dtype=torch.int8, device=cuda)
    res, wt = _r1_against_plain(syn[:B], zero, dec)
    assert torch.equal(res, syn[:B].to(torch.int32))


def test_pooled_round_launches_r1_once_a_basis(cuda, bundles, monkeypatch):
    """A pooled dispatch of 3 rounds (one OSD chunk a basis) launches R1
    twice, never runs the plain product on the card, and gives the flags
    of the same dispatch with the plain residual."""
    from qldpc_tpu_torch.ops import osd
    from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
    circ, M, decs = bundles
    dz, dx = decs[str(cuda)]
    fn = engine.make_pooled_round_fn(dz, dx, circ.num_error_locs, 0.006,
                                     64, 50, 2, 3)
    gen = torch.Generator(device=cuda).manual_seed(8)
    randoms = [sample_gate_randoms(gen, 64, circ.num_error_locs, 0.006)
               for _ in range(3)]

    def product(*args):
        raise AssertionError("the plain residual product ran on the card")

    monkeypatch.setattr(osd_cuda, "bp_residual_plain", product)
    launches = osd_cuda.bp_residual.launches
    got = fn(None, randoms=randoms)
    torch.cuda.synchronize()
    assert osd_cuda.bp_residual.launches == launches + 2
    monkeypatch.undo()

    def plain(syn, hard, HT, index):
        return osd_cuda.bp_residual_plain(syn, hard, HT)

    monkeypatch.setattr(engine, "bp_residual", plain)
    monkeypatch.setattr(osd, "bp_residual", plain)
    want = fn(None, randoms=randoms)
    assert osd_cuda.bp_residual.launches == launches + 2
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert int((~got["z_conv"]).sum()) > 0
