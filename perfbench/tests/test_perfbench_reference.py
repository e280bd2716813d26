"""The reference against the program's plain CPU path on [[72,12,6]]: the
same flags on the same draws, and the control (the reference with bfloat16
messages in the program's place) judged not correct."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import checks, matrices
from perfbench.harness import program, reference_bases
from perfbench.reference import decode, osd
from perfbench.traffic import Draws

CONFIG = {**json.loads(
    (Path(__file__).parent / "data" / "bb72_small.json").read_text()),
    "decoder": {"bp": "flooding normalized min-sum", "max_iter": 50,
                "alpha": "dynamical", "clip_llr": 20.0,
                "clip_channel": 50.0, "osd_order": 2, "osd_margin": 128},
    "dispatch": {"batch": 128, "rounds": 2, "osd_chunk": None,
                 "pipeline_depth": 1}}
P = 0.006


@pytest.fixture(scope="module")
def setup():
    cm = matrices.load(CONFIG, P)
    pooled, n_locs, decs = program(CONFIG, [cm], P, "cpu")
    bases = reference_bases(CONFIG, cm, P, "cpu")
    draws = Draws(2**31 + 11, P, 128, 2, n_locs[0], "cpu")
    return cm, pooled, decs[0], bases, draws


def _flags(out):
    return torch.stack([out[k] for k in checks.FLAGS]).numpy()


@pytest.mark.parametrize("index", [0, 1])
def test_reference_equals_program(setup, index):
    _, pooled, decs, bases, draws = setup
    rnd = draws(index)
    got = _flags(pooled([rnd])[0])
    ref = {k: v.numpy() for k, v in decode.decode_round(bases, rnd).items()}
    assert checks.compare(got, ref) == {"conv_mismatch": 0,
                                        "decode_mismatch": 0}
    assert 0 < ref["z_conv"].sum() < len(ref["z_conv"])
    assert ref["z_err"].any()          # the OSD path decides some shots


def test_bp_iterations_equal_program(setup):
    from qldpc_tpu_torch.parallel import engine
    _, _, decs, bases, draws = setup
    err, pauli, cat2 = draws(2)[0]
    syn, _ = bases[0].sig.augmented(err, pauli, cat2)
    mine = decode.bp.decode(bases[0].graph, syn, bases[0].alpha, 50, 20.0)
    theirs = engine._bp_one_basis(syn.to(torch.int8), decs[0], 50)
    assert torch.equal(mine["values"], theirs["values"])
    conv = theirs["converged"]
    assert torch.equal(mine["converged"], conv)
    assert torch.equal(mine["iterations"],
                       torch.where(conv, theirs["iterations"].long() + 1, 50))


def test_control_is_not_correct(setup):
    _, _, _, bases, draws = setup
    total = dict.fromkeys(checks.LIMITS, 0)
    for index in range(2):
        rnd = draws(index)
        ctl = decode.decode_round(bases, rnd, msg_dtype=torch.bfloat16)
        ctl = torch.stack([ctl[k] if k in ctl else torch.zeros_like(
            ctl["z_err"]) for k in checks.FLAGS]).numpy()
        ref = {k: v.numpy() for k, v in
               decode.decode_round(bases, rnd).items()}
        for k, v in checks.compare(ctl, ref).items():
            total[k] += v
    assert not checks.verdict(total)
    assert total["conv_mismatch"] > 10


def test_column_basis_and_reprocess(setup):
    """The reference's greedy column basis is the program's, and a shot
    whose syndrome lies outside H's column space goes through the order-2
    search to the program's answer."""
    from qldpc_tpu_torch.models import gf2
    from qldpc_tpu_torch.ops.osd import osd_batch
    cm, _, decs, bases, draws = setup
    H = cm[1]["HdecZ"]
    assert np.array_equal(bases[0].basis_cols.numpy(),
                          gf2.column_basis(H).astype(np.int64))
    err, pauli, cat2 = draws(3)[0]
    syn, _ = bases[0].sig.augmented(err, pauli, cat2)
    res = decode.bp.decode(bases[0].graph, syn, bases[0].alpha, 5, 20.0)
    gen = torch.Generator().manual_seed(5)
    bad = syn[:8].clone()
    bad[:, :] ^= (torch.rand(bad.shape, generator=gen) < 0.5).to(bad.dtype)
    values, hard = res["values"][:8], res["hard"][:8]
    delta, rdef = osd.osd(bases[0].HT, bases[0].basis_cols, bad, values,
                          hard, bases[0].K, 2, bases[0].logical, 8)
    d = decs[0]
    out = osd_batch(d.H, d.HT, bad.to(torch.int8), values,
                    hard.to(torch.int8), K=d.K, order=2, num_test=12,
                    rank=d.rank, basis_cols=d.basis_cols,
                    logical_pack=d.logical_pack, return_solution=False,
                    col_index=d.col_index)
    assert torch.equal(rdef, out["rank_deficient"])
    assert rdef.any()
    packed = (delta << torch.arange(delta.shape[1])).sum(1)
    assert torch.equal(packed.to(torch.int32), out["logical_delta_packed"])
