"""A configuration of one code under the layered schedule
(``data/bb72_layered_small.json``: [[72]] at 3 cycles) on the CPU, where
the program's round runs K3's plain twin: the layered reference equals it
flag for flag and sweep for sweep, a round built with the flooding
schedule reads not correct, the bfloat16 control reads not correct, and a
schedule the round would not run is refused at set-up."""
import copy
from types import SimpleNamespace

import pytest
import torch

from perfbench import checks, harness, matrices
from perfbench.reference import bp, bp_layered, decode

from helpers import LAYERED, manifest, run

SEED = 2**31 + 23


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    _, config, traffic = harness.cell_of(manifest(), LAYERED)
    p = float(traffic["p"])
    cm = matrices.load(config, p)
    _, n_locs, decs = harness.program(config, [cm], p, "cpu")
    bases = harness.reference_bases(config, cm, p, "cpu")
    draws = harness.draws_of(config, SEED, p, n_locs, "cpu")[0]
    return config, cm, decs[0], bases, draws


def _syndromes(basis, draws):
    """Both rounds of dispatches 0 and 1 in one pool."""
    syn = [basis.sig.augmented(*rnd)[0] for i in range(2)
           for rnd in draws(i)]
    return torch.cat(syn)


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("basis", [0, 1])
def test_layered_reference_equals_program(setup, basis, scale):
    """Every output of the reference's BP equals K3's plain twin's, with
    the channel's priors and with priors scaled past the message clip
    (which the layered schedule clips from its first half on)."""
    from qldpc_tpu_torch.ops.bp_lift import LiftedGraph
    from qldpc_tpu_torch.ops.bp_lift_layered_cuda import \
        decode_batch_lift_layered_cuda
    config, cm, decs, bases, draws = setup
    d, b, dec = config["decoder"], bases[basis], decs[basis]
    syn = _syndromes(b, draws)
    prior = dec.prior * scale
    assert (prior.abs().max() > d["clip_llr"]) == (scale > 1)
    graph, lifted = b.graph, dec.lifted
    if scale != 1:
        H, group = cm[1][f"Hdec{b.name}"], (config["code"]["ell"],
                                            config["code"]["m"])
        graph = bp.Graph(H, prior.numpy(), *group, "cpu")
        lifted = LiftedGraph.try_from_dense(H, *group, prior.numpy(), "cpu")
    mine = bp_layered.decode(graph, syn, b.alpha, d["max_iter"],
                             d["clip_llr"])
    theirs = decode_batch_lift_layered_cuda(
        lifted, syn.to(torch.int8), prior, dec.alpha_seq, d["max_iter"],
        clip_llr=d["clip_llr"])
    conv = theirs["converged"]
    assert 0 < int(conv.sum()) < conv.numel()
    assert torch.equal(mine["converged"], conv)
    assert torch.equal(mine["hard"], theirs["hard"].bool())
    assert torch.equal(mine["values"], theirs["values"])
    assert torch.equal(mine["iterations"], torch.where(
        conv, theirs["iterations"].long() + 1, d["max_iter"]))


def test_layered_cell_is_correct():
    torch.set_num_threads(1)
    result = run(seed=SEED, cell=LAYERED)
    assert result["correct"] is True
    assert {k: c["value"] for k, c in result["checks"].items()} == {
        "conv_mismatch": 0, "decode_mismatch": 0}


def test_a_flooding_round_is_not_correct(monkeypatch):
    """The layered configuration with its round built with
    ``bp_variant="minsum"``: the check tells the schedules apart."""
    from qldpc_tpu_torch.parallel import engine
    real = engine.make_pooled_round_fn

    def flooding(*args, **kwargs):
        return real(*args, **{**kwargs, "bp_variant": "minsum"})
    monkeypatch.setattr(engine, "make_pooled_round_fn", flooding)
    torch.set_num_threads(1)
    result = run(seed=SEED, cell=LAYERED)
    assert result["correct"] is False
    assert result["checks"]["conv_mismatch"]["value"] > 0


def test_control_is_not_correct(setup):
    _, _, _, bases, draws = setup
    total = dict.fromkeys(checks.LIMITS, 0)
    for index in range(2):
        rnd = draws(index)
        ctl = decode.decode_round(bases, rnd, msg_dtype=torch.bfloat16)
        ctl = torch.stack([ctl.get(k, torch.zeros_like(ctl["z_err"]))
                           for k in checks.FLAGS]).numpy()
        ref = {k: v.numpy() for k, v in
               decode.decode_round(bases, rnd).items()}
        for k, v in checks.compare(ctl, ref).items():
            total[k] += v
    assert not checks.verdict(total)


def test_a_schedule_the_round_would_not_run_is_refused(setup):
    config = setup[0]
    lifted = [(SimpleNamespace(lifted=object()),
               SimpleNamespace(lifted=object()))]
    assert harness.schedule_refusals(config, lifted) == []
    unlifted = [(lifted[0][0], SimpleNamespace(lifted=None))]
    assert len(harness.schedule_refusals(config, unlifted)) == 1
    flooding = copy.deepcopy(config)
    flooding["decoder"]["bp"] = "flooding normalized min-sum"
    assert harness.schedule_refusals(flooding, unlifted) == []
    unknown = copy.deepcopy(config)
    unknown["decoder"]["bp"] = "damped normalized min-sum"
    assert len(harness.schedule_refusals(unknown, lifted)) == 1
    with pytest.raises(SystemExit, match="damped normalized min-sum"):
        harness.program(unknown, [setup[1]], 0.004, "cpu")
