"""A run of the harness with the timed path broken underneath comes out not
correct, once for each fault the cells can have (the chip check is
skipped: the small [[72]] cell runs on the CPU). The cells run on one chip,
so there is no exchange between chips to leave out."""
import pytest
import torch

from qldpc_tpu_torch.parallel import engine

from helpers import run


def test_sound_run_is_correct():
    assert run()["correct"] is True


def _bp_unchanged(syndrome, dec, maxIter, *args, **kwargs):
    """BP that returns its state unchanged: the prior, no iteration run."""
    B = syndrome.shape[0]
    values = dec.prior[None].expand(B, -1).clone()
    return dict(values=values, hard=(values < 0).to(torch.int8),
                converged=torch.zeros(B, dtype=torch.bool,
                                      device=values.device),
                iterations=torch.zeros(B, dtype=torch.int32,
                                       device=values.device))


def _osd_half(real):
    """OSD over the first half of the pool only; the rest keep BP's
    answer."""
    def osd(syndrome, values, hard, conv, dec, osd_order, chunk,
            replay=False):
        h = syndrome.shape[0] // 2
        delta, rdef, ovf = real(syndrome[:h], values[:h], hard[:h],
                                conv[:h], dec, osd_order, chunk, replay)
        pad = syndrome.shape[0] - h
        return (torch.cat([delta, torch.zeros(pad, dtype=delta.dtype)]),
                torch.cat([rdef, torch.zeros(pad, dtype=torch.bool)]),
                torch.cat([ovf, torch.zeros(pad, dtype=torch.bool)]))
    return osd


def _readout_altered(real):
    """The readout with one answer a call altered where it is produced."""
    def readout(hard, conv, delta, dec):
        out = real(hard, conv, delta, dec).clone()
        out[0, 0] ^= 1
        return out
    return readout


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(engine, "_bp_one_basis", _bp_unchanged)
    elif fault == "half_the_batch":
        monkeypatch.setattr(engine, "_osd_fallback",
                            _osd_half(engine._osd_fallback))
    else:
        monkeypatch.setattr(engine, "_logical_readout",
                            _readout_altered(engine._logical_readout))
    result = run(seed=2**33 + 1)
    assert result["correct"] is False
    assert sum(c["value"] for c in result["checks"].values()) > 0
