"""The port's generic BP (qldpc_tpu_torch/ops/bp.py) and its damped lifted
decoder vs the JAX package's functions on the same inputs.

Every decoder must give JAX's ``converged``, ``iterations`` and ``hard``
exactly. ``values``: float32 min-sum, damped or not, within 1e-5 (absolute
plus relative; the port computes the fused multiply-adds of JAX's XLA
program, see ops/bp.py ``_fused_sub``, and matches it bit for bit on these
inputs); tanh BP on the random code within tests/test_bp.py's own tanh
tolerance (atol 3e-3, rtol 1e-4: XLA's tanh and atanh are approximations
of its own, and atanh near the clip amplifies their last-bit differences,
as test_tanh_gap_is_xlas_transcendentals shows; on the [[72]] graph only
decisions are held, see that test); the damped lifted decoder within 1e-4
of max(|value|, 1) (the XLA lift's fusions sum the posteriors in an order
of their own: JAX's compiled decoder misses 1e-5 against its own op-by-op
evaluation, test_damped_lift_gap_is_xlas_own). The k = 0 harvest is one
check pass on the prior and must be identical. bfloat16 messages are held
statistically, as tests/test_bp.py holds JAX's bfloat16 against its
float32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qldpc_tpu
from qldpc_tpu.ops import bp as jbp
from qldpc_tpu.ops import bp_lift as jbp_lift

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import bp as tbp
from qldpc_tpu_torch.ops.bp_lift import LiftedGraph, decode_batch_lift

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TANH_TOL = dict(rtol=1e-4, atol=3e-3)   # tests/test_bp.py's tanh tolerance


def random_ldpc(rng, m, n, wc=3):
    """tests/test_bp.py's random column-weight-3 code."""
    H = np.zeros((m, n), dtype=np.uint8)
    for j in range(n):
        H[rng.choice(m, size=wc, replace=False), j] = 1
    return H


def random_case(seed, m, n, B, p, mu=3.0, sd=1.5):
    """tests/test_bp.py's random-code inputs: H, prior, syndromes."""
    rng = np.random.default_rng(seed)
    H = random_ldpc(rng, m, n)
    prior = np.clip(rng.normal(mu, sd, n), -20, 20)
    errors = (rng.random((B, n)) < p).astype(np.int8)
    return H, prior, ((errors @ H.T) % 2).astype(np.int8)


@pytest.fixture(scope="module")
def real72():
    """[[72,12,6]], 3 cycles, p=0.003, basis Z: H, prior, 64 syndromes."""
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    circ = qldpc_tpu.SyndromeCircuit(code, num_cycles=3)
    M = qldpc_tpu.build_decoding_matrices(circ, code.Lx, code.Lz, 0.003)
    H = (M["HdecZ"] != 0).astype(np.uint8)
    prior = qldpc_tpu.channel_llrs(M["channel_probsZ"])
    rng = np.random.default_rng(2)
    errors = (rng.random((64, H.shape[1])) < M["channel_probsZ"])
    syn = ((errors.astype(np.int8) @ H.T) % 2).astype(np.int8)
    return code, M, H, prior, syn


def both(H, syn, prior):
    """(JAX graph, port graph, JAX args, port args) of one input."""
    jg = jbp.TannerGraph.from_dense(H)
    tg = tbp.TannerGraph.from_dense(H, device="cpu")
    jargs = (jnp.asarray(syn), jnp.asarray(prior, dtype=jnp.float32))
    targs = (torch.as_tensor(syn), torch.as_tensor(prior, dtype=torch.float32))
    return jg, tg, jargs, targs


def assert_same_decode(want, got, what="", tol=TOL):
    """Decisions identical; values within ``tol`` (None: the caller checks
    them)."""
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(want) == set(got)
    for k in ("converged", "iterations", "hard"):
        assert want[k].dtype == got[k].dtype and \
            np.array_equal(want[k], got[k]), (what, k)
    assert got["values"].dtype == np.float32
    if tol is not None:
        np.testing.assert_allclose(got["values"], want["values"], **tol,
                                   err_msg=what)
    return want, got


@pytest.mark.parametrize("case", ["random", "real72_Z", "real72_X"])
def test_tanner_graph_identical(case, real72):
    if case == "random":
        H = random_case(3, 30, 60, 1, 0.0)[0]
    else:
        M = real72[1]
        H = M[f"Hdec{case[-1]}"]
    jg = jbp.TannerGraph.from_dense(H)
    tg = tbp.TannerGraph.from_dense(H, device="cpu")
    assert (jg.m, jg.n, jg.dr, jg.dc) == (tg.m, tg.n, tg.dr, tg.dc)
    for name in ("row_cols", "row_mask", "col_edges", "col_mask"):
        assert np.array_equal(np.asarray(getattr(jg, name)),
                              getattr(tg, name).numpy()), name
    assert tg.row_cols.dtype == torch.int64 and tg.row_mask.dtype == torch.bool


@pytest.mark.parametrize("mode,alpha", [
    ("dynamical", 1.0), ("alvarado", 0.8),
    ("alvarado-autoregressive", [0.5, 0.7, 0.8, 0.9]),
])
def test_decode_batch_matches_jax(mode, alpha):
    """tests/test_bp.py::test_matches_oracle_random_code's inputs."""
    maxIter = 12
    H, prior, syn = random_case(3, 30, 60, 24, 0.06)
    seq = jbp.alpha_schedule(mode, maxIter, alpha)
    assert np.array_equal(seq, tbp.alpha_schedule(mode, maxIter, alpha))
    jg, tg, jargs, targs = both(H, syn, prior)
    want = jbp.decode_batch(jg, *jargs, jnp.asarray(seq), maxIter)
    got = tbp.decode_batch(tg, *targs, torch.as_tensor(seq), maxIter)
    assert_same_decode(want, got, mode)
    assert 0 < int(got["converged"].sum()) < 24


def test_damping_matches_jax():
    """tests/test_bp.py::test_damping_matches_oracle's inputs, damping
    0.9."""
    maxIter = 10
    H, prior, syn = random_case(11, 24, 48, 8, 0.08, mu=2.5, sd=1.0)
    seq = jbp.alpha_schedule("dynamical", maxIter)
    jg, tg, jargs, targs = both(H, syn, prior)
    want = jbp.decode_batch(jg, *jargs, jnp.asarray(seq), maxIter,
                            damping=0.9)
    got = tbp.decode_batch(tg, *targs, torch.as_tensor(seq), maxIter,
                           damping=0.9)
    assert_same_decode(want, got, "damping 0.9")
    undamped = tbp.decode_batch(tg, *targs, torch.as_tensor(seq), maxIter)
    assert not torch.equal(got["values"], undamped["values"])


def test_tanh_matches_jax():
    """tests/test_bp.py::test_tanh_bp_matches_oracle's inputs."""
    maxIter = 15
    H, prior, syn = random_case(17, 30, 60, 24, 0.06)
    jg, tg, jargs, targs = both(H, syn, prior)
    want = jbp.decode_batch_tanh(jg, *jargs, maxIter)
    got = tbp.decode_batch_tanh(tg, *targs, maxIter)
    assert_same_decode(want, got, "tanh", TANH_TOL)


def test_tanh_on_real_decoding_matrix(real72):
    """tests/test_bp.py::test_tanh_bp_on_real_decoding_matrix's inputs.
    Over 30 iterations on the [[72]] graph the last-bit differences of the
    transcendentals (XLA's own approximations against float64 rounded)
    grow through atanh near the clip, so only decisions are held: converged
    and iterations identical, hard identical on every converged shot and
    on all but a thousandth of the unconverged shots' bits."""
    _, _, H, prior, syn = real72
    syn = syn[:32]
    jg, tg, jargs, targs = both(H, syn, prior)
    want = {k: np.asarray(v) for k, v in
            jbp.decode_batch_tanh(jg, *jargs, 30).items()}
    got = {k: v.numpy() for k, v in
           tbp.decode_batch_tanh(tg, *targs, 30).items()}
    for k in ("converged", "iterations"):
        assert np.array_equal(want[k], got[k]), k
    conv = got["converged"]
    assert conv.mean() > 0.6
    assert np.array_equal(want["hard"][conv], got["hard"][conv])
    assert (want["hard"][~conv] != got["hard"][~conv]).mean() < 1e-3
    for b in np.nonzero(conv)[0]:
        assert np.array_equal((got["hard"][b] @ H.T) % 2, syn[b])


def test_real_decoding_matrix_matches_jax(real72):
    _, _, H, prior, syn = real72
    seq = jbp.alpha_schedule("dynamical", 20)
    jg, tg, jargs, targs = both(H, syn, prior)
    want = jbp.decode_batch(jg, *jargs, jnp.asarray(seq), 20)
    got = tbp.decode_batch(tg, *targs, torch.as_tensor(seq), 20)
    assert_same_decode(want, got, "[[72]] dynamical")
    assert got["converged"].numpy().mean() > 0.7


def test_first_argmin_ties():
    """Clipping makes |Q| ties common; the port's check update takes the
    first minimum lane as JAX's jnp.argmin does, and its messages equal
    JAX's on rows full of ties (min1 == min2 there, so every lane gets the
    tied magnitude)."""
    rng = np.random.default_rng(5)
    m, dr, B = 6, 7, 16
    Q = rng.choice([-20.0, -3.0, 3.0, 20.0, 1e30], size=(m, dr, B))
    Q[:, -1] = 1e30                                 # a padded lane per row
    Q = Q.astype(np.float32)
    syn = rng.integers(0, 2, (m, B))
    sgn = (1.0 - 2.0 * syn).astype(np.float32)
    want = np.asarray(jbp._check_update(jnp.asarray(Q), jnp.asarray(sgn),
                                        jnp.float32(0.75)))
    got = tbp._check_update(torch.as_tensor(Q), torch.as_tensor(sgn),
                            torch.tensor(0.75))
    assert np.array_equal(got.numpy(), want)
    absQ = np.abs(Q)
    first = np.argmax(absQ == absQ.min(1, keepdims=True), axis=1)
    assert (np.sum(absQ == absQ.min(1, keepdims=True), axis=1) > 1).any()
    assert np.array_equal(torch.as_tensor(absQ).argmin(1).numpy(), first)
    assert np.array_equal(np.asarray(jnp.argmin(jnp.asarray(absQ), axis=1)),
                          first)


def test_syndrome_of(real72):
    _, _, H, _, syn = real72
    tg = tbp.TannerGraph.from_dense(H, device="cpu")
    hard = (np.random.default_rng(1).random((H.shape[1], 16)) < 0.1)
    got = tbp._syndrome_of(torch.as_tensor(hard.astype(np.int8)), tg)
    assert np.array_equal(got.numpy(), (H @ hard.astype(np.int64)) % 2)


@pytest.mark.parametrize("k", [0, 5])
def test_harvest_messages_matches_jax(real72, k):
    """k = 0 (Alvarado's harvest: one unscaled pass on the prior) is
    identical; k = 5 advanced iterations agree within 1e-5."""
    _, _, H, prior, syn = real72
    seq = jbp.alpha_schedule("alvarado-autoregressive", 8,
                             [0.6, 0.7, 0.75, 0.8, 0.85])
    jg, tg, jargs, targs = both(H, syn, prior)
    jR, jcols = jbp.harvest_messages(jg, *jargs, jnp.asarray(seq), k)
    tR, tcols = tbp.harvest_messages(tg, *targs, torch.as_tensor(seq), k)
    assert np.array_equal(np.asarray(jcols), tcols.numpy())
    mask = tg.row_mask.numpy()
    jR, tR = np.asarray(jR)[mask], tR.numpy()[mask]
    if k == 0:
        assert np.array_equal(tR, jR)
    else:
        np.testing.assert_allclose(tR, jR, **TOL)
        assert not np.array_equal(
            tR, tbp.harvest_messages(tg, *targs, torch.as_tensor(seq),
                                     0)[0].numpy()[mask])


@pytest.fixture(scope="module")
def m72_6():
    """[[72,12,6]], 6 cycles, p=0.006."""
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    circ = qldpc_tpu.SyndromeCircuit(code, num_cycles=6)
    return code, qldpc_tpu.build_decoding_matrices(circ, code.Lx, code.Lz,
                                                   0.006)


def damped_lift_case(m72_6, basis):
    """(JAX decoder call, port decoder call) of the damping-0.9 lifted
    decoders on 32 shots of ``m72_6``, 12 iterations."""
    code, M = m72_6
    H = (M[f"Hdec{basis}"] != 0).astype(np.uint8)
    prior = qldpc_tpu.channel_llrs(M[f"channel_probs{basis}"])
    rng = np.random.default_rng(4)
    errors = rng.random((32, H.shape[1])) < M[f"channel_probs{basis}"]
    syn = ((errors.astype(np.int8) @ H.T) % 2).astype(np.int8)
    seq = jbp.alpha_schedule("dynamical", 12)
    jg = jbp_lift.LiftedGraph.try_from_dense(H, code.ell, code.m, prior)
    tg = LiftedGraph.try_from_dense(H, code.ell, code.m, prior, device="cpu")

    def jax_call():
        return jbp_lift.decode_batch_lift(
            jg, jnp.asarray(syn), jnp.asarray(prior, dtype=jnp.float32),
            jnp.asarray(seq), 12, damping=0.9)

    def port_call():
        return decode_batch_lift(tg, torch.as_tensor(syn),
                                 torch.as_tensor(prior, dtype=torch.float32),
                                 torch.as_tensor(seq), 12, damping=0.9)
    return jax_call, port_call


def lift_gap(a, b):
    """Largest |a - b| / max(|b|, 1)."""
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_damped_lift_matches_jax(m72_6, basis):
    """The damped roll decoder against JAX's decode_batch_lift(damping=0.9)
    at [[72,12,6]], 6 cycles, p=0.006."""
    jax_call, port_call = damped_lift_case(m72_6, basis)
    want, got = assert_same_decode(jax_call(), port_call(),
                                   f"damped lift {basis}", None)
    w, g = want["values"], got["values"]
    assert np.all(np.abs(g - w) <= 1e-4 * np.maximum(np.abs(w), 1.0))
    assert 0 < got["converged"].sum() < 32


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_damped_lift_gap_is_xlas_own(m72_6, basis):
    """Why the damped lifted decoder's values are held at 1e-4 of
    max(|v|, 1) and not 1e-5: JAX's compiled decoder misses 1e-5 against
    JAX's own op-by-op evaluation of the same function (jax.disable_jit;
    XLA's fusions sum and round in an order of their own), and the port is
    no further from the compiled decoder than that evaluation is."""
    jax_call, port_call = damped_lift_case(m72_6, basis)
    compiled = np.asarray(jax_call()["values"])
    with jax.disable_jit():
        op_by_op = np.asarray(jax_call()["values"])
    port = port_call()["values"].numpy()
    jax_gap = lift_gap(op_by_op, compiled)
    assert jax_gap > 1e-5
    assert lift_gap(port, compiled) <= jax_gap


def ulps(a, b):
    """Distance of two float32 arrays in units in the last place."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_tanh_gap_is_xlas_transcendentals(monkeypatch):
    """Why tanh values are held at TANH_TOL and not 1e-5, on
    test_tanh_matches_jax's inputs. (1) JAX's float32 tanh and atanh miss
    the float64 values rounded, which the port computes, by a few units in
    the last place. (2) With only those two functions replaced by JAX's,
    the port's decoder equals JAX's decoder evaluated op by op
    (jax.disable_jit) bit for bit. (3) JAX's compiled decoder, whose fused
    transcendentals are XLA's again, misses 1e-5 against that op-by-op
    evaluation itself."""
    x = np.linspace(-10.0, 10.0, 20001, dtype=np.float32)
    y = np.linspace(-0.9999999, 0.9999999, 20001, dtype=np.float32)
    for jf, tf, nf, v in ((jnp.tanh, tbp._tanh32, np.tanh, x),
                          (jnp.arctanh, tbp._atanh32, np.arctanh, y)):
        exact = nf(v.astype(np.float64)).astype(np.float32)
        assert np.array_equal(tf(torch.as_tensor(v)).numpy(), exact)
        d = ulps(np.asarray(jf(jnp.asarray(v))), exact)
        assert (d > 0).mean() > 0.1 and d.max() <= 8, (jf, d.max())

    maxIter = 15
    H, prior, syn = random_case(17, 30, 60, 24, 0.06)
    jg, tg, jargs, targs = both(H, syn, prior)
    compiled = {k: np.asarray(v) for k, v in
                jbp.decode_batch_tanh(jg, *jargs, maxIter).items()}
    with jax.disable_jit():
        op_by_op = {k: np.asarray(v) for k, v in
                    jbp.decode_batch_tanh(jg, *jargs, maxIter).items()}
    port = tbp.decode_batch_tanh(tg, *targs, maxIter)
    assert not np.array_equal(port["values"].numpy(), op_by_op["values"])

    def with_jax(f):
        return lambda t: torch.as_tensor(np.array(f(jnp.asarray(t.numpy()))))
    monkeypatch.setattr(tbp, "_tanh32", with_jax(jnp.tanh))
    monkeypatch.setattr(tbp, "_atanh32", with_jax(jnp.arctanh))
    patched = tbp.decode_batch_tanh(tg, *targs, maxIter)
    for k, v in patched.items():
        assert np.array_equal(v.numpy(), op_by_op[k]), k
    assert not np.allclose(op_by_op["values"], compiled["values"], **TOL)
    np.testing.assert_allclose(op_by_op["values"], compiled["values"],
                               **TANH_TOL)


def test_bf16_messages_statistically_equivalent(real72):
    """bfloat16 messages track float32 (tests/test_bp.py's criteria), and
    the port's bfloat16 tracks JAX's bfloat16."""
    _, _, H, prior, syn = real72
    rng = np.random.default_rng(5)
    M = real72[1]
    errors = rng.random((128, H.shape[1])) < M["channel_probsZ"]
    syn = ((errors.astype(np.int8) @ H.T) % 2).astype(np.int8)
    seq = jbp.alpha_schedule("dynamical", 20)
    jg, tg, jargs, targs = both(H, syn, prior)
    j16 = jbp.decode_batch(jg, *jargs, jnp.asarray(seq), 20,
                           msg_dtype=jnp.bfloat16)
    t32, t16 = (tbp.decode_batch(tg, *targs, torch.as_tensor(seq), 20,
                                 msg_dtype=dt)
                for dt in (torch.float32, torch.bfloat16))
    c32, c16 = t32["converged"].numpy(), t16["converged"].numpy()
    cj16 = np.asarray(j16["converged"])
    assert c16.mean() > 0.7
    assert (c32 == c16).mean() > 0.95 and (cj16 == c16).mean() > 0.95
    hard16 = t16["hard"].numpy()
    for b in np.nonzero(c16)[0]:
        assert np.array_equal((hard16[b] @ H.T) % 2, syn[b])
    both_conv = c32 & c16
    v32 = t32["values"].numpy()[both_conv]
    v16 = t16["values"].numpy()[both_conv]
    assert np.mean(np.sign(v32) == np.sign(v16)) > 0.99


def test_inputs_checked():
    H, prior, syn = random_case(3, 30, 60, 4, 0.06)
    tg = tbp.TannerGraph.from_dense(H, device="cpu")
    seq = torch.ones(4)
    with pytest.raises(ValueError, match="syndrome"):
        tbp.decode_batch(tg, torch.zeros((4, 29), dtype=torch.int8),
                         torch.as_tensor(prior), seq, 4)
    with pytest.raises(ValueError, match="prior"):
        tbp.decode_batch_tanh(tg, torch.as_tensor(syn), torch.zeros(59), 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbp.TannerGraph.from_dense(H)
    assert qt.resolve_device("cpu").type == "cpu"
