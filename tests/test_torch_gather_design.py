"""The data movement of P1's and P2's Hopper designs, emulated on the CPU.

``csrc/gather_iter.cu`` (P1) loads and stores its lane columns through a
thread-block cluster: block k of a cluster reads row chunk k of all the
cluster's lanes in 16-byte slots and stores each element, with its uint16
source offset, into the owning block's shared memory; after the rounds it
reads its row chunk back from every owner and writes whole row segments.
Each thread keeps its offsets in registers, two to a word.
``csrc/take_along.cu`` (P2) gives a thread four consecutive elements of the
flattened output and, along axis 1, stages a block's rows of x first.

These tests repeat the kernels' index arithmetic in numpy (slots, owners,
offsets, the walk that replaces a division, the staging window) and hold
the result against the plain versions: every input element is read once,
every tile and output element written once, and the emulated tile and
output equal ``gather_iterate_plain`` and ``take_along_plain`` exactly (P1's
sums within rtol 1e-5 in float32, 1e-2 in bfloat16: summation order). The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from qldpc_tpu_torch.ops import gather
from qldpc_tpu_torch.scripts import gather_bench, gather_timing

torch.set_num_threads(1)

SMS = 132  # an H100's multiprocessors
# E of gather_iter.cu's instances: at 1024 threads (or fewer, E = 1), at 512
WIDE_STAGES, DEEP_STAGES = (1, 2, 4, 8, 16, 24), (56, 64, 72)
TA_BLOCK, TA_STAGE_MAX = 1024, 12288  # take_along.cu
RAGGED = ((1000, 400), (37, 5), (35280, 130))
ITERS = 3


def _walk(tid, step, ns, m):
    """gather_iter.cu's GiWalk: (dr, sl) of item tid + m * step, carried
    from tid's by adding (step // ns, step % ns) with a carry."""
    dr, sl = tid // ns, tid % ns
    qs, rs = step // ns, step % ns
    for _ in range(m):
        dr, sl = dr + qs, sl + rs
        carry = sl >= ns
        dr, sl = dr + carry, sl - ns * carry
    return dr, sl


def _p1_slots(rows, lanes, plan, itemsize, vec):
    """Every cluster of the launch with its slots: yields (first block of
    the cluster, and arrays of (slots, V): row r, element e of each word of
    the slot, valid, full, owner rank b, owner lanes Lo, owner lane j), over
    all the cluster's row chunks at once (rank k loads rows [k * rpb, ...)
    of them)."""
    L, C, _ = plan
    V = 16 // itemsize
    blocks = -(-lanes // L)
    _chunks(rows, C)
    for ci in range(-(-blocks // C)):
        c0 = ci * C * L
        CL = min(C * L, lanes - c0)
        aligned = vec and lanes % V == 0 and c0 % V == 0
        ns = (CL + V - 1) // V if aligned else (CL + 2 * V - 2) // V
        w = np.arange(rows * ns)
        r = w // ns
        g0 = r.astype(np.int64) * lanes + c0
        e0 = (g0 & ~(V - 1)) + (w % ns) * V
        full = vec & (e0 >= g0) & (e0 + V <= g0 + CL)
        e = e0[:, None] + np.arange(V)[None, :]  # the slot's V words
        q = e - g0[:, None]
        valid = (q >= 0) & (q < CL)
        b = np.where(valid, q // L, 0)
        j = np.where(valid, q % L, 0)
        Lo = np.minimum(L, lanes - (c0 + b * L))
        yield (ci * C, np.broadcast_to(r[:, None], e.shape), e, valid,
               np.broadcast_to(full[:, None], e.shape), b, Lo, j)


def _chunks(rows, C):
    """Rank k's row chunk: ceil(rows / C) rounded up to 4 rows, so the tall
    path's 4-row owner stores start aligned; the chunks partition the rows."""
    rpb = -(-(-(-rows // C)) // 4) * 4
    chunks = [(min(rows, k * rpb), min(rows, min(rows, k * rpb) + rpb))
              for k in range(C)]
    assert [r for r0, r1 in chunks for r in range(r0, r1)] == list(range(rows))
    assert all(r0 % 4 == 0 or r0 == r1 for r0, r1 in chunks)
    return chunks


def _tall(rows, lanes, plan, itemsize, vec):
    """The kernel's choice of the tall path: one lane a block, aligned
    rows, and P = min(C, 16 / itemsize) lanes of 4 to 16 bytes an access."""
    L, C, _ = plan
    P = min(C, 16 // itemsize)
    return L == 1 and vec and P * itemsize >= 4 and lanes % P == 0


def _p1_tall_items(rows, lanes, plan, itemsize):
    """The tall path's items, in _p1_slots' form: each is G rows (4 at 512
    threads, 2 at 1,024 or fewer; fewer at a chunk's end) by P lanes; its
    row accesses start on P elements and its owner stores (rows rb..rb+G-1
    of one lane) on G rows."""
    L, C, threads = plan
    P = min(C, 16 // itemsize)
    G = 4 if threads == 512 else 2
    chunks = _chunks(rows, C)
    for ci in range(-(-lanes // C)):
        c0 = ci * C
        CL = min(C, lanes - c0)
        assert c0 % P == 0 and CL % P == 0
        slots = CL // P
        for r0, r1 in chunks:
            w = np.arange(-(-(r1 - r0) // G) * slots)
            rb, sl = r0 + G * (w // slots), w % slots
            assert (rb % G == 0).all()
            assert ((rb * lanes + c0 + sl * P) % P == 0).all()
            r = rb[:, None, None] + np.arange(G)[None, :, None]
            lane = sl[:, None, None] * P + np.arange(P)[None, None, :]
            r, lane = np.broadcast_arrays(r, lane)
            yield (ci * C, r, r.astype(np.int64) * lanes + c0 + lane, r < r1,
                   np.ones(r.shape, bool), lane, np.ones(r.shape, np.int64),
                   np.zeros(r.shape, np.int64))


def _stage_of(n, threads):
    need = -(-n // threads)
    stages = DEEP_STAGES if threads == 512 else WIDE_STAGES
    return next(e for e in stages if e >= need)


def _emulate_p1(x, idx, iters, plan, vec=True):
    """P1's launch in numpy: load through the cluster, offsets packed two
    to a word and unpacked, the rounds, the column sums, the store. Returns
    (total, tile, stats)."""
    rows, lanes = x.shape
    L, C, threads = plan
    itemsize = x.element_size()
    blocks = -(-(-(-lanes // L)) // C) * C  # the grid: whole clusters
    xf = x.reshape(-1)
    idf = idx.reshape(-1).numpy().astype(np.int64)
    Y = torch.zeros((blocks, rows * L), dtype=x.dtype)
    src = np.zeros((blocks, rows * L), np.int64)
    moved = dict(full=0, edge=0)
    read, wrote, offs = [], [], []
    items = (_p1_tall_items(rows, lanes, plan, itemsize)
             if _tall(rows, lanes, plan, itemsize, vec)
             else _p1_slots(rows, lanes, plan, itemsize, vec))
    for g, r, e, valid, full, b, Lo, j in items:
        read.append(e[valid])
        wrote.append((g + b[valid]) * rows * L + r[valid] * Lo[valid]
                     + j[valid])
        offs.append(idf[e[valid]] * Lo[valid] + j[valid])
        moved["full"] += int(full[valid].sum())
        moved["edge"] += int((~full[valid]).sum())
    read, wrote = np.concatenate(read), np.concatenate(wrote)
    Y.view(-1)[torch.as_tensor(wrote)] = xf[torch.as_tensor(read)]
    src.reshape(-1)[wrote] = np.concatenate(offs)
    reads = np.bincount(read, minlength=rows * lanes)
    writes = np.bincount(wrote, minlength=src.size).reshape(src.shape)
    # each owner: its elements written once, nothing past them, offsets
    # into its own tile
    n_of = rows * np.clip(lanes - np.arange(blocks) * L, 0, L)
    col = np.arange(rows * L)[None, :]
    assert np.array_equal(writes, (col < n_of[:, None]).astype(np.int64))
    assert ((src < n_of[:, None]) | (col >= n_of[:, None])).all()
    assert src.max() < 1 << 16
    # offsets into registers, two to a 32-bit word, and back (the first
    # block and the last that owns lanes)
    for g in (0, -(-lanes // L) - 1):
        n = int(n_of[g])
        E = _stage_of(n, threads)
        assert E * threads >= n
        i_e = np.arange(threads)[:, None] + np.arange(E)[None, :] * threads
        s_e = np.where(i_e < n, src[g, np.minimum(i_e, rows * L - 1)], 0)
        pad = np.zeros((threads, E + E % 2), np.int64)
        pad[:, :E] = s_e
        off = (pad[:, 0::2] | (pad[:, 1::2] << 16)).astype(np.uint32)
        un = (off[:, np.arange(E) >> 1] >> (16 * (np.arange(E) & 1))) & 0xFFFF
        assert np.array_equal(un[i_e < n], s_e[i_e < n])
    assert (reads == 1).all()
    # the rounds over every owner's tile at once (offsets made global)
    base = (np.arange(blocks) * rows * L)[:, None]
    gsrc = torch.as_tensor((src + base).reshape(-1))
    flat = Y.reshape(-1)
    for _ in range(iters):
        flat = (flat[gsrc].float() + 1.0).to(x.dtype)
    Y = flat.reshape(blocks, rows * L)
    total = torch.zeros(lanes, dtype=torch.float32)
    for g in range(blocks):
        Lb = max(0, min(L, lanes - g * L))
        if Lb:  # owner g's element r * Lb + j is lane g * L + j
            total[g * L:g * L + Lb] = Y[g, :rows * Lb].view(rows, Lb) \
                .float().sum(0)
    # store: the kernel walks the same slots (gi_slot, gi_owner) and reads
    # each element back from its owner: every tile element once
    tile = torch.zeros(rows * lanes, dtype=x.dtype)
    tile[torch.as_tensor(read)] = Y.view(-1)[torch.as_tensor(wrote)]
    return total.to(x.dtype)[None, :], tile.reshape(rows, lanes), moved


def _p1_inputs(rows, lanes, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((rows, lanes))).to(dtype)
    idx = torch.as_tensor(rng.integers(0, rows, (rows, lanes)),
                          dtype=torch.int32)
    return x, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, lanes", gather_bench.LADDER + RAGGED)
def test_p1_cluster_movement_equals_plain(rows, lanes, dtype):
    x, idx = _p1_inputs(rows, lanes, dtype, rows + lanes)
    itemsize = x.element_size()
    plan = gather.launch_plan(rows, lanes, itemsize, SMS)
    total, tile, moved = _emulate_p1(x, idx, ITERS, plan)
    p_total, p_tile = gather.gather_iterate_plain(x, idx, ITERS)
    assert torch.equal(tile, p_tile)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    assert torch.allclose(total.float(), p_total.float(), rtol=rtol, atol=0)
    L, C, _ = plan
    if lanes % (16 // itemsize) == 0:
        # aligned rows: every element moves in a 16-byte access, and a row
        # segment covers a 32-byte sector (a 16-byte half at bf16, C = 8)
        assert moved["edge"] == 0
        assert C * L * itemsize >= 32 or (C == 8 and C * L * itemsize >= 16)
    else:
        assert moved["edge"] > 0
    if (rows, lanes) == (35280, 128):
        assert plan == (1, 8, 512)
        assert _tall(rows, lanes, plan, itemsize, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, lanes", [(35280, 128), (1024, 128),
                                         (8192, 512), (37, 5), (35280, 130)])
def test_p1_card_plan_movement_equals_plain(rows, lanes, dtype):
    """The plan an H100 gets (15 clusters of 8 held at once, 30 of 4, 66 of
    2): 128 tall lanes in clusters of 2, the tall path on 8-byte (float32)
    and 4-byte (bfloat16) row segments."""
    x, idx = _p1_inputs(rows, lanes, dtype, rows * lanes)
    itemsize = x.element_size()
    held = {8: 15, 4: 30, 2: 66, 1: 132}.get
    plan = gather.launch_plan(rows, lanes, itemsize, SMS, held)
    total, tile, moved = _emulate_p1(x, idx, ITERS, plan)
    assert torch.equal(tile, gather.gather_iterate_plain(x, idx, ITERS)[1])
    if (rows, lanes) == (35280, 128):
        assert plan == (1, 2, 512)
        assert _tall(rows, lanes, plan, itemsize, True)


@pytest.mark.parametrize("rows, lanes", [(37, 5), (1000, 400)])
def test_p1_unaligned_pointers_take_narrow_accesses(rows, lanes):
    """Pointers off a 16-byte boundary: the kernel's vec flag is 0 and
    every element moves alone, still once each, to the same tile."""
    x, idx = _p1_inputs(rows, lanes, torch.float32, 7)
    plan = gather.launch_plan(rows, lanes, 4, SMS)
    total, tile, moved = _emulate_p1(x, idx, ITERS, plan, vec=False)
    assert moved["full"] == 0
    assert torch.equal(tile, gather.gather_iterate_plain(x, idx, ITERS)[1])


@pytest.mark.parametrize("ns", [1, 2, 3, 5, 7, 9, 13, 20, 75])
@pytest.mark.parametrize("step", [32, 64, 512, 1024])
def test_p1_walk_equals_division(step, ns):
    """GiWalk's carried (dr, sl) equal divmod(tid + m * step, ns)."""
    tid = np.arange(step)
    for m in range(6):
        dr, sl = _walk(tid, step, ns, m)
        w = tid + m * step
        assert np.array_equal(dr, w // ns) and np.array_equal(sl, w % ns)


def _emulate_p2(x, idx, axis, vec=True):
    """take_along.cu in numpy: blocks of 1,024 outputs, four a thread, the
    row walk across row ends, the axis-1 staging window (a staged element
    x[base + a] is read as x's own)."""
    rows, cols = x.shape
    n = rows * cols
    xf, kf = x.reshape(-1), idx.reshape(-1).numpy().astype(np.int64)
    staged = TA_BLOCK + 2 * cols + 4
    stage = axis == 1 and staged <= TA_STAGE_MAX
    i0 = np.arange(0, n, 4)  # one thread each
    b0 = i0 // TA_BLOCK * TA_BLOCK
    full = vec & (i0 + 4 <= n)
    assert full.sum() >= len(i0) - 1  # only the tile's last group is cut
    if stage:
        b1 = np.minimum(n, b0 + TA_BLOCK)
        z = ((b1 - 1) // cols + 1) * cols  # end of the block's last row
        base = (b0 // cols * cols) & ~3
        assert (base % 4 == 0).all() and (z <= n).all()
        assert (z - base <= staged).all()
    out = torch.zeros(n, dtype=x.dtype)
    written = np.zeros(n, np.int64)
    read = np.zeros(n, np.int64)
    r, c = i0 // cols, i0 % cols
    for v in range(4):
        e = i0 + v
        ok = e < n
        assert np.array_equal((r * cols + c)[ok], e[ok])
        k = kf[e[ok]]
        read += np.bincount(e[ok], minlength=n)
        if axis == 0:
            src = k * cols + c[ok]
        elif stage:
            at = r[ok] * cols + k - base[ok]
            assert (at >= 0).all() and (at < (z - base)[ok]).all()
            src = base[ok] + at
        else:
            src = r[ok] * cols + k
        out[torch.as_tensor(e[ok])] = xf[torch.as_tensor(src)]
        written += np.bincount(e[ok], minlength=n)
        c = c + 1
        wrap = c == cols
        c, r = np.where(wrap, 0, c), r + wrap
    assert (written == 1).all() and (read == 1).all()
    return out.reshape(rows, cols)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", [(8, 128), (1024, 128), (64, 256),
                                   (33, 70), (4096, 1024), (1, 1),
                                   (3, 7000)])
def test_p2_four_column_plan_equals_plain(shape, axis):
    rng = np.random.default_rng(shape[0] + shape[1] + axis)
    x = torch.as_tensor(rng.integers(-1000, 1000, shape), dtype=torch.int32)
    idx = torch.as_tensor(rng.integers(0, shape[axis], shape),
                          dtype=torch.int32)
    out = _emulate_p2(x, idx, axis)
    assert torch.equal(out, gather.take_along_plain(x, idx, axis))


def test_round_wavefronts_count_bank_conflicts():
    """The conflict-aware floor chip_smoke.py prints beside P1's round: a
    warp on one word or on 32 banks costs one wavefront to read, on 32
    words of one bank 32, and every warp one more to write."""
    rows = 64  # two warps of one lane column
    same = np.zeros((rows, 1), np.int64)
    spread = np.arange(rows)[:, None]
    one_bank = (np.arange(rows)[:, None] * 32) % rows
    assert gather_timing.round_wavefronts(same, 1, 4) == 2 * (1 + 1)
    assert gather_timing.round_wavefronts(spread, 1, 4) == 2 * (1 + 1)
    # rows 0 and 32 alternate: two distinct words, both in bank 0
    assert gather_timing.round_wavefronts(one_bank, 1, 4) == 2 * (2 + 1)
    # bf16: two elements a word, so 64 spread rows fill 32 banks once
    assert gather_timing.round_wavefronts(spread, 1, 2) == 2 * (1 + 1)
    big = (np.arange(1024)[:, None] * 32) % 1024  # 32 words in bank 0
    assert gather_timing.round_wavefronts(big, 1, 4) == 32 * (32 + 1)
    # the busiest block counts: lane 1 conflicts, lane 0 does not
    two = np.concatenate([np.arange(1024)[:, None], big], axis=1)
    assert gather_timing.round_wavefronts(two, 1, 4) == 32 * (32 + 1)
