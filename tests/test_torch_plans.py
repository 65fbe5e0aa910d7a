"""The launch plans of the port's ``cp_k_steps`` and ``pg_k_steps`` kernels,
and CPU replays of how the kernels cut their work between the blocks of a
thread-block cluster.

The plans are host code, pure functions of the shape, so they are tested
here without a card.  The replays run the kernels' decomposition in numpy
or torch on the CPU (a band of rows per block with one-row halos exchanged
between the halves of a Chambolle-Pock step; a slab of rows of Q per block
with the iterate gathered from the others after each projected-gradient
step) and must give the plain versions' bits: the decomposition moves data,
it does not change the arithmetic of any cell or row.
"""

import numpy as np
import pytest
import torch

from proxtpu_torch.kernels import box_qp as tb
from proxtpu_torch.kernels import lasso as tl
from proxtpu_torch.kernels import tv

LIMIT = 232448  # bytes of shared memory a block may use on an H100
SMS = 132

# (B, H, W) -> (variant, C, threads) on an H100
_CP_PLANS = {
    (64, 64, 64): ("cluster", 1, 1024),     # route (e): one block holds it
    (64, 256, 256): ("cluster", 16, 512),   # route (f): two blocks an SM
    (7, 33, 21): ("cluster", 1, 1024),      # ragged, one block
    (4, 16, 24): ("cluster", 1, 512),       # the reference's test shape
    (3, 301, 203): ("cluster", 8, 1024),    # ragged, a cluster
    (2, 40, 1500): ("cluster", 8, 1024),    # rows wider than a block
    (4, 50, 1000): ("cluster", 16, 1024),   # 16 blocks of 3 or 4 rows
    (4, 1000, 91): ("cluster", 16, 1024),   # 16 blocks of 63 rows
    (2, 512, 512): ("halo", 0, 1024),       # no cluster holds it
}


@pytest.mark.parametrize("shape", list(_CP_PLANS))
def test_cp_plan_of_known_shapes(shape):
    plan = tv.cp_plan(*shape, 8, SMS, LIMIT)
    assert (plan.variant, plan.C, plan.threads) == _CP_PLANS[shape]
    assert tv.cached_cp_plan(*shape, 8, SMS, LIMIT) == plan


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("B", [1, 7, 64, 256])
def test_cp_plan_bands_fit(B, K):
    """Every band fits a block's shared memory with room for the static
    scratch; the cluster variant is taken wherever some C <= 16 holds the
    image; the halo variant's tile and halo fit as tile_plan promises."""
    for H in (1, 5, 16, 33, 64, 100, 256, 301, 512, 1000):
        for W in (1, 21, 64, 91, 256, 512, 1000, 1500):
            plan = tv.cp_plan(B, H, W, K, SMS, LIMIT)
            assert plan.smem <= LIMIT - 1024, (B, H, W, plan)
            held = [C for C in range(1, min(H, 16) + 1)
                    if tv.cp_band_bytes(H, W, C) is not None
                    and tv.cp_band_bytes(H, W, C) <= LIMIT - 1024]
            if plan.variant == "cluster":
                assert plan.C in held and plan.threads in tv.CP_THREADS
                assert plan.smem == tv.cp_band_bytes(H, W, plan.C)
            else:
                assert not held
                assert (plan.TH, plan.TW) == tv.tile_plan(H, W, K, LIMIT)


def test_cp_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no room"):
        tv.cp_plan(1, 4096, 4096, 60, SMS, LIMIT)


def test_cp_band_bytes():
    # five planes at the least spacing that holds ceil(H / C) rows of W
    # rounded up to 32, two guards
    assert tv.cp_band_bytes(256, 256, 16) == 20 * 4096 + 32
    assert tv.cp_band_bytes(256, 256, 15) == 20 * 8192 + 32
    assert tv.cp_band_bytes(33, 21, 4) == 20 * 1024 + 32
    assert tv.cp_band_bytes(256, 256, 5) is None


def _band_rows(H, C):
    return [(c * H // C, (c + 1) * H // C) for c in range(C)]


def _replay_bands(b, x, yx, yy, g1, g2, lam, K, C):
    """K Chambolle-Pock steps of one image, cut into C bands of rows as the
    cluster kernel cuts it: each band computes its own cells only; after
    the primal half it gets mid's first row of the band below, after the
    dual half yx's last row of the band above, and nothing else crosses.
    In torch on the CPU, as the plain version (whose CPU square root is not
    numpy's to the last bit)."""
    H, W = b.shape
    zero = torch.zeros((), dtype=b.dtype)
    bands = [dict(lo=lo, hi=hi, b=b[lo:hi], x=x[lo:hi], yx=yx[lo:hi],
                  yy=yy[lo:hi]) for lo, hi in _band_rows(H, C)]
    for _ in range(K):
        for k, d in enumerate(bands):  # the primal half
            rows = torch.arange(d["lo"], d["hi"])[:, None]
            above = bands[k - 1]["yx"][-1:] if k > 0 else torch.zeros(1, W)
            dxm = torch.where(rows < H - 1, d["yx"], zero)
            up = torch.cat([above, d["yx"][:-1]])
            left = torch.cat([torch.zeros(d["yy"].shape[0], 1),
                              d["yy"][:, :-1]], dim=1)
            dym = torch.cat([d["yy"][:, :-1],
                             torch.zeros(d["yy"].shape[0], 1)], dim=1)
            t = d["x"] + g1 * ((dxm - up) + (dym - left))
            d["xbar"] = (t + g1 * d["b"]) / (1 + g1)
            d["mid"] = 2 * d["xbar"] - d["x"]
        for k, d in enumerate(bands):  # the dual half
            rows = torch.arange(d["lo"], d["hi"])[:, None]
            below = bands[k + 1]["mid"][:1] if k + 1 < C else torch.zeros(1, W)
            nxt = torch.cat([d["mid"][1:], below])
            gx = torch.where(rows < H - 1, nxt - d["mid"], zero)
            gy = torch.cat([d["mid"][:, 1:] - d["mid"][:, :-1],
                            torch.zeros(d["mid"].shape[0], 1)], dim=1)
            vx, vy = d["yx"] + g2 * gx, d["yy"] + g2 * gy
            nrm = torch.sqrt(vx * vx + vy * vy)
            scale = torch.where(nrm > lam, lam / torch.clamp(nrm, min=1e-30),
                                torch.ones_like(nrm))
            d["new"] = (d["xbar"], vx * scale, vy * scale)
        for d in bands:
            d["x"], d["yx"], d["yy"] = d.pop("new")
    return [torch.cat([d[k] for d in bands]) for k in ("x", "yx", "yy")]


@pytest.mark.parametrize("C", [1, 2, 3, 5])
@pytest.mark.parametrize("K", [1, 4])
def test_bands_with_one_row_halos_reproduce_the_image(C, K):
    """The cluster kernel's decomposition, replayed on the CPU on an odd
    image: C bands, one-row halos exchanged after each half-step, give the
    plain version's bits."""
    rng = np.random.default_rng(11)
    Bt, Ht, Wt = 2, 23, 17
    b, x = (torch.tensor(rng.standard_normal((Bt, Ht, Wt))
                         .astype(np.float32)) for _ in range(2))
    yx, yy = (torch.tensor((0.1 * rng.standard_normal((Bt, Ht, Wt)))
                           .astype(np.float32)) for _ in range(2))
    g1, g2 = (torch.tensor(v, dtype=torch.float32)
              for v in tv.default_tv_stepsizes())
    lam = torch.tensor([0.12, 0.05])
    want = tv.reference_cp_k_steps(b, x, yx, yy, g1.expand(Bt),
                                   g2.expand(Bt), lam, K=K)
    for i in range(Bt):
        got = _replay_bands(b[i], x[i], yx[i], yy[i], g1, g2, lam[i], K, C)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w[i].numpy())


# (B, n) -> (C, R, S) on an H100
_PG_PLANS = {
    (64, 512): (2, 32, 3),     # route (b): 128 blocks on 132 SMs
    (256, 128): (1, 128, 3),   # more lanes than SMs
    (7, 161): (1, 101, 3),     # slabs of 80 rows would be too short
    (6, 16): (1, 16, 3),       # the reference's test shape
    (2, 20000): (1, 8, 0),     # no three one-row stages fit: tiles in place
}


@pytest.mark.parametrize("shape", list(_PG_PLANS))
def test_pg_plan_of_known_shapes(shape):
    plan = tb.pg_plan(*shape, SMS, LIMIT)
    assert plan == _PG_PLANS[shape]
    assert tb.cached_pg_plan(*shape, SMS, LIMIT) == plan
    n = shape[1]
    assert tb.pg_shared_bytes(n, n, *plan) <= LIMIT


def test_pg_plan_keeps_the_kernels_shared_memory():
    """A ring wherever three one-row stages fit; in place, one block per
    lane, up to the n the kernel took before it had a ring (x and g of n
    floats each); every plan within the limit and its stages under the bulk
    copy's 1 MB."""
    for n in (1, 13, 128, 512, 1000, 4096, 9000, 20000, 29056):
        for B in (1, 7, 64, 256):
            C, R, S = tb.pg_plan(B, n, SMS, LIMIT)
            assert tb.pg_shared_bytes(n, n, C, R, S) <= LIMIT, (B, n)
            ring = tb.pg_shared_bytes(n, n, C, 1, 3) <= LIMIT
            assert (S == 3) == ring and (S == 3 or C == 1)
            assert R * n * 4 < 1 << 20
            assert C == 1 or n // C >= tb.PG_MIN_SLAB_ROWS
    assert tb.pg_shared_bytes(29056, 29056, 1, 8, 0) == 8 * 29056 <= LIMIT


def _replay_slabs(Q, q, x, gamma, lo, hi, done, K, C):
    """K projected-gradient steps as a cluster of C blocks per lane runs
    them: block c keeps its own copy of x in two buffers (by step parity),
    updates the rows [c n / C, (c + 1) n / C) of the other buffer from its
    own copy, then copies the other blocks' rows from their buffers; res is
    the max of the blocks' maxima; a frozen lane is left alone.  The
    gradient of a row is the plain version's, so only the data flow is on
    trial."""
    B, n = q.shape
    slabs = [(c * n // C, (c + 1) * n // C) for c in range(C)]
    bufs = [[x.clone(), torch.empty_like(x)] for _ in range(C)]
    res = torch.zeros(B)
    for step in range(K):
        cur, nxt = step % 2, (step + 1) % 2
        maxima = []
        for c, (a, e) in enumerate(slabs):
            xc = bufs[c][cur]
            g = torch.bmm(Q, xc.unsqueeze(2)).squeeze(2)[:, a:e] + q[:, a:e]
            y = xc[:, a:e] - gamma[:, None] * g
            z = torch.clamp(y, lo[:, None], hi[:, None])
            maxima.append(torch.amax(torch.abs(xc[:, a:e] - z), dim=1))
            bufs[c][nxt][:, a:e] = z
        for c in range(C):  # after the cluster barrier
            for o, (a, e) in enumerate(slabs):
                if o != c:
                    bufs[c][nxt][:, a:e] = bufs[o][nxt][:, a:e]
        res = torch.stack(maxima).amax(dim=0)
    out = torch.cat([bufs[c][K % 2][:, a:e] for c, (a, e) in
                     enumerate(slabs)], dim=1)
    frozen = done != 0
    return (torch.where(frozen[:, None], x, out),
            torch.where(frozen, torch.zeros_like(res), res))


@pytest.mark.parametrize("C", [1, 2, 3, 5])
@pytest.mark.parametrize("K", [1, 8])
def test_slabs_reproduce_the_pg_steps(C, K):
    rng = np.random.default_rng(5)
    B, n = 6, 37
    G = rng.standard_normal((B, n, n))
    Q = torch.tensor(((G + G.transpose(0, 2, 1)) / (2 * np.sqrt(2 * n)))
                     .astype(np.float32))
    q = torch.tensor(rng.standard_normal((B, n)).astype(np.float32))
    x = torch.tensor(rng.uniform(-1, 1, (B, n)).astype(np.float32))
    gamma = torch.full((B,), 0.9)
    lo, hi = torch.full((B,), -1.0), torch.full((B,), 1.0)
    done = torch.tensor([0, 1, 0, 0, 1, 0], dtype=torch.float32)
    want = tb.reference_pg_box_k_steps(Q, q, x, gamma, lo, hi, done, K)
    got = _replay_slabs(Q, q, x, gamma, lo, hi, done, K, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# The plan of the bfloat16-A instance of fb_step and fista_step on an H100:
# (threads, rows per tile, stages, shared bytes, columns a thread in pass 2,
# x in registers in pass 1) at 2 bytes an entry of A, one shape per branch,
# and the way the kernel fills the ring (bulk copy where N * 2 is a
# multiple of 16).
_BF16_PLANS = {
    (256, 200, 400): ((512, 40, 3, 100120, 2, 1), "bulk"),  # route (h)
    (64, 200, 400): ((512, 68, 3, 167320, 2, 1), "bulk"),   # one per SM
    (5, 300, 250): ((512, 100, 3, 153496, 2, 1), "loads"),  # N * 2 % 16
    (1024, 64, 128): ((256, 64, 1, 17672, 2, 1), "bulk"),   # one stage
    (7, 33, 161): ((256, 33, 1, 12296, 1, 1), "loads"),     # ragged, N odd
    (2, 24, 12000): ((1024, 1, 3, 168344, 2, 0), "bulk"),   # f32: in place
    (2, 24, 20000): ((256, 24, 0, 80096, 1, 0), "none"),    # in place
    (9, 300, 251): ((512, 100, 3, 154264, 1, 1), "loads"),  # a ring, N odd
    (16, 200, 520): ((1024, 52, 3, 167448, 2, 0), "bulk"),  # x too wide
}


@pytest.mark.parametrize("shape", list(_BF16_PLANS))
def test_step_plan_bf16_branches(shape):
    plan, fill = _BF16_PLANS[shape]
    assert tl.step_plan(*shape, SMS, LIMIT, elem=2) == plan
    assert tl.cached_step_plan(*shape, SMS, LIMIT, 2) == plan
    threads, R, S, nbytes, cols, xregs = plan
    assert tl.step_shared_bytes(*shape[1:], R, S, 2) == nbytes
    N = shape[2]
    assert fill == ("none" if S == 0 else
                    "bulk" if N * 2 % 16 == 0 else "loads")
    assert (cols, xregs) == tl.bf16_fields(N, threads, S)


# The float32 plan (threads, rows per tile, stages, shared bytes) on an H100
# at the shapes of _BF16_PLANS and of tests/test_torch_lasso.py's
# _STEP_PLANS: what the shared planner gave it before the bf16 instances had
# a rule of their own, and must go on giving it.
_F32_PLANS = {
    (256, 200, 400): (512, 16, 3, 80920),
    (64, 200, 400): (512, 29, 3, 143512),
    (5, 300, 250): (512, 60, 3, 183448),
    (1024, 64, 128): (256, 64, 1, 34056),
    (7, 33, 161): (256, 33, 1, 22920),
    (2, 24, 12000): (256, 24, 0, 48096),
    (2, 24, 20000): (256, 24, 0, 80096),
    (9, 300, 251): (512, 60, 3, 184216),
    (16, 200, 520): (1024, 29, 3, 186264),
    (256, 400, 200): (512, 31, 3, 77720),
    (64, 512, 1024): (1024, 16, 3, 206872),
}


@pytest.mark.parametrize("shape", list(_F32_PLANS))
def test_step_plan_float32_keeps_its_values(shape):
    assert tl.step_plan(*shape, SMS, LIMIT) == _F32_PLANS[shape]
    assert tl.step_plan(*shape, SMS, LIMIT, elem=4) == _F32_PLANS[shape]
    assert tl._step_plan(*shape, SMS, LIMIT, 4) == _F32_PLANS[shape]


@pytest.mark.parametrize("N, threads, S, fields", [
    (400, 512, 3, (2, 1)),     # route (h): both narrow passes
    (251, 512, 3, (1, 1)),     # N odd: one column a thread in pass 2
    (161, 256, 1, (1, 1)),     # one stage, N odd
    (512, 512, 3, (2, 1)),     # the widest x in registers
    (520, 1024, 3, (2, 0)),    # x too wide for registers: shared memory
    (12000, 1024, 3, (2, 0)),
    (400, 1024, 3, (2, 0)),    # a block of 1024 keeps x in shared memory
    (20000, 256, 0, (1, 0)),   # in place: neither
    (20001, 256, 0, (1, 0)),
])
def test_bf16_fields_and_where_each_falls_back(N, threads, S, fields):
    assert tl.bf16_fields(N, threads, S) == fields


def test_bf16_pairs_split_into_their_columns():
    """Pass 2 of the bf16 instances reads two adjacent entries of a row as
    one 32-bit word: column n in its low half, n + 1 in its high half, each
    made a float by moving its bits to the top 16 (common.cuh: bf16_lo,
    bf16_hi).  Replayed on the CPU, the halves are the bf16 values cast up,
    NaN, infinities and subnormals included."""
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.standard_normal((5, 12)).astype(np.float32))
    A[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             1e-39])
    A16 = A.to(torch.bfloat16)
    words = A16.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    w = words[:, 0::2] | (words[:, 1::2] << 16)
    lo = (w << 16).astype(np.uint32).view(np.float32)
    hi = (w & 0xFFFF0000).astype(np.uint32).view(np.float32)
    want = A16.float().numpy()
    np.testing.assert_array_equal(lo, want[:, 0::2])
    np.testing.assert_array_equal(hi, want[:, 1::2])


def _step_layout_bytes(M, N, R, S, elem):
    """StepLayout of csrc/lasso_step.cuh at ``elem`` bytes an entry of A,
    written out once more."""
    if S == 0:
        return 4 * (N + M)
    fixed = 4 * (2 * (-(-N // 4) * 4) + -(-M // 4) * 4)
    return (-(-fixed // 128) * 128 + S * (-(-elem * R * N // 128) * 128)
            + 8 * S)


def test_step_plan_bf16_fits_and_halves_the_stages():
    """At 2 bytes an entry every plan's bytes are the layout's sum and fit
    a block; a tile of the bf16 plan holds at least as many rows as the
    float32 plan's, a multiple of 4 or the most that fit; a float32 lane in
    place may take a ring; the pass choices follow bf16_fields."""
    for N in (24, 128, 161, 250, 400, 1024, 4096, 12000, 20000):
        for M in (1, 16, 33, 200, 400):
            if M * N * 4 >= 1 << 20:
                continue
            for B in (1, 64, 256):
                f32 = tl.step_plan(B, M, N, SMS, LIMIT)
                bf16 = tl.step_plan(B, M, N, SMS, LIMIT, elem=2)
                threads, R, S, used, cols, xregs = bf16
                assert used == _step_layout_bytes(M, N, R, S, 2)
                assert used + 512 <= LIMIT and 1 <= R <= M
                assert S == 0 or R * N * 2 < 1 << 20
                if f32[2] == 3 and S == 3:
                    assert R >= f32[1]
                if S == 3 and R % 4:
                    # the most rows that fit: one more row would not
                    per_sm = LIMIT + 1024
                    budget = per_sm // (2 if B > SMS else 1) - 1536
                    wider = tl.step_shared_bytes(M, N, R + 1, 3, 2)
                    assert R == M or wider > budget or (
                        (R + 1) * N * 2 > 64 * 1024)
                if f32[2] == 0:
                    assert S in (0, 3)
                assert (cols, xregs) == tl.bf16_fields(N, threads, S)
