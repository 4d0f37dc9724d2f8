"""Inputs that stress GO-HV's greedy search (``recognize/hv.py::hv_greedy``,
its kernel and its plain version ``_greedy_verify``): shapes on and off the
kernel's 32-point words and 16-byte loads, invalid hypotheses that would
win, ties, flips that only the outlier term decides, costs that meet the
1e-6 margin exactly, and a hypothesis switched on and later off. numpy
only: the CPU tests and the card tests build their inputs from these one
definitions.

Each case returns ``(explained bool[H, Ns], outliers float32[H], valid
bool[H])`` as ``_explained_matrix`` hands them to ``_select_hypotheses``;
:func:`prepare` masks them as ``_select_hypotheses`` does before the
search. The outliers are counts, as the search's exactness needs."""
import numpy as np

LAMBDA_OUT = 0.001      # DetectionConfig.hv_regularizer
LAMBDA_MULT = 1.0       # verify_hypotheses' multiple_assignment_penalty
SHAPES = [(H, Ns) for H in (17, 24, 48, 64) for Ns in (1000, 8192, 16384)]


def _rng(name, *k):
    return np.random.default_rng([sum(map(ord, name)), *k])


def prepare(explained, outliers, valid):
    """What the search takes: explained masked by validity, outliers inf
    on invalid hypotheses."""
    return (explained & valid[:, None],
            np.where(valid, outliers, np.inf).astype(np.float32), valid)


def _blocks(rng, Ns, sizes):
    """Disjoint random index sets of the given sizes (sum at most Ns)."""
    order = rng.permutation(Ns)
    ends = np.cumsum(sizes)
    return [order[e - n:e] for e, n in zip(ends, sizes)]


def union_dropped(ex, blocks):
    """Rows 0-2 of a search that switches hypothesis 0 on and later off,
    on the disjoint ``blocks`` A, B, C, D, E of 10, 10, 15, 15 and 8 units:
    h0 = A ∪ B ∪ E (28) is worth taking before h1 = A ∪ C and h2 = B ∪ D
    (25 each), each of these is worth taking after it (5 new units over 10
    doubly covered), and then dropping h0 saves |A| + |B| − |E| = 12."""
    A, B, C, D, E = blocks
    for h, parts in enumerate([(A, B, E), (A, C), (B, D)]):
        ex[h, np.concatenate(parts)] = True


def random_case(H, Ns, seed=0):
    """A scene of objects with, per object, hypotheses that match it, cover
    part of it, spill onto a neighbour or lie on clutter; some rows
    empty, about one in eight invalid (among them a copy of the largest
    row and its neighbour), outlier counts up to 3,000, and rows 0-2 the
    switched-off union of :func:`union_dropped` on a part of the scene no
    object shares."""
    rng = _rng("random", H, Ns, seed)
    u = max(1, Ns // 160)
    n_obj = max(2, H // 6)
    sizes = rng.integers(Ns // 60, Ns // 20, n_obj)
    blocks = _blocks(rng, Ns, [10 * u, 10 * u, 15 * u, 15 * u, 8 * u, *sizes])
    ex = np.zeros((H, Ns), bool)
    union_dropped(ex, blocks[:5])
    objs = blocks[5:]
    for h in range(3, H):
        kind = rng.integers(5)
        o = objs[rng.integers(n_obj)]
        if kind == 0:                          # the object
            ex[h, o] = True
        elif kind == 1:                        # part of it
            ex[h, o[rng.uniform(size=len(o)) < rng.uniform(0.5, 0.95)]] = True
        elif kind == 2:                        # it and part of another
            p = objs[rng.integers(n_obj)]
            ex[h, o] = True
            ex[h, p[: len(p) // 3]] = True
        elif kind == 3:                        # clutter
            ex[h] = rng.uniform(size=Ns) < 0.02
    outliers = rng.integers(0, 3000, H).astype(np.float32)
    outliers[:3] = rng.integers(0, 50, 3)
    valid = rng.uniform(size=H) >= 0.125
    valid[:3] = True
    big = int(np.argmax(ex.sum(1)))
    ex[H - 1], valid[H - 1] = ex[big] | ex[(big + 1) % H], False
    return ex, outliers, valid


def invalid_bit_ties():
    """The shape of ``tests/test_torch_hv.py``'s ``invalid_bit_ties`` set
    (H = 4, 512 lanes, 400 points): two halves of the joint, a copy off in
    clutter, the whole joint; hypothesis 1 (the second half) invalid, so
    every pattern with its bit set ties the pattern without it."""
    n, Ns = 400, 512
    ex = np.zeros((4, Ns), bool)
    ex[0, : n // 2] = True
    ex[1, n // 2: n] = True
    ex[3, :n] = True
    return (ex, np.array([3, 2, 400, 0], np.float32),
            np.array([True, False, True, True]))


def invalid_would_win(H=24, Ns=8192):
    """Half the hypotheses invalid, among them the three largest rows: the
    search must never take one, though each would lower the cost most."""
    rng = _rng("invalid", H, Ns)
    ex, outliers, _ = random_case(H, Ns, seed=1)
    rows = np.argsort(-ex.sum(1), kind="stable")
    valid = np.ones(H, bool)
    valid[rows[:3]] = False
    valid[rng.choice(rows[3:], H // 2 - 3, replace=False)] = False
    return ex, outliers, valid


def all_empty(H=24, Ns=8192):
    """No hypothesis explains a point: every flip costs its outliers, and
    nothing is ever taken."""
    rng = _rng("empty", H, Ns)
    return (np.zeros((H, Ns), bool),
            rng.integers(0, 3000, H).astype(np.float32), np.ones(H, bool))


def outliers_decide(H=20, Ns=1000):
    """Rows 3, 7 and 12 explain the same 300 points; only their outlier
    counts differ (12, 11, 11): λ_out·O alone picks row 7 over row 3, and
    the tie with row 12 goes to the lower index. Rows 14 and 15 are equal
    in everything: the first one is taken."""
    ex = np.zeros((H, Ns), bool)
    outliers = np.zeros(H, np.float32)
    pts = _rng("decide").permutation(Ns)
    for h, o in ((3, 12), (7, 11), (12, 11)):
        ex[h, pts[:300]] = True
        outliers[h] = o
    ex[14, pts[400:500]] = ex[15, pts[400:500]] = True
    outliers[14] = outliers[15] = 5
    return ex, outliers, np.ones(H, bool)


def margin_ties(H=18, Ns=1000):
    """Flips priced at the margin: one point explained at 1,000 outliers
    (−1 + 1.0 = 0 in float32, not below the empty set's 0), one at 999
    (−0.001, taken), one at 1,001 (+0.001). Once row 5 is on, row 2's flip
    costs −2 + 0.001·1999, which differs from the current −1 + 0.001·999
    only by float32 rounding."""
    ex = np.zeros((H, Ns), bool)
    outliers = np.zeros(H, np.float32)
    for h, point, o in ((2, 10, 1000), (5, 11, 999), (8, 13, 1001)):
        ex[h, point] = True
        outliers[h] = o
    return ex, outliers, np.ones(H, bool)


def cases():
    """{name: (explained, outliers, valid)}, every case above."""
    out = {f"random_H{H}_N{Ns}": random_case(H, Ns) for H, Ns in SHAPES}
    out.update(invalid_bit_ties=invalid_bit_ties(),
               invalid_would_win=invalid_would_win(), all_empty=all_empty(),
               outliers_decide=outliers_decide(), margin_ties=margin_ties())
    return out
