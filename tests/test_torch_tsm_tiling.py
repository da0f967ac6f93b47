"""The padded plan of K3's and K12's tiles at the T, S and M presets'
head widths 8, 12 and 20, emulated in numpy: what the card tests cannot
reach here.

The plan (``sepreformer_torch/csrc/softmax_pv_tile.cuh`` and
``flash_relpos_tile.cuh``): the products run at Dp = 8 ceil(D / 8) with
Dp / 8 output n-fragments; a row's D floats are staged in D / 4 16-byte
pieces by a loop over the stage's pieces; the columns D .. Dp - 1 of
every staged row are zeroed once; the output's columns past D are not
stored.  K3 stages V in the layout of width 16 or 32 (stride 20 or 36,
the columns of rows with bit 3 set stored XOR 8); K12 stages K and the
band at stride 8 or 24 and V at Dp + 4, and its k-step kk takes
columns 8 kk + 2t and 8 kk + 2t + 1 in slots t and t + 4.

The shapes' constants are evaluated from the headers' own ``Shape``
structs (a small evaluator of their constant expressions), so the
emulation cannot drift from the source.  Each test replays the tile's
indexing on a stage buffer that starts as NaN: a read of a location no
copy or pad wrote shows as NaN in the result.  The emulated products
(3xTF32 m16n8k8, each term exact, summed in float64) must match float64
within 1e-6 of max|out|, every staged piece must land once, 16-byte
aligned in shared and in global memory, and the fragments' reads must
fall in distinct banks (per warp for 4-byte reads, per half-warp for
8-byte ones).  Base's and Large's widths keep their constants.
"""

import pathlib
import re

import numpy as np
import pytest

CSRC = pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch"
CSRC = CSRC / "csrc"
SOFTMAX = (CSRC / "softmax_pv_tile.cuh").read_text()
FLASH = (CSRC / "flash_relpos_tile.cuh").read_text()
TSM_WIDTHS = (8, 12, 20)

# --- the headers' constant expressions ------------------------------------

_TOKEN = re.compile(
    r"\s*(\d+|[A-Za-z_]\w*|<=|>=|==|!=|&&|\|\||[-+*/%()<>?:!])")
_BINARY = {"||": (2, lambda a, b: int(bool(a) or bool(b))),
           "&&": (3, lambda a, b: int(bool(a) and bool(b))),
           "==": (4, lambda a, b: int(a == b)),
           "!=": (4, lambda a, b: int(a != b)),
           "<": (5, lambda a, b: int(a < b)),
           "<=": (5, lambda a, b: int(a <= b)),
           ">": (5, lambda a, b: int(a > b)),
           ">=": (5, lambda a, b: int(a >= b)),
           "+": (6, lambda a, b: a + b), "-": (6, lambda a, b: a - b),
           "*": (7, lambda a, b: a * b), "/": (7, lambda a, b: a // b),
           "%": (7, lambda a, b: a % b)}


def evaluate(expr, env):
    """A C constant expression of non-negative integers (ternaries,
    comparisons, logic, arithmetic, ``sizeof(float)``, casts)."""
    expr = expr.replace("sizeof(float)", "4")
    expr = re.sub(r"\((?:size_t|int)\)", "", expr)
    tokens = _TOKEN.findall(expr)
    assert "".join(tokens) == re.sub(r"\s", "", expr), expr
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def take():
        pos[0] += 1
        return tokens[pos[0] - 1]

    def atom():
        tok = take()
        if tok == "(":
            value = parse(0)
            assert take() == ")"
            return value
        if tok == "!":
            return int(not atom())
        if tok == "-":
            return -atom()
        if tok.isdigit():
            return int(tok)
        return int(env[tok])

    def parse(min_prec):
        left = atom()
        while True:
            op = peek()
            if op == "?" and min_prec <= 1:
                take()
                yes = parse(0)
                assert take() == ":"
                no = parse(1)
                left = yes if left else no
            elif op in _BINARY and _BINARY[op][0] >= min_prec:
                prec, fn = _BINARY[take()]
                left = fn(left, parse(prec + 1))
            else:
                return left

    value = parse(0)
    assert pos[0] == len(tokens), expr
    return value


def declare(env, declaration):
    """Evaluate ``"a = 1, b = a + 1"`` (one or more declarators) into
    ``env``."""
    parts = re.split(r",\s*(\w+)\s*=\s*", declaration)
    first, expr = parts[0].split("=", 1)
    env[first.strip()] = evaluate(expr, env)
    for name, value in zip(parts[1::2], parts[2::2]):
        env[name] = evaluate(value, env)


def namespace_constants(source):
    """The header's namespace-level ``constexpr int`` constants."""
    env = {}
    for declaration in re.findall(r"^constexpr int ([^;]+);", source, re.M):
        declare(env, declaration)
    return env


def shape(source, split, d):
    """``Shape<SPLIT, D>``'s constants, evaluated in the struct's order."""
    body = source[source.index("struct Shape {"):]
    body = body[:body.index("\n};")]
    env = dict(namespace_constants(source), SPLIT=split, D=d)
    for declaration in re.findall(
            r"static constexpr (?:int|bool|size_t) ([^;]+);", body):
        declare(env, declaration)
    return env


# --- 3xTF32 products, as tests/test_torch_tf32x3.py takes them -----------

def to_tf32(x):
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def toward_zero(x):
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def mma3(a, b, terms=3):
    """A [16, 8] · B [8, n] as mma3's three exact terms in float64 (or one
    TF32 term)."""
    ab, bb = to_tf32(a), to_tf32(b)
    pairs = [(ab, bb)]
    if terms == 3:
        pairs = [(toward_zero(a - ab), bb), (ab, toward_zero(b - bb))] + pairs
    return sum(x.astype(np.float64) @ y.astype(np.float64) for x, y in pairs)


LANES = np.arange(32)
G, TQ = LANES >> 2, LANES & 3          # g = lane / 4, t = lane % 4


def distinct_banks(addresses, width=1):
    """Whether word addresses (per lane) of a ``width``-word load fall in
    distinct banks: per warp for 4-byte loads, per half-warp for 8-byte
    ones."""
    groups = [addresses] if width == 1 else [addresses[:16], addresses[16:]]
    for group in groups:
        banks = [(a + w) % 32 for a in group for w in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


# --- K3: V's staging and P·V --------------------------------------------

K3 = namespace_constants(SOFTMAX)


def key_of(nt, e, t):
    return 16 * (nt >> 1) + 4 * t + 2 * (nt & 1) + (e & 1)


def k3_stage(s, v_rows, d):
    """One V stage as the padded plan fills it: (buffer, writes per
    location, pieces per thread).  ``v_rows`` [kStepKeys, d]."""
    vs, keys, threads = s["kVS"], s["kStepKeys"], K3["kThreads"]
    buf = np.full(keys * vs, np.nan, np.float32)
    writes = np.zeros(keys * vs, np.int32)
    for r in range(keys):                       # the pad, once
        if d < s["kDp"]:
            at = r * vs + (d ^ (r & 8))
            assert at % 4 == 0
            buf[at:at + 4] = 0.0
            writes[at:at + 4] += 1
    per_thread = np.zeros(threads, np.int32)
    per_row = s["kPerRow"]
    for e in range(keys * per_row):
        tid = e % threads
        per_thread[tid] += 1
        r, c = e // per_row, 4 * (e % per_row)
        at = r * vs + (c ^ (r & 8))
        assert at % 4 == 0 and c + 4 <= d
        buf[at:at + 4] = v_rows[r, c:c + 4]
        writes[at:at + 4] += 1
    return buf, writes, per_thread


@pytest.mark.parametrize("d", [16, 32])
def test_k3_base_and_large_plans_keep_their_constants(d):
    for split in (1, 2):
        s = shape(SOFTMAX, split, d)
        assert s["kExact"] == 1
        assert (s["kNN"], s["kVS"], s["kChains"]) == (
            d // 8, d + 4, 2 if d == 16 else 1)
        assert s["kPieces"] * K3["kThreads"] * 4 == s["kStepKeys"] * d


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("d", TSM_WIDTHS)
def test_k3_stage_lands_every_piece_once(d, split):
    s = shape(SOFTMAX, split, d)
    dp = -(-d // 8) * 8
    assert (s["kExact"], s["kDp"], s["kNN"]) == (0, dp, dp // 8)
    assert s["kVS"] == (20 if dp <= 16 else 36)
    rows = np.arange(s["kStepKeys"] * d, dtype=np.float32).reshape(-1, d)
    buf, writes, per_thread = k3_stage(s, rows, d)
    assert writes.max() == 1
    assert per_thread.max() - per_thread.min() <= 1
    # each row's D columns and its pad, inside the row's stride
    for r in range(s["kStepKeys"]):
        row = buf[r * s["kVS"]:(r + 1) * s["kVS"]]
        assert np.isfinite(row).sum() == dp
    # every head's slice of V starts 16-byte aligned in global memory
    assert all((h * d) % 4 == 0 for h in range(8))
    # the static shared memory of the two stages
    assert 2 * s["kStage"] * 4 <= 48 * 1024


@pytest.mark.parametrize("d", TSM_WIDTHS)
def test_k3_fragments_read_the_right_columns_in_distinct_banks(d):
    s = shape(SOFTMAX, 1, d)
    vs = s["kVS"]
    for nt in range(8):
        for nn in range(s["kNN"]):
            for e in range(2):
                rows = key_of(nt, e, TQ)
                # the tile's read: column g + 8 (nn ^ t / 2) of the row
                at = rows * vs + 8 * (nn ^ (TQ >> 1)) + G
                # where the stage put logical column 8 nn + g of that row
                assert np.array_equal(at, rows * vs + ((8 * nn + G)
                                                       ^ (rows & 8)))
                assert distinct_banks(at)


@pytest.mark.parametrize("d", TSM_WIDTHS)
def test_k3_pv_matches_float64(d):
    """A key tile's P·V for the 16 rows of a warp tile through the staged
    layout and the fragments: the stored columns match float64, none of
    them reads a location that was not written."""
    s = shape(SOFTMAX, 1, d)
    rng = np.random.default_rng(d)
    v = rng.normal(size=(s["kStepKeys"], d)).astype(np.float32)
    p = rng.random(size=(16, K3["kKeys"])).astype(np.float32)
    buf, _, _ = k3_stage(s, v, d)
    vs = s["kVS"]
    out = np.zeros((16, 8 * s["kNN"]))
    for nt in range(8):
        # A: the k-step's keys key_of(nt, 0, t) in slot t, key_of(nt, 1,
        # t) in slot t + 4 (P's C fragment reused)
        keys = [key_of(nt, e, t) for e in range(2) for t in range(4)]
        a = p[:, keys]
        for nn in range(s["kNN"]):
            b = np.zeros((8, 8), np.float32)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(2):
                    row = key_of(nt, e, t)
                    b[4 * e + t, g] = buf[row * vs + 8 * (nn ^ (t >> 1)) + g]
            out[:, 8 * nn:8 * nn + 8] += mma3(a, b)
    stored = out[:, :d]                       # columns 8 nn + 2t < D
    ref = p.astype(np.float64) @ v.astype(np.float64)[:K3["kKeys"]]
    assert np.isfinite(stored).all()
    assert np.abs(stored - ref).max() <= 1e-6 * np.abs(ref).max()
    # the padding columns read the zeroed pad
    assert np.isfinite(out).all()
    assert np.abs(out[:, d:]).max(initial=0.0) == 0.0


# --- K12: K, V and the band staged, QKᵀ, Q·bandᵀ and P·V -----------------

K12 = namespace_constants(FLASH)


@pytest.mark.parametrize("d", [16, 32])
def test_k12_base_and_large_plans_keep_their_constants(d):
    for split in (1, 2, 4):
        s = shape(FLASH, split, d)
        assert s["kExact"] == 1
        assert (s["kKS"], s["kVS"], s["kNN"], s["kChains"]) == (
            16 if d == 16 else 36, d + 4, d // 8, 2 if d == 16 else 1)
    # K12's instances: four blocks per SM at 16, two at 32
    assert shape(FLASH, 1, d)["kMinBlocks"] == (4 if d == 16 else 2)


def k12_stage(s, k_rows, v_rows, band_rows, d):
    """One K12 stage as the padded plan fills it (K, V and band regions,
    their pads), NaN where nothing wrote."""
    ks, vs, keys, band = s["kKS"], s["kVS"], s["kStepKeys"], s["kBand"]
    buf = np.full(s["kStage"], np.nan, np.float32)
    writes = np.zeros(s["kStage"], np.int32)
    regions = [(0, ks, k_rows), (keys * ks, vs, v_rows),
               (keys * (ks + vs), ks, band_rows)]
    for base, stride, rows in regions:
        assert base % 4 == 0 and stride % 4 == 0
        for r in range(len(rows)):
            if d < s["kDp"]:                      # the pad, once
                at = base + r * stride + d
                buf[at:at + 4] = 0.0
                writes[at:at + 4] += 1
        per = d // 4
        for e in range(len(rows) * per):          # the pieces
            r, c = e // per, 4 * (e % per)
            at = base + r * stride + c
            buf[at:at + 4] = rows[r, c:c + 4]
            writes[at:at + 4] += 1
    return buf, writes


@pytest.mark.parametrize("d", TSM_WIDTHS)
def test_k12_plan_fits_and_stages_every_piece_once(d):
    s = shape(FLASH, 1, d)
    dp = -(-d // 8) * 8
    assert (s["kExact"], s["kDp"], s["kNN"]) == (0, dp, dp // 8)
    assert s["kKS"] % 32 in (8, 24) and s["kKS"] >= dp
    assert s["kVS"] == dp + 4 and (2 * s["kVS"]) % 32 in (8, 24)
    assert s["kSmemBytes"] <= 227 * 1024 and s["kMinBlocks"] >= 1
    assert s["kStages"] == 2
    rng = np.random.default_rng(d)
    k, v, band = (rng.normal(size=(n, d)).astype(np.float32)
                  for n in (s["kStepKeys"], s["kStepKeys"], s["kBand"]))
    _, writes = k12_stage(s, k, v, band, d)
    assert writes.max() == 1
    # every head's rows and every table row start 16-byte aligned
    assert all((h * d) % 4 == 0 for h in range(8)) and d % 4 == 0


@pytest.mark.parametrize("d", TSM_WIDTHS)
def test_k12_fragment_loads_fall_in_distinct_banks(d):
    s = shape(FLASH, 1, d)
    ks, vs = s["kKS"], s["kVS"]
    for kk in range(s["kNN"]):
        for nt in range(8):       # K's rows 8nt + g, columns 8kk + 2t, +1
            at = (8 * nt + G) * ks + 8 * kk + 2 * TQ
            assert distinct_banks(at, width=2) and (at % 2 == 0).all()
    for nt in range(8):           # V's rows 8nt + 2t (+1), column g + 8nn
        for nn in range(s["kNN"]):
            for e in range(2):
                assert distinct_banks((8 * nt + 2 * TQ + e) * vs + 8 * nn + G)


def q_fragments(q, d, nk):
    """Q [16, d] as the lanes hold it: k-step kk's A [16, 8], slot t the
    column 8 kk + 2t, slot t + 4 the column 8 kk + 2t + 1 (zero past d)."""
    frags = []
    for kk in range(nk):
        a = np.zeros((16, 8), np.float32)
        for t in range(4):
            for e in range(2):
                c = 8 * kk + 2 * t + e
                if c < d:
                    a[:, t + 4 * e] = q[:, c]
        frags.append(a)
    return frags


def b_rows(buf, base, stride, nk, kk, rows):
    """B [8, 8] of k-step kk over 8 staged rows: the lanes' 8-byte loads
    at row g, columns 8 kk + 2t and 8 kk + 2t + 1 (slots t, t + 4)."""
    b = np.zeros((8, 8), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        at = base + (rows + g) * stride + 8 * kk + 2 * t
        b[t, g], b[t + 4, g] = buf[at], buf[at + 1]
    return b


@pytest.mark.parametrize("d", TSM_WIDTHS)
def test_k12_products_match_float64(d):
    """One key tile of one warp tile through the staged layout: QKᵀ and
    Q·bandᵀ over the padded k, P·V over the padded n-fragments; the
    stored values match float64, and one TF32 term misses."""
    s = shape(FLASH, 1, d)
    ks, vs, keys = s["kKS"], s["kVS"], s["kStepKeys"]
    rng = np.random.default_rng(d + 1)
    q = rng.normal(size=(16, d)).astype(np.float32)
    k, v, band = (rng.normal(size=(n, d)).astype(np.float32)
                  for n in (keys, keys, s["kBand"]))
    p = rng.random(size=(16, K12["kKeys"])).astype(np.float32)
    buf, _ = k12_stage(s, k, v, band, d)
    qa = q_fragments(q, d, s["kNN"])
    scores = np.zeros((16, K12["kKeys"]))
    scores1 = np.zeros_like(scores)
    for nt in range(8):
        for kk in range(s["kNN"]):
            b = b_rows(buf, 0, ks, s["kNN"], kk, 8 * nt)
            scores[:, 8 * nt:8 * nt + 8] += mma3(qa[kk], b)
            scores1[:, 8 * nt:8 * nt + 8] += mma3(qa[kk], b, terms=1)
    ref = q.astype(np.float64) @ k.astype(np.float64)[:K12["kKeys"]].T
    assert np.isfinite(scores).all()
    assert np.abs(scores - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(scores1 - ref).max() > 1e-4 * np.abs(ref).max()
    bias = np.zeros((16, K12["kWarpBand"]))
    base = keys * (ks + vs)
    for m in range(K12["kWarpBand"] // 8):
        for kk in range(s["kNN"]):
            bias[:, 8 * m:8 * m + 8] += mma3(
                qa[kk], b_rows(buf, base, ks, s["kNN"], kk, 8 * m))
    ref = q.astype(np.float64) @ band.astype(np.float64)[
        :K12["kWarpBand"]].T
    assert np.abs(bias - ref).max() <= 1e-6 * np.abs(ref).max()
    out = np.zeros((16, 8 * s["kNN"]))
    vbase = keys * ks
    for nt in range(8):
        # P's C fragment as the A fragment: key 8nt + 2t in slot t, key
        # 8nt + 2t + 1 in slot t + 4
        a = p[:, [8 * nt + 2 * t + e for e in range(2) for t in range(4)]]
        for nn in range(s["kNN"]):
            b = np.zeros((8, 8), np.float32)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(2):
                    b[t + 4 * e, g] = buf[vbase + (8 * nt + 2 * t + e) * vs
                                          + 8 * nn + g]
            out[:, 8 * nn:8 * nn + 8] += mma3(a, b)
    ref = p.astype(np.float64) @ v.astype(np.float64)[:K12["kKeys"]]
    assert np.isfinite(out).all()
    assert np.abs(out[:, :d] - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(out[:, d:]).max(initial=0.0) == 0.0
