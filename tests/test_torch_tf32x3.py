"""The 3xTF32 arithmetic of ``kernels/csrc/tf32x3.cuh``, emulated on the
CPU: the precision argument for running the port's float32 products on the
tensor cores, made before any run on a card.

A tf32 value is the top 19 bits of a float32 (sign, exponent, 10 mantissa
bits). The kernels split each operand as a = big + small, big = a rounded
to tf32 to nearest with ties away from zero (``cvt.rna.tf32.f32``'s
rounding), small = a - big, which the tensor core reads truncated to tf32,
and take each product as small·big + big·small + big·big. The products of
two tf32 values are exact in float32, so float32 matmuls of the split
operands emulate the tensor core's products. The emulation sums in IEEE
float32; the tensor core's own sums truncate, and the kernels keep them to
one or two k-steps' products before an IEEE add (``csrc/tf32x3.cuh``).

At small slices of the main path's shapes (ViT-small's hd 64 at S 197,
gemma3-1b's hd 256 causal and windowed, D2FT-LoRA's wq at K 1152,
olmoe-1b-7b's expert FFN at D 2048, F 1024 over 384 capacity rows) the
emulated 3xTF32 attention forward and backward, LoRA matmul and MoE expert
FFN products stay within the limits the kernels are held to on the card
(o and lse 1e-5 absolute, gradients 1e-4; LoRA and the MoE's y 1e-5, the
MoE's dx and dW 1e-4, each x max(1, max |plain|)) of the float64 result
with a tenfold margin, and one TF32 product a step does not.

The swizzled tiles' index arithmetic is checked apart: the transposed A
loader of the MoE weight gradients (``tf32x3::load_a_km``) reads each
element of its tile from a slot of its own, and each of its four reads
puts a warp's 32 lanes on 32 distinct banks; the attention tiles at hd 80
and 96, rows padded to a pitch of 96 floats, keep every element in a slot
of its own and every fragment read on 32 distinct banks.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.d2ft_attention import NEG_INF, kernel_block

KERNEL_TOL = 1e-5
GRAD_TOL = 1e-4


def tf32(x):
    """``cvt.rna.tf32.f32``: round a float32 tensor to 10 mantissa bits,
    to nearest with ties away from zero (on the magnitude's bits), as the
    kernels' split does with an integer add and mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x):
    """A float32 as the tensor core reads a tf32 operand: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a, b, terms):
    """a @ b of float32 tensors the way the kernels' mma steps take it:
    terms 3 is 3xTF32 (small·big + big·small + big·big), 1 one TF32
    product."""
    a_big, b_big = tf32(a), tf32(b)
    if terms == 1:
        return a_big @ b_big
    a_small, b_small = tf32_read(a - a_big), tf32_read(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def mm_ksteps(a, b, terms):
    """``mm`` one k-step (8 of the inner dimension) at a time, each step's
    products added to the sum in IEEE float32, as ``tf32x3::mma3`` adds
    each step's fresh tensor-core accumulator."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k8 in range(0, a.shape[1], 8):
        out = out + mm(a[:, k8:k8 + 8], b[k8:k8 + 8], terms)
    return out


@contextlib.contextmanager
def one_thread():
    """torch's intra-op threads at 1 inside the block, the old count
    restored after: ``mm_ksteps``'s many 8-deep products run slower across
    threads than on one (and oversubscribe the cores beside other test
    processes). The results are the same bits."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def test_rounding_and_split():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 3.0, 0.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
                                1 + 2 ** -9, 3.0, 0.0]
    assert tf32_read(x).tolist() == [1.0, 1.0, -1.0, 1 + 2 ** -10, 3.0,
                                     0.0]
    a = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    big = tf32(a)
    small = tf32_read(a - big)
    # big within 2^-11 of a; small, read with 10 mantissa bits, leaves
    # big + small within 2^-21
    assert float(((a - big) / a).abs().max()) <= 2 ** -11
    rest = (a.double() - big.double() - small.double()) / a.double()
    assert float(rest.abs().max()) <= 2 ** -21


def _attention_backward(q, k, v, do, causal, window, terms):
    """The backward kernels' arithmetic on one slice: s = (q k^T) scale,
    p = exp(s - lse), dp = do v^T, ds = p (dp - delta), dq = ds k scale,
    dk = ds^T q scale, dv = p^T do, with the five products taken by
    ``mm`` (terms 3 or 1) or, terms 0, in float64. lse and delta come from
    float64, as the forward's lse and the exact delta, so only the
    products differ."""
    S, hd = q.shape
    scale = hd ** -0.5
    mask = _mask(S, causal, window)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s64 = torch.where(mask, q64 @ k64.T * scale, -torch.inf)
    lse = torch.logsumexp(s64, dim=-1, keepdim=True)
    p64 = torch.exp(s64 - lse)
    delta = ((p64 @ v64) * do64).sum(-1, keepdim=True)
    if terms == 0:
        dp = do64 @ v64.T
        ds = p64 * (dp - delta)
        return {"dq": ds @ k64 * scale, "dk": ds.T @ q64 * scale,
                "dv": p64.T @ do64}
    s = mm(q, k.T, terms) * scale
    p = torch.where(mask, torch.exp(s - lse.float()), 0.0)
    ds = p * (mm(do, v.T, terms) - delta.float())
    return {"dq": mm(ds, k, terms) * scale,
            "dk": mm(ds.T.contiguous(), q, terms) * scale,
            "dv": mm(p.T.contiguous(), do, terms)}


def _mask(S, causal, window):
    pos = torch.arange(S)
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def _attention_forward(q, k, v, causal, window, terms):
    """The forward kernel's arithmetic on one slice: its key tiles
    (``kernel_block(hd, "fwd")``) walked in order with an online softmax in
    float32, s = (q k^T) scale with NEG_INF where masked, p = exp(s - m),
    acc = acc corr + p v, then o = acc / l and lse = m + log(l); both
    products by ``mm_ksteps`` (terms 3 or 1). terms 0: float64, in one
    pass. Returns (o, lse)."""
    S, hd = q.shape
    scale = hd ** -0.5
    mask = _mask(S, causal, window)
    if terms == 0:
        q64, k64, v64 = (t.double() for t in (q, k, v))
        s = torch.where(mask, q64 @ k64.T * scale, -torch.inf)
        lse = torch.logsumexp(s, dim=-1)
        return torch.exp(s - lse[:, None]) @ v64, lse
    bk = kernel_block(hd, "fwd")[1]
    m = torch.full((S, 1), NEG_INF, dtype=torch.float32)
    l = torch.zeros((S, 1), dtype=torch.float32)
    acc = torch.zeros((S, hd), dtype=torch.float32)
    for k0 in range(0, S, bk):
        kt, vt = k[k0:k0 + bk], v[k0:k0 + bk]
        live = mask[:, k0:k0 + bk]
        if not live.any():
            continue
        s = mm_ksteps(q, kt.T.contiguous(), terms) * scale
        s = torch.where(live, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm_ksteps(p, vt, terms)
        m = m_new
    return acc / l, (m + torch.log(l))[:, 0]


# ViT-small's slice (S 197, hd 64, bidirectional); gemma3-1b's hd 256 on a
# 128-row slice, causal and under a window
@pytest.mark.parametrize("S,hd,causal,window", [
    (197, 64, False, 0), (128, 256, True, 0), (128, 256, True, 40)])
def test_attention_forward_products_hold_the_kernel_limits(S, hd, causal,
                                                           window):
    rng = np.random.default_rng(2 * S + hd + window)
    q, k, v = (torch.from_numpy(rng.normal(size=(S, hd)).astype(np.float32))
               for _ in range(3))
    exact = _attention_forward(q, k, v, causal, window, 0)
    errs = {}
    for terms in (3, 1):
        got = _attention_forward(q, k, v, causal, window, terms)
        errs[terms] = [float((a.double() - b).abs().max())
                       for a, b in zip(got, exact)]
    # o and lse within the limit with a tenfold margin, where one TF32
    # product misses it
    for i, name in enumerate(("o", "lse")):
        assert errs[3][i] <= KERNEL_TOL / 10, (name, errs[3][i])
        assert errs[1][i] > KERNEL_TOL, (name, errs[1][i])


@pytest.mark.parametrize("S,hd,causal,window", [
    (197, 64, False, 0), (128, 256, True, 0), (128, 256, True, 40)])
def test_attention_backward_products_hold_the_kernel_limits(S, hd, causal,
                                                            window):
    rng = np.random.default_rng(S + hd + window)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(S, hd)).astype(
        np.float32)) for _ in range(4))
    exact = _attention_backward(q, k, v, do, causal, window, 0)
    errs = {}
    for terms in (3, 1):
        got = _attention_backward(q, k, v, do, causal, window, terms)
        errs[terms] = {name: float((got[name].double() - exact[name])
                                   .abs().max()) for name in got}
    # within the limit with a tenfold margin, where one TF32 product
    # misses it
    for name in ("dq", "dk", "dv"):
        assert errs[3][name] <= GRAD_TOL / 10, (name, errs[3][name])
        assert errs[1][name] > GRAD_TOL, (name, errs[1][name])


# D2FT-LoRA's wq (K 1152, N 1024) on 256 rows and 128 columns, at the run's
# rank 8 and the paper's largest rank-matched 240
@pytest.mark.parametrize("r", [8, 240])
def test_lora_products_hold_the_kernel_limit(r):
    M, K, N, scale = 256, 1152, 128, 0.7
    rng = np.random.default_rng(r)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) / K ** 0.5).astype(np.float32)
    a = (rng.normal(size=(K, r)) / K ** 0.5).astype(np.float32)
    b = (rng.normal(size=(r, N)) / r ** 0.5).astype(np.float32)
    exact = x.astype(np.float64) @ w + scale * (
        (x.astype(np.float64) @ a) @ b)
    lim = KERNEL_TOL * max(1.0, float(np.abs(exact).max()))
    xt, wt, at, bt = (torch.from_numpy(t) for t in (x, w, a, b))
    errs = {}
    for terms in (3, 1):
        # the kernel: u = x A beside x W, then scale u added through B
        u = mm(xt, at, terms)
        y = mm(xt, wt, terms) + mm(scale * u, bt, terms)
        errs[terms] = float(np.abs(y.double().numpy() - exact).max())
    assert errs[3] <= lim / 10, errs
    assert errs[1] > lim, errs


# ------------------------------------------------------- MoE expert FFN
# olmoe-1b-7b's expert widths (D 2048, F 1024, silu) on slices: 128 rows
# of a capacity tile through h and g at K 2048 and y at depth F on 64
# columns of D; dx at depth 2F on 64 columns of D; the dW of 128 rows x 64
# columns over 384 capacity rows (three blocks of 128)
MOE_D, MOE_F, MOE_ROWS = 2048, 1024, 384
MOE_TOL = {"y": KERNEL_TOL, "dx": GRAD_TOL, "dw_up": GRAD_TOL,
           "dw_gate": GRAD_TOL, "dw_down": GRAD_TOL}


@functools.cache
def _moe_operands():
    rng = np.random.default_rng(19)
    D, F, R = MOE_D, MOE_F, MOE_ROWS
    return (rng.normal(size=(R, D)).astype(np.float32),
            (rng.normal(size=(D, F)) / D ** 0.5).astype(np.float32),
            (rng.normal(size=(D, F)) / D ** 0.5).astype(np.float32),
            (rng.normal(size=(F, D)) / F ** 0.5).astype(np.float32),
            rng.normal(size=(R, D)).astype(np.float32))


def _silu_pair(g):
    s = 1.0 / (1.0 + np.exp(-g)) if isinstance(g, np.ndarray) \
        else torch.sigmoid(g)
    return g * s, s * (1.0 + g * (1.0 - s))


@functools.cache
def _moe_products(terms):
    with one_thread():
        return _moe_products_on_one_thread(terms)


def _moe_products_on_one_thread(terms):
    """The MoE kernels' products on the slices, each by ``mm_ksteps`` in
    the kernels' k order (terms 3 or 1), or in float64 (terms 0): y (the
    forward's mid then down kernel), dx (the backward's mid kernel: h, g
    and dmid = dy W_down^T, then dx = [dh | dg] [W_up | W_gate]^T at depth
    2F), dW_up = x^T dh, dW_gate = x^T dg, dW_down = (a h)^T dy over the
    capacity rows in ascending order."""
    x, wu, wg, wd, dy = _moe_operands()
    n = 64
    if terms == 0:
        x, wu, wg, wd, dy = (t.astype(np.float64) for t in (x, wu, wg, wd,
                                                           dy))

        def mmk(a, b):
            return a @ b
    else:
        x, wu, wg, wd, dy = map(torch.from_numpy, (x, wu, wg, wd, dy))

        def mmk(a, b):
            return mm_ksteps(a.contiguous(), b.contiguous(), terms)
    cat = np.concatenate if terms == 0 else torch.cat
    # a tile's 128 rows over all of F
    t = slice(0, 128)
    h, g = mmk(x[t], wu), mmk(x[t], wg)
    a, da = _silu_pair(g)
    y = mmk(a * h, wd[:, :n])
    dm = mmk(dy[t], wd.T)
    dx = mmk(cat([dm * a, dm * h * da], 1), cat([wu[:n].T, wg[:n].T], 0))
    # every capacity row over F's first n columns
    h, g = mmk(x, wu[:, :n]), mmk(x, wg[:, :n])
    a, da = _silu_pair(g)
    dm = mmk(dy, wd[:n].T)
    xt = x[:, :128].T
    return {"y": y, "dx": dx, "dw_up": mmk(xt, dm * a),
            "dw_gate": mmk(xt, dm * h * da),
            "dw_down": mmk((a * h).T, dy[:, :n])}


@pytest.mark.parametrize("name", list(MOE_TOL))
def test_moe_products_hold_the_kernel_limits(name):
    exact = _moe_products(0)[name]
    lim = MOE_TOL[name] * max(1.0, float(np.abs(exact).max()))
    errs = {terms: float(np.abs(_moe_products(terms)[name].double().numpy()
                                - exact).max()) for terms in (3, 1)}
    assert errs[3] <= lim / 10, (lim, errs)
    assert errs[1] > lim, (lim, errs)


def _swz(row):
    return ((row & 3) << 3) | (row & 4)


def _at(pitch, row, col):
    return row * pitch + (col ^ _swz(row))


# the dW kernels' A^T slab [32 k][128 m]; 64-wide as a check of the rule
@pytest.mark.parametrize("pitch", [64, 128])
def test_transposed_a_loader_reads_distinct_slots_and_banks(pitch):
    rows = 32
    slots = [_at(pitch, r, c) for r in range(rows) for c in range(pitch)]
    assert sorted(slots) == list(range(rows * pitch))
    # load_a_km's reads (k0 + t, m0 + g), (k0 + t, m0 + g + 8),
    # (k0 + t + 4, m0 + g), (k0 + t + 4, m0 + g + 8), lane = 4 g + t
    for k0 in range(0, rows, 8):
        for m0 in range(0, pitch, 16):
            for dk, dm in ((0, 0), (0, 8), (4, 0), (4, 8)):
                banks = {_at(pitch, k0 + t + dk, m0 + g + dm) % 32
                         for g in range(8) for t in range(4)}
                assert len(banks) == 32, (k0, m0, dk, dm)


# the attention tiles at stablelm-3b's hd 80 and phi3-vision-42b's 96:
# rows padded to a pitch of 96 floats (both kernels' Geo<HD>::kHp, the
# head dim rounded up to whole 32-float swizzle groups)
@pytest.mark.parametrize("hd", [80, 96])
def test_padded_head_dim_tiles_read_distinct_slots_and_banks(hd):
    pitch = -(-hd // 32) * 32
    assert pitch == 96
    rows = 64
    slots = {(r, c): _at(pitch, r, c) for r in range(rows) for c in range(hd)}
    # each element in a slot of its own, inside its row's pitch, and each
    # 16-byte chunk whole (cp.async fills it from one source chunk)
    assert len(set(slots.values())) == rows * hd
    assert all(r * pitch <= v < (r + 1) * pitch
               for (r, _), v in slots.items())
    for r in range(rows):
        for c0 in range(0, hd, 4):
            first = slots[(r, c0)]
            assert first % 4 == 0
            assert [slots[(r, c0 + i)] for i in range(4)] == \
                list(range(first, first + 4))
    # ldmatrix (load_a, load_b_nk): 8 rows of one 16-byte chunk column on
    # 32 distinct banks
    for r0 in range(0, rows, 8):
        for c0 in range(0, hd, 4):
            banks = {slots[(r0 + i, c0 + j)] % 32
                     for i in range(8) for j in range(4)}
            assert len(banks) == 32, (r0, c0)
    # load_b_kn's reads (k0 + t, n0 + g) and (k0 + t + 4, n0 + g), lane =
    # 4 g + t: 32 distinct banks
    for k0 in range(0, rows, 8):
        for n0 in range(0, hd, 8):
            for dk in (0, 4):
                banks = {slots[(k0 + t + dk, n0 + g)] % 32
                         for g in range(8) for t in range(4)}
                assert len(banks) == 32, (k0, n0, dk)


@pytest.mark.parametrize("H", [6, 17, 24])
def test_ssd_head_group_sum_matches_the_per_head_sum(H):
    """dB and dC of the SSD backward are summed over the heads inside the
    kernels: a block adds its group's heads (``HEAD_GROUP`` of them, the
    last group short at H 17) into one float32 accumulator in head order,
    and past one group the groups' partials are added in float64 in group
    order and rounded once. That order, emulated, equals the float64 sum
    over the heads within float32 rounding: at most HEAD_GROUP roundings
    of the heads' magnitudes and one of the sum. Two evaluations agree
    bitwise (a fixed order, no atomics)."""
    from repro_torch.kernels import d2ft_ssd
    rng = np.random.default_rng(H)
    hg, G = d2ft_ssd.HEAD_GROUP, d2ft_ssd.n_head_groups(H)
    assert G == -(-H // hg)
    contrib = (rng.normal(size=(H, 256, 128))
               * rng.uniform(0.1, 10.0, size=(H, 1, 1))).astype(np.float32)

    def kernel_order():
        parts = []
        for g in range(G):
            acc = np.zeros(contrib.shape[1:], np.float32)
            for h in range(g * hg, min(H, (g + 1) * hg)):
                acc = (acc + contrib[h]).astype(np.float32)
            parts.append(acc)
        if G == 1:
            return parts[0]
        return np.sum(np.stack(parts).astype(np.float64), axis=0).astype(
            np.float32)

    got = kernel_order()
    exact = np.sum(contrib.astype(np.float64), axis=0)
    mag = np.sum(np.abs(contrib.astype(np.float64)), axis=0)
    bound = (hg * mag + np.abs(exact)) * 2.0 ** -24
    assert np.all(np.abs(got - exact) <= bound)
    assert np.array_equal(got, kernel_order())
