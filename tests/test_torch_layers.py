"""PyTorch port vs the JAX package, layer by layer, on the CPU: norm, RoPE
(at positions past 1e4, theta 1e6), gated GELU MLP, softcap, embedding and
the prefill attention (full-window, sliding-window and block-local). Inputs
come from numpy with a seed and feed both packages; tolerance 1e-5 abs in
float32 (both sides compute in f32, differing only in summation order and
transcendental rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Embedding, Norm

TOL = 1e-5


def _rs(seed):
    return np.random.RandomState(seed)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_apply_norm(kind):
    rs = _rs(0)
    x = rs.randn(2, 5, 48).astype(np.float32) * 3
    scale = rs.randn(48).astype(np.float32)
    bias = rs.randn(48).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    tp = Norm(kind, 48, torch.float32, "cpu")
    with torch.no_grad():                  # parameters are trainable leaves
        tp.scale.copy_(torch.from_numpy(scale))
        if kind == "layer":
            tp.bias.copy_(torch.from_numpy(bias))
    if kind == "layer":
        jp["bias"] = jnp.asarray(bias)
    _close(jl.apply_norm(jp, jnp.asarray(x), kind),
           tl.apply_norm(tp, torch.from_numpy(x), kind))


@pytest.mark.parametrize("theta,start", [(10_000.0, 0), (1_000_000.0, 12_000),
                                         (1_000_000.0, 130_000)])
def test_apply_rope_late_positions(theta, start):
    """The frequencies are computed in float64 and cast once, as in JAX;
    positions far past 1e4 expose any drift from doing it in float32."""
    rs = _rs(1)
    x = rs.randn(2, 7, 3, 64).astype(np.float32)
    pos = (start + np.arange(7)[None, :] * 977 + np.arange(2)[:, None]
           ).astype(np.int32)
    _close(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta))


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("gelu", False)])
def test_apply_mlp(act, gated):
    """gemma's gated GELU: jax.nn.gelu defaults to the tanh form."""
    rs = _rs(2)
    x = rs.randn(2, 5, 32).astype(np.float32)
    w = {k: (rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_up", (32, 64)), ("w_down", (64, 32)),
                      ("w_gate", (32, 64)))}
    if not gated:
        del w["w_gate"]
    tp = MLP(*(torch.from_numpy(w[k]) for k in ("w_up", "w_down")),
             torch.from_numpy(w["w_gate"]) if gated else None)
    _close(jl.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                        jnp.asarray(x), act, gated),
           tl.apply_mlp(tp, torch.from_numpy(x), act, gated))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = _rs(3).randn(4, 50).astype(np.float32) * 40
    _close(jl.softcap(jnp.asarray(x), cap), tl.softcap(torch.from_numpy(x),
                                                       cap))


def test_embedding_and_unembedding():
    rs = _rs(4)
    table = rs.randn(53, 16).astype(np.float32)
    toks = rs.randint(0, 53, (2, 9))
    x = rs.randn(2, 9, 16).astype(np.float32)
    tp = Embedding(torch.from_numpy(table))
    jp = {"table": jnp.asarray(table)}
    _close(jl.apply_embedding(jp, jnp.asarray(toks)),
           tl.apply_embedding(tp, torch.from_numpy(toks)), 0.0)
    _close(jl.apply_unembedding(jp, jnp.asarray(x)),
           tl.apply_unembedding(tp, torch.from_numpy(x)))


@pytest.mark.parametrize("S,window,n_kv", [
    (12, 0, 1),      # global causal, GQA rep 4
    (12, 8, 2),      # sliding window, S <= 2W: dense window mask
    (24, 8, 1),      # S > 2W, S % W == 0: block-local path
    (20, 8, 4),      # S > 2W, S % W != 0: dense window mask
])
def test_apply_attention_with_kv(S, window, n_kv):
    rs = _rs(5)
    d, H, hd = 64, 4, 16
    w = {"wq": (d, H * hd), "wk": (d, n_kv * hd), "wv": (d, n_kv * hd),
         "wo": (H * hd, d)}
    w = {k: (rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in w.items()}
    x = rs.randn(2, S, d).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=n_kv, head_dim=hd, causal=True,
              window=window, rope=True, rope_theta=1_000_000.0,
              return_kv=True)
    jo, jk, jv = jattn.apply_attention(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), **kw)
    tp = Attention(*(torch.from_numpy(w[k]) for k in ("wq", "wk", "wv",
                                                      "wo")))
    to, tk, tv = tattn.apply_attention(tp, torch.from_numpy(x), **kw)
    _close(jo, to)
    _close(jk, tk)
    _close(jv, tv)
