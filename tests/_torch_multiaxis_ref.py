"""The JAX side shared by ``tests/test_torch_multiaxis.py`` and
``tests/test_torch_pipeline.py``: the JAX multi-axis suite's model and
schedule table (``tests/_dist_parity_multiaxis.py``), and the JAX
pipeline's round report for given boundaries and micro-batch count."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.schedule import P_F, P_O, P_S
from repro.train.pipeline import PipelineRecorder as JaxRecorder
from repro.train.pipeline import pipeline_loss as jax_pipeline_loss

DENSE = dict(name="multiaxis", arch_type="dense", n_layers=4, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
JCFG = JaxModelConfig(**DENSE)
G, L, N = 4, 4, 16


def multiaxis_table():
    """The JAX multi-axis suite's [L*G, N] table: layer 0 dead (no p_f),
    layer 2 all p_f."""
    rng = np.random.default_rng(0)
    table = rng.choice([P_F, P_O, P_S], size=(L * G, N),
                       p=[.4, .3, .3]).astype(np.int8)
    table[0:G] = np.where(table[0:G] == P_F, P_O, table[0:G])
    table[2 * G:3 * G] = P_F
    return table


def jax_trace_report(jparams, boundaries, n_mb, seq, monkeypatch):
    """JAX's ``PipelineRecorder`` report from tracing its ``pipeline_loss``
    over a stage axis of len(boundaries) - 1: vmap with an axis name stands
    in for the shard_map, and an identity for the ppermute (vmap takes only
    whole permutations); the recorder counts the trace's rounds and
    handoffs, not values."""
    monkeypatch.setattr(jax.lax, "ppermute", lambda x, axis, perm: x)
    rec = JaxRecorder()
    tokens = jnp.zeros((n_mb, seq), jnp.int32)

    def fn(tok):
        return jax_pipeline_loss(jparams, JCFG, tok, tok, None,
                                 boundaries=boundaries,
                                 n_microbatches=n_mb, recorder=rec)[0]
    jax.eval_shape(jax.vmap(fn, in_axes=None, axis_name="stage",
                            axis_size=len(boundaries) - 1), tokens)
    monkeypatch.undo()
    return rec.report()
