"""The packed D2FT path's step FLOPs and the two examples in the PyTorch
port on the CPU (its parity with the JAX package is in
``tests/test_torch_packed.py``, whose schedule helper this file uses): the
FLOPs that ``FlopCounterMode`` counts over a packed step equal a count
derived from the table and the shapes; the two examples at a small size.
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core import d2ft
from repro_torch.core.cost_model import compute_cost
from repro_torch.models.transformer import forward, init_model

from test_torch_packed import _schedule


def _mm_flops(rows, d_in, d_out):
    return 2 * rows * d_in * d_out


def test_flop_count_of_a_packed_step_equals_the_analytic_count():
    """benchmarks/run.py::bench_packed_flops's shape (4 layers, d 128, 4
    heads, d_ff 256, vocab 512, B 20, S 64, M 5, 3 p_f / 0 p_o, G 4):
    FlopCounterMode over the micro-batch form's forward and backward
    counts each group's GEMMs on its gathered rows, its attention on its
    samples and the unembedding, three times (forward, and both operands'
    gradients), and nothing for the p_s micro-batches; full fine-tuning
    the same over every sample and head."""
    cfg = ModelConfig(name="bench", arch_type="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                      vocab_size=512)
    B, S, M, G = 20, 64, 5, 4
    sched = _schedule(4, G, M, 3, 0)
    plan = d2ft.mb_packed_indices(sched, M)
    model = init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (B, S)))

    def count(fn):
        with FlopCounterMode(display=False) as fc:
            torch.mean(fn()[0] ** 2).backward()
        return fc.get_total_flops()

    packed = count(lambda: d2ft.packed_forward_mb(model, cfg, toks, plan,
                                                  M))
    full = count(lambda: forward(model, cfg, toks))
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.d_model // 4

    def block(samples, heads):
        rows = samples * S
        return (_mm_flops(rows, D, heads * hd) * 4          # q, k, v, o
                + 2 * 2 * samples * heads * S * S * hd      # QK^T, PV
                + _mm_flops(rows, D, F * heads // 4) * 3)   # up, gate, down
    Bp = B // M
    samples = (plan[2].sum(-1) * Bp).astype(int)            # [L, G]
    want = 3 * (sum(block(int(n), 1) for n in samples.ravel())
                + _mm_flops(B * S, D, V))
    want_full = 3 * (cfg.n_layers * block(B, 4) + _mm_flops(B * S, D, V))
    assert (plan[1] == plan[2]).all() and (samples == 3 * Bp).all()
    assert packed == want and full == want_full
    frac = packed / full
    assert compute_cost(sched.table) == pytest.approx(0.6)
    assert 0.6 < frac < 0.7             # the unembedding runs in full


def test_llm_example_runs_on_the_cpu():
    from repro_torch.examples import d2ft_llm_finetune as ex
    cfg = ex.CFG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256)
    d2 = D2FTConfig(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    for packed, use_kernel in ((True, False), (False, True), (False, False)):
        log = ex.run(cfg, d2=d2, device="cpu", steps=2, batch=8, seq=16,
                     packed=packed, use_kernel=use_kernel)
        assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    with pytest.raises(SystemExit):
        ex.main(["--packed", "--kernel", "--device", "cpu"])


def test_quickstart_runs_on_the_cpu():
    from repro_torch.examples import quickstart
    acc_d2ft, acc_std = quickstart.run(device="cpu", steps=2, eval_batches=1)
    assert 0.0 <= acc_d2ft <= 1.0 and 0.0 <= acc_std <= 1.0
