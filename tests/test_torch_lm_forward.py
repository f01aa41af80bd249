"""The LLM fine-tune slice's ``forward`` and ``lm_loss`` against the JAX
package on the CPU, at the three smoke configs of
``tests/test_torch_lm_train.py`` (mamba2, gemma3, recurrentgemma; the
configs and the case: ``tests/_torch_lm_cases.py``): with and without
gates, at G = 1 (mamba2's launcher ``head_groups = max(n_heads, 1)``) and
G = 4 (gemma3's), on the masked path and on the kernel path (whose CPU
route is the kernels' plain version), logits, loss and gradients within
1e-5.
"""
import pytest

from _torch_lm_cases import ARCHS, forward_case


# (G, gated, use_kernel): ungated; G = 1; 4 heads per group (gemma3: one)
@pytest.mark.parametrize("G,gated,use_kernel", [
    (1, False, False), (1, True, False), (1, True, True), (4, True, False),
    (4, True, True)])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_lm_loss_match_jax(arch, G, gated, use_kernel):
    forward_case(arch, G, gated, use_kernel)
