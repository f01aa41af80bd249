"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

``paged_decode`` — paged flash decode (CUDA C++, ``csrc/paged_decode.cu``);
``d2ft_attention`` — gated flash attention, forward and gate-aware backward
(``csrc/d2ft_attention_{fwd,bwd}.cu``);
``d2ft_ssd`` — gated SSD chunked scan, forward and gate-aware backward
(``csrc/d2ft_ssd_{fwd,bwd}.cu``);
``d2ft_rglru`` — gated RG-LRU scan, forward and gate-aware backward
(``csrc/d2ft_rglru_{fwd,bwd}.cu``);
``d2ft_moe`` — gated MoE expert FFN, forward and gate-aware backward
(``csrc/d2ft_moe_{fwd,bwd}.cu``);
``lora_matmul`` — fused LoRA matmul, forward only (``csrc/lora_matmul.cu``);
``contract`` — the gate contract: compaction tables, the executed-work
counter, the fallback hook;
``build`` — nvcc build of ``csrc/*.cu`` at first use, loaded with ctypes;
``ops`` — public entries with the JAX package's argument checks, dispatching
CPU tensors to the plain version and CUDA tensors to the kernel.
"""
