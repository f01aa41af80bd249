#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device — the card's name and power limit; TF32 off for matmuls and
   cuDNN, so float32 means float32.
2. build — every ``src/repro_torch/kernels/csrc/*.cu`` compiled with nvcc
   for sm_90a (one nvcc per source, all started together), the build
   seconds and the ``-Xptxas -v`` report.
3. kernel vs plain — the paged flash-decode kernels (split-KV, then the
   merge) against their plain PyTorch version at gemma3-1b decode shapes,
   <= 1e-5 in float32, exact zeros on gated heads and bitwise equal across
   two calls: lengths at page and 64-position run boundaries, tables
   null-padded over whole runs, windows 0, 512 and 40. The same checks at
   decode shapes no ported path serves yet: recurrentgemma-2b's (10 query
   heads on 1 KV head of 256, window 2048: two head groups of 5 a block),
   stablelm-3b's (32 heads of 80) and phi3-vision-42b's (32 heads of 96).
4. serve — the paged serving engine on gemma3-1b at full width (random
   weights from seed 0) answers 8 requests through 4 slots with the kernel
   on; launches == 26 x decode steps, every request finishes, every page
   returns, and the greedy tokens equal those of the plain gather path.
   Then a profiler window over five decode steps of the four longest
   requests: device busy and idle share per step, top kernels; and the
   host time per step of the page-id range check and of the paged entry
   outside its kernel launcher, over five more steps without the
   profiler: as the engine runs (one check of its host table a step) and
   with a check of the device table at every layer, as the checked entry
   makes (one device sync each).
5. kernel timing — CUDA-event times of the decode launcher call and of its
   kernels alone (output and workspace allocated outside the window), its
   plain version and one PyTorch library call (gather +
   scaled_dot_product_attention, a yardstick the port never calls) at the
   trace's final lengths, beside the bytes bound; the split grid and the
   kernels' registers and spills from the -Xptxas -v logs; then the same
   times at phase 3's other decode shapes.
6. attention kernels vs plain — the gated flash-attention forward and
   backward kernels against their plain version and its autograd
   gradients: ViT-small shapes (B 40, H 6, S 197, hd 64, bidirectional)
   under a p_f / p_o / p_s mix, without, with and above compaction
   bounds; causal S 256 hd 128; window 128 at S 512 hd 64; stablelm-3b's
   (hd 80) and phi3-vision-42b's (hd 96) attention, B 2, H 32, S 1024,
   causal (rows padded to a pitch of 96 floats in the kernels). o and lse
   <= 1e-5, dq/dk/dv <= 1e-4, exact zeros on gated slices, lse = 2^30 on
   dead ones, executed tiles = live slices x live tiles per slice.
7. fine-tune — the paper's D2FT fine-tune of ViT-small at full size
   (12 layers, d 384, S 197, random weights from seed 0) on the synthetic
   image task, batch 40 in 5 micro-batches, n_pf 3 / n_po 1, SGD, 8 steps:
   scores and knapsack at step 0, then the gated kernel path. 12 forward
   and 12 backward kernel launches per step, executed tile fractions 0.800
   forward and 0.600 backward, finite losses within 1e-4 x max(1, |loss|)
   of the masked plain path on the same weights and schedule. p50 step
   ms of the kernel path, the masked path and standard full fine-tuning
   (each run twice, in turns), images/s, peak memory; then a profiler
   window over 3 kernel-path steps.
8. attention kernel timing — CUDA-event times of the forward and backward
   kernels at the fine-tune's shapes and (192, 144) bounds, L2 flushed
   (each through its launcher and its kernels alone), beside their plain
   version's, both bounds (float32 FMA; 3xTF32 on the tensor cores, which
   both are held to), the library yardstick (scaled_dot_product_attention
   forward and its autograd backward on the live slices, which the port
   never calls) and both sources' registers and spills from the
   -Xptxas -v logs. Then the same at stablelm-3b's and phi3-vision-42b's
   attention shapes (B 2, H 32, S 1024, hd 80 / 96, causal).
9. SSD kernels vs plain — the gated SSD chunked-scan forward and backward
   kernels against their plain version and its autograd gradients, on the
   operands the main path gives them (mamba2-130m's first SSD layer,
   weights from seed 0, on the launcher's batch: B 8, H 24, P 64, N 128,
   chunk 256) and a unit-normal cotangent, at S 2048 and S 1000 (the pad
   path), under a p_f / p_o / p_s mix, without, at and above compaction
   bounds: y and prevs <= 1e-5, dx / ddA / dB / dC <= 1e-4, exact zeros
   on gated slices, executed (slice, chunk) steps = live slices x chunks.
   Beside each, both against the plain version evaluated in float64 and
   the plain version's max |value| of each output; and one case at the JAX
   tests' N(0, 1) operand scale, where the values reach ~200 and float32's
   own rounding is of the order of the absolute tolerances, held to them
   scaled as tol x max(1, max |plain|). From here on
   ``contract.on_fallback`` raises, so no non-kernel route can stand in
   for a kernel.
10. LLM fine-tune — ``repro_torch.launch.train`` on mamba2-130m at full
   size (24 layers, d 768, random weights from seed 0), batch 8 x seq
   2048 of ``lm_batches`` in 4 micro-batches, n_pf 2 / n_po 1, AdamW lr
   1e-3, 3 steps, scores and knapsack at step 0. 24 forward and 24
   backward SSD launches per step, executed step fractions equal to the
   schedule's live counts (read from the device counter), finite losses
   within 1e-4 x max(1, |loss|) of the masked plain path on the same
   weights and schedule. p50 step ms of the kernel path, the masked path
   and standard full fine-tuning (no D2FT), each run twice in turns,
   tokens/s, peak memory; then a profiler window over 3 kernel-path steps.
11. SSD kernel timing — CUDA-event times of both kernels, L2 flushed,
   through the launcher call (the record's ms) and alone (outputs and
   workspaces allocated outside the window; the launchers build no table
   and fill nothing), beside both bounds (float32 FMA; 3xTF32, which the
   record holds them to) at phase 10's shapes under layer 0's gates and
   bounds, with every slice live, and at one request's prefill (B 1, S
   8192), each kernel's grid, blocks an SM (CUDA's occupancy calculator)
   and waves there; the plain version's time at phase 10's shapes and both
   sources' registers and spills. No single PyTorch call computes the scan, so
   there is no library yardstick.
12. hd-256 attention kernels vs plain — the gated flash-attention kernels
   at gemma3-1b's shapes (B 4, H 4, S 1024, hd 256: 32-row forward tiles,
   64 x 32 backward ones), causal
   with its 512 window and global, on the operands the main path gives
   them (layers 0 and 5 of phase 13's model on its batch) and on N(0, 1)
   ones, under a p_f / p_o / p_s mix, without, at and above compaction
   bounds: o and lse <= 1e-5, dq/dk/dv <= 1e-4 (x max(1, max |plain|) on
   the N(0, 1) case), exact zeros, executed tiles = live slices x live
   tiles per slice.
13. gemma3-1b fine-tune — ``repro_torch.launch.train --arch gemma3-1b
   --full --d2ft --kernel`` (26 layers, d 1152, random weights from seed
   0), batch 4 x seq 1024 in 4 micro-batches, n_pf 3 / n_po 1, G 4, AdamW
   lr 1e-3, 3 steps: 26 + 26 attention launches per step, executed tile
   fractions from the device counter equal to the schedule's, finite
   losses within 1e-4 x max(1, |loss|) of the masked path; p50 step ms of
   the kernel path, the masked path and standard full fine-tuning (each
   twice, in turns), tokens/s, peak memory, a profiler window.
14. D2FT-LoRA on gemma3-1b — ``repro_torch.examples.lora_finetune``'s
   ``run`` with the example's settings (rank 8 on wq/wk/wv, SGD 0.1, n_pf
   3 / n_po 0 of 4, 4 head groups) at full size, batch 4 x seq 1024, 3
   steps: its one fused ``lora_linear`` call launches the LoRA kernel,
   26 + 26 attention launches per step, 1,038,336 adapter parameters,
   the base bit-identical after the steps and the adapters moved, losses
   within tolerance of the masked path; p50 step ms, tokens/s and peak
   memory of the kernel path, the masked path and plain LoRA, a profiler
   window. Then the LoRA kernel against its plain version and against
   x @ (W + s A@B) on this run's layer-0 operands (wq, wk, wv) and on the
   ragged M 4095 x N 1000 at ranks 1, 8, 64, 240, <= 1e-5 x max(1, max
   |plain|).
15. LoRA and hd-256 attention timing — CUDA-event times, L2 flushed, of
   the LoRA kernel at phase 14's wq (M 4096, K 1152, N 1024, r 8) and of
   the hd-256 attention kernels at phase 13's shapes, gates and bounds
   (each also alone), beside their plain versions, both bounds (float32
   FMA; 3xTF32, which all three are held to), a library yardstick the
   port never calls (addmm + two matmuls; SDPA on the live slices) and the
   LoRA kernel's registers and spills.
16. RG-LRU kernels vs plain — the gated RG-LRU scan forward and backward
   kernels against their plain version and its autograd gradients, on the
   operands the main path gives them (la and b of recurrentgemma-2b's
   layer 0, weights from seed 0, on phase 17's first batch: B 4, S 512, W
   2560) and on unit-scale ones (la = -|N(0, 0.1)|, b ~ N(0, 1)), at S
   512, 500 (the pad path) and 4096, band widths Wg 256 and 32, under a
   p_f / p_o / p_s mix, without, at and above compaction bounds: h <= 1e-5
   and dla / db <= 1e-4, each x max(1, max |plain|), exact zeros on gated
   bands, executed (slice, chunk) steps = live slices x chunks. Then the
   hd-256 attention kernels at this path's shapes: post-rope q and
   kv-expanded k, v of layer 2 (the first local attention layer; B 4, 10
   query heads on 1 KV head, S 512, window 2048 >= S, so causal), one
   gate per head (G 10, rep 1), without, at and above the bounds: o/lse
   <= 1e-5 and grads <= 1e-4 absolute, exact zeros, tiles = live slices x
   kernel_live_tiles(512, causal, 2048, 256).
17. recurrentgemma-2b fine-tune — ``repro_torch.launch.train --arch
   recurrentgemma-2b --full --d2ft --kernel --optimizer sgd`` (26 layers:
   18 RG-LRU and 8 local attention, d 2560, 10 query heads on 1 KV head of
   256, window 2048, random weights from seed 0, 3,549,934,080
   parameters), batch 4 x seq 512 in 4 micro-batches, n_pf 3 / n_po 1, G
   10, lr 1e-3, 3 steps: 18 + 18 RG-LRU and 8 + 8 attention launches per
   step, executed fractions from the device counter equal to the
   schedule's, finite losses; p50 step ms of the kernel path and standard
   full fine-tuning (each twice, in turns), tokens/s, peak memory, a
   profiler window; at one cycle (3 layers, full width) the kernel path's
   losses within 1e-4 x max(1, |loss|) of the masked path's.
18. RG-LRU kernel timing — CUDA-event times of both kernels at phase 17's
   shapes on layer 0's operands, gates and bounds, L2 flushed, through
   the launcher call (the record's ms) and alone (outputs allocated
   outside the timed window; the launchers build no table and fill
   nothing), beside their plain version's and the bytes bound, and the
   kernels' registers and spills; no single PyTorch call computes the
   scan, so there is no library yardstick.
19. MoE kernels vs plain — the gated MoE expert FFN forward and backward
   kernels against their plain version and its autograd gradients, on the
   operands the main path gives them (olmoe-1b-7b's layer 0, weights from
   seed 0, on phase 20's first batch under two sample mixes: the
   dispatched buffer E 64, C 320 -> 384, D 2048, F 1024 and its slot
   masks) without slot bounds, at the model's, at the tightest and above
   them, and on N(0, 1) operands at C 300 and E 4 (one expert with no
   slot; bounds that cut both grids) for silu, gelu and relu:
   y <= 1e-5 and dx / dW <= 1e-4, each
   x max(1, max |plain|) (printed beside the errors), exact zeros on dead
   tiles and for dead experts, executed tiles from the device counter =
   the launched block masks' sums, the backward's dW kernels launched as
   the wanted dW ask (a profiler window around it). The main path's case
   without bounds runs again as D2FT-LoRA's step asks for the backward
   (w_up alone requiring grad): dW_gate and dW_down None and their kernel
   not launched, dx and dW_up bitwise equal to the all-three call's.
20. D2FT-LoRA on olmoe-1b-7b — full width and depth (16 layers, 64
   experts top-8, 6,919,096,320 parameters, seed 0) through
   ``repro_torch.examples.lora_finetune``'s ``plan_lora`` and
   ``finetune_lora``: rank 8 on wq/wk/wv and per-expert w_up (26,738,688
   adapter parameters), SGD 0.1, n_pf 3 / n_po 0 of 4, G 16, batch 4 x
   seq 512, 3 steps: 16 + 16 MoE and 16 + 16 attention launches per step,
   executed MoE tiles = the launched masks', attention tiles = the
   schedule's, the base bit-identical after the steps and the adapters
   moved, losses within 1e-4 x max(1, |loss|) of the masked path; p50 step
   ms and tokens/s of the kernel path, the masked path and plain LoRA
   (each twice, in turns), peak memory after scoring and after the steps,
   a profiler window with the MoE kernels' time by name, in which the
   backward's dW kernel runs once a layer for dW_up alone (no dW_gate or
   dW_down work: the merged w_gate and w_down are frozen).
21. olmoe-1b-7b fine-tune — the launcher's loop (``train/loop.py::
   finetune`` with ``repro_torch.launch.train``'s settings: --optimizer
   sgd, lr 1e-3, n_pf 3 / n_po 1 of 4, G 16) at full width on 8 of the 16
   layers (3,562,571,776 parameters), batch 4 x seq 512, 3 steps: 8 + 8
   MoE and attention launches per step, device tile counts = the masks'
   and the schedule's, losses within tolerance of the masked path; p50
   step ms of the kernel, masked and full fine-tuning paths (each twice,
   in turns), tokens/s, peak memory, a profiler window with the MoE
   kernels' time by name (all three dW: both dW kernels once a layer).
22. MoE kernel timing — CUDA-event times, L2 flushed, of both kernels at
   phase 21's layer-0 operands, gates and bounds, and of the backward with
   dW_up alone (D2FT-LoRA's), through the launcher call (the record's ms)
   and alone (buffers allocated outside the window), beside their plain
   version's, both bounds (float32 FMA; 3xTF32, which they are held to), a
   library yardstick the port never calls (three torch.bmm and silu on
   the truncated buffer; its autograd backward, with every input or with
   x and w_up alone requiring grad) and both sources' registers and
   spills. Then the hd-128 attention kernels at olmoe-1b-7b's shapes (B 4,
   H 16, S 512, causal) under phase 21's layer-0 gates and bounds, through
   the launcher and alone, beside their plain version, SDPA and both
   bounds.
23. the packed D2FT path — (a) ``repro_torch.launch.train --arch
   gemma3-1b --full --d2ft --packed`` (phase 13's model at full width,
   its first 6 of 26 layers, seed 0, batch 4 x seq 1024 in 4
   micro-batches, G 4, AdamW lr 1e-3, 3 steps) at the
   launcher's budget (3 p_f + 1 p_o: every group gathers all four
   samples) and the LLM example's (2 p_f + 1 p_o: every group skips one),
   each with a step over ``packed_forward_mb`` (the micro-batch form: no
   backward graph for the p_o part), the masked and the kernel path on
   the same weights and schedule, each twice in turns, and standard full
   fine-tuning twice at the first budget: p50 step ms, tokens/s, peak
   memory, the FLOPs ``FlopCounterMode`` counts over one step as a
   fraction of full fine-tuning's beside the schedule's compute_cost; the
   packed and micro-batch losses within 1e-4 x max(1, |loss|) of the
   masked path's; no attention kernel launched outside the kernel path.
   Whether two calls of the packed loss and its gradients agree bitwise
   (and their largest difference); profiler windows over 3 packed steps
   and one micro-batch and one full step at the second budget (busy, idle,
   device time by kind of kernel; no kernel of csrc/ on these paths); the
   wall seconds of each run and of each part of the phase; two packed
   steps with remat, losses within the same tolerance of the steps
   without, peak memory beside theirs; the phase's seconds. (b) the ports
   of the two examples at their own sizes: ``d2ft_llm_finetune.run`` for
   20 steps on the packed, kernel and masked paths (finite losses, p50
   step ms) and ``quickstart.run`` (both top-1s).

24. serving the recurrent and MoE families — through the paged engine,
   random weights from seed 0, f32, page size 16, 4 slots: (a)
   recurrentgemma-2b at full size (26 layers, d 2560, its local
   attention's 10 query heads on 1 KV head of 256 through the decode
   kernel at window 2048), 8 requests with prompts of 24 to 2040 tokens,
   two of which pass 2048 tokens in decode: launches == 8 x decode steps,
   every request finishes, every page returns, tokens equal the gather
   path's and, for the two that cross the window, ``generate``'s on each
   alone; p50 decode step and time to first token, a profiler window over
   5 decode steps. (b) mamba2-130m at full size, the same trace without
   the kernel: tokens equal ``generate``'s request by request, the
   prefill dump's SSD state within 1e-4 relative of
   ``prefill_sequential``'s on a 64-token prompt; its profile. (c)
   olmoe-1b-7b at full width and depth (64 experts top 8), prompts of 24
   to 1024: launches == 16 x decode steps, tokens equal the gather
   path's, pages return; its profile. (d) the serve example at its smoke
   configs.
25. the rest of the model surface — random weights from seed 0, f32,
   TF32 off outside the 3xTF32 kernels, every kernel route armed against
   a fallback: (a) stablelm-3b at full width (d 2560, 32 heads of 80) on
   16 of its 32 layers (all 32 before phase 30) through
   ``repro_torch.launch.train --full --d2ft --kernel`` (batch 4 x seq 512
   in 4 micro-batches, n_pf 3 / n_po 1, G 32, AdamW, 2 steps): 16 + 16 B2
   launches a step, executed tiles =
   the schedule's, losses within 1e-4 x max(1, |loss|) of the masked
   path's; p50 step ms of the kernel, masked and full paths (each twice,
   in turns), peak memory, a profiler window over 3 steps with B2's share
   of busy time. (b) phi-3-vision-4.2b at full size (576 patch rows of
   1024 + 448 text tokens, batch 4) and (c) hubert-xlarge at full size
   (1024 frames of 512, batch 4, bidirectional), and (d) qwen1.5-32b (4
   of 64 layers), mixtral-8x22b (2 of 56) and moonshot-v1-16b-a3b (8 of
   48) at full width, batch 4 x 512, through ``train/loop.py::finetune(...,
   use_kernel=True)`` (n_pf 3 / n_po 1, momentum-free SGD, 2 steps):
   launches a step = the schedule's count, executed tiles = the
   schedule's (MoE: the launched masks'), the first-step loss within
   tolerance of the masked path's forward on the same weights, schedule
   and batch, finite losses; p50 step ms and peak memory; B2 (and B8 / B9)
   against their plain versions on the operands the path handed their
   first call; B2 timed at each new shape (hd 80 causal and
   bidirectional, hd 96 over the image prefix, hd 128 at 40 heads and at
   GQA 6:1), B8 / B9 at mixtral's and moonshot's layer 0 (E 8, D 6144, F
   16384; E 64, F 1408), beside their plain versions, library yardsticks
   and bounds. (e) serving through the paged engine, 4 requests through 4
   slots, page size 16: stablelm-3b at full size and the three (d) models
   at (d)'s depth, one mixtral request of 4090 + 16 tokens past its 4096
   window: B10 launches = attention layers x decode steps, tokens equal
   the gather path's, every page back; p50 decode step, a profile of 5
   decode steps each; then B10 against its plain version and timed at
   qwen's, mixtral's (rep 6, window 4096, lengths past it) and
   moonshot's decode shapes. ``python3 chip_smoke.py --only 25`` runs
   phases 1, 2 and 25 alone (a partial run that prints no result).
26. data-parallel D2FT on gemma3-1b — ``repro_torch.launch.train --arch
   gemma3-1b --full --d2ft --kernel --distributed`` at phase 13's budget
   (global batch 4 x 1024 in 4 micro-batches, n_pf 3 / n_po 1, G 4, AdamW
   lr 1e-3), 3 steps, the schedule re-planned every 2, each in a process
   of its own (this script again, ``--dp-rank``), which prints one JSON
   line a rank. (a) One rank over NCCL (``--mesh data=1``): every step's
   loss within 1e-4 x max(1, |loss|) of ``train.loop.finetune
   (use_kernel=True)``'s on the same batches and schedules (replayed),
   B2's launches = 26 x 3 a direction, the sync's bytes = the plan's
   ``ar_bytes``. (b) Two ranks sharing the card over gloo, 2 x 1024 a rank
   (``torch.distributed.run --nproc_per_node 2 ... --mesh data=2``), on
   the launcher's own knapsack schedule and on the paper's concentrated
   mix (40 % of the subnets p_f on every micro-batch, 30 % p_o, the rest
   p_s): for each step the bytes the sync's counter saw against
   ``sync_byte_report``'s ``ar_bytes`` (exactly equal), the sync's
   host-clock ms (gloo staging the bucket through pinned host memory on
   one card: not an interconnect number) against the step's p50, each
   rank's peak memory, and a checksum of the parameters, bitwise equal on
   both ranks after every step; B2's launches on each rank. A rank that
   fails fails the phase. ``python3 chip_smoke.py --only 26`` runs phases
   1, 2 and 26 alone (a partial run that prints no result). In the whole
   script the run on the launcher's schedule takes its first plan only (2
   steps), and runs in phase 27's process of two ranks; the two-rank runs
   on the mix take 2 steps re-planned at step 1 (since phase 30; 3 steps
   re-planned at step 2 before, 4 before phase 29); phase 27 (b)'s SGD pair
   on 6 of the 26 layers (one pattern cycle; all 26 before phase 29).
27. ZeRO-1 and ZeRO-3 data-parallel D2FT on gemma3-1b, in phase 26's
   processes, on phase 26's model, budget and refreshes. (a) After the
   masked run on the one NCCL rank, ``--sync-mode zero`` and ``zero3`` on
   its schedules (replayed): losses within 1e-6 of the masked run's, B2's
   launches 26 x 3 a direction, each step's bytes by collective equal to
   the plan's ``rs_bytes`` / ``ag_bytes`` / ``ar_bytes``, the moments'
   bytes equal to ``zero_state_byte_report``'s, ZeRO-3's bytes between
   steps within 1 % of the shards and the moments. (b) After the masked
   AdamW run on the mix, the masked sync with SGD, ZeRO-1 with AdamW
   (weight decay 0.01: no gather elided) and with SGD (elidable: fewer
   bytes gathered), ZeRO-3 and streamed ZeRO-3 (the loop's
   ``ParallelConfig(streamed=True)``), two gloo ranks: those checks on
   both ranks every step, against the masked run with the same
   optimizer, the canonical parameters bitwise equal on both ranks, the
   streamed run bitwise equal to ZeRO-3's, ``check_zero3_residency``
   passing, forward-dead gathers elided; p50 step ms, the sync's ms by
   collective and peak memory printed a rank.
   ``python3 chip_smoke.py --only 27`` runs phases 1, 2 and 27 alone,
   with the masked baselines (a partial run that prints no result). To
   keep the whole script inside its limit, the launcher fine-tunes of
   phases 10, 13, 14, 17, 20 and 21 take 3 steps (8, then 6 before phase
   29, 4 before phase 30), phase 26 (a) 3 (4 before phase 30), and phase
   23 3 steps (6, then 4 before phase 30) on 6 of gemma3-1b's 26 layers
   (13 before phase 30); since phase 29 phase 25 and 28 (b) take 2 steps
   (3 before); since phase 30 the runs on the mix 2 steps re-planned at
   step 1, and every rank process stages its meshes' collectives through
   one pinned buffer.
28. multi-axis D2FT — ``repro_torch.launch.train --distributed --mesh``
   with a stage or a tensor axis, two gloo ranks sharing the card (the
   collectives and the pipeline's sends staged through pinned host memory:
   not interconnect numbers), in one ``torch.distributed.run`` of its own
   (this script again, ``--mx-rank``), one process group for both runs,
   each rank printing one JSON line a run. (a) gemma3-1b at full width and
   depth, ``--mesh stage=2``, at phase 26's budget (global batch 4 x 1024,
   M = 4 micro-batches of one sample, n_pf 3 / n_po 1, G 4, AdamW lr
   1e-3, 3 steps (4 before phase 29), re-planned every 2) on phase 26
   (a)'s schedules (replayed): every step's loss within 1e-4 x max(1,
   |loss|) of phase 26 (a)'s one-rank run's first 3, the parameter checksums bitwise equal on both ranks
   after every step, the counter's ``stage`` bytes equal to the gradient
   tree's bytes and the 12 bytes of the loss and its two terms, its
   ``p2p`` bytes (summed over the ranks) to 2 x M x (S - 1) x 1 x 1024 x
   1152 x 4, the data axis's (one rank) ``all_reduce`` bytes to the plan's
   ``ar_bytes``; the stages report (boundaries, loads, makespan ratio,
   bubble), p50 step ms, each kind's ms and each rank's peak memory. (b)
   stablelm-3b at full width on 8 of its 32 layers (full depth holds 11.2
   GB of parameters a rank and moves 10.2 GB of tensor-axis gradients a
   step through gloo), ``--mesh tensor=2``, batch 4 x 512, G = n_heads =
   32, n_pf 3 / n_po 1 of 4, a momentum-free SGD (lr 1e-3), 2 steps, the
   launcher's own schedule: losses within 1e-4 x max(1, |loss|) of a
   one-rank masked ``train.loop.finetune`` of the same 8-layer model on the
   same batches and schedule (replayed), parameters bitwise equal on both
   ranks, ``tp_grad`` bytes equal to the attention and FFN weights' (8 x
   317,194,240 a step), ``tp_act`` bytes to 8 x 4 all-reduces of [4, 512,
   2560] float32. Neither axis has a kernel route: both runs take the
   masked path. ``python3 chip_smoke.py --only 28`` runs phases 1, 2, 26
   (a) and 28 alone (a partial run that prints no result).
29. the elastic layer — ``repro_torch.launch.train --d2ft --kernel
   --distributed --elastic`` on gemma3-1b at full width on 6 of its 26
   layers (one pattern cycle: five windowed layers and one global, so B2
   runs both), phase 26's budget (batch 4 x 1024, n_pf 3 / n_po 1 of 4,
   G 4, AdamW lr 1e-3), re-planned every 2 steps, in phase 28's ranks
   (this script again, ``--mx-rank``, three more runs on its process
   group), the checkpoints in a temporary directory the phase removes
   (it refuses to start with under 12 GB free there). (a) ``--mesh
   data=2 --faults`` a plan the phase writes (rank 1 twice as slow, a
   NaN burst on rank 1 at step 1, rank 1 dropped at step 4),
   ``--ckpt-every 3``, 5 steps: step 1 a guard skip on both ranks with the
   parameters' checksum unchanged; the step-2 refresh's unit times (1,
   1.75) engage capacities, its makespan at most the unmitigated one
   (the ratio printed); at step 4 rank 0 restores ckpt_3 alone (1 step to
   replay) and rank 1 stops, launching no B2 after; B2 12 launches a
   step a rank. Then ``--resume-from ckpt_3.npz --ckpt-every 0 --mesh
   data=1`` on rank 0 alone: its final parameters within 1e-6 of (a)'s
   (the difference printed). (b) ``--faults`` the syncs of steps 1 and 2
   dropped, ``--merge-every 2 --ckpt-every 0``, 6 steps: two sync
   drops, the lo-fi fallback, merges, final mode local; after every merge
   the ranks' parameters bitwise equal and the bytes it sent the mask plan's.
   Printed: step ms, each collective kind's ms, the checkpoints' save and
   load seconds and bytes, each rank's peak memory. ``python3
   chip_smoke.py --only 29`` runs phases 1, 2 and 29 alone (a partial run
   that prints no result).
30. the distributed measurement layer — ``repro_torch.launch.diststep``.
   (a) ``measure_distributed_step(2)`` on gemma3-1b at full width on 6 of
   its 26 layers (phase 29's model), batch 8 x 512 in 8 micro-batches,
   the kernel path (B2 at hd 256), one timed step after a warm-up, in
   phase 28's two ranks (one more ``--mx-rank`` run): JAX's eight
   variants (the all-p_f baseline; the concentrated mix masked, ZeRO-1,
   ZeRO-3, streamed ZeRO-3; the half-live spread masked, ZeRO-1, ZeRO-3)
   and the pipeline at (data 1, stage 2). Printed as one ``DISTSTEP
   {json}`` line (rank 0's record). Checked on both ranks, every
   variant: the mesh's records under the plan's kinds equal its
   ``ar_bytes`` / ``rs_bytes`` / ``ag_bytes``, and priced by
   ``launch.collectives`` its per-rank ``wire``; the other kinds only
   the metrics all-reduce (printed apart with its bytes); the ZeRO-3
   variants all-gather and the masked ones do not; the streamed
   variant's residency check passes; B2's forward and backward launched
   in the measured step of every kernel variant (none in the pipeline's,
   which has no kernel route). The tied 262,144 x 1,152 embedding is 302
   M of the model's 463 M parameters and every variant syncs it, so the
   fractions sit well above the paper's ~0.5: this configuration's own
   numbers. (b) ``measure_elastic(4)`` in one torch.distributed.run of
   four gloo ranks sharing the card, at the function's own tiny config:
   an ``ELASTICM {json}`` line and JAX's code's outcomes at four ranks
   (the dropout of device 5 at step 3 leaves 2 ranks, which replay 1 step
   from ckpt_2 and end within 1e-6 of a fresh resume; one guard skip, at
   step 2; the lo-fi fallback at step 2, merges, final mode local; the
   straggler's mitigation ratio below 1). ``python3 chip_smoke.py --only
   30`` runs phases 1, 2 and 30 alone (a partial run that prints no
   result).

Then one JSON line of the 13 kernel records, the card line again, and as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a card or without the repo's sources beside this file.
"""
from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# gemma3-1b serving trace: more requests than slots (admission mid-flight);
# 1536 and 2048 are multiples of the 512 window above twice it (block-local
# prefill); decode positions pass 512, so local layers skip pages
PROMPT_LENS = (24, 130, 333, 511, 700, 1100, 1536, 2048)
MAX_NEW = (32, 32, 32, 32, 32, 32, 16, 16)
PAGE_SIZE = 16
MAX_SLOTS = 4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, non-tensor-core float32
TF32_FLOP_PER_S = 495e12           # H100 SXM, dense TF32 tensor cores
KERNEL_TOL = 1e-5
GRAD_TOL = 1e-4                    # gated attention dq/dk/dv, float32

# the D2FT fine-tune: the quickstart's batch, split and 68 % budget
FT_BATCH = 40
FT_STEPS = 8
FT_D2FT = dict(n_microbatches=5, n_pf=3, n_po=1)
FT_LR = 0.05

# the LLM D2FT fine-tune on mamba2-130m: the budget of
# examples/d2ft_llm_finetune.py (2 p_f + 1 p_o of 4 micro-batches)
LM_BATCH = 8
LM_SEQ = 2048
LM_STEPS = 3
LM_LR = 1e-3
LM_D2FT = dict(n_microbatches=4, n_pf=2, n_po=1)
SSD_P, SSD_N, SSD_CHUNK = 64, 128, 256         # mamba2-130m's SSD widths

# the gemma3-1b fine-tunes: the JAX launcher's defaults and its docstring's
# budget (3 p_f + 1 p_o of 4 micro-batches); seq 1024 so that full
# fine-tuning (16 GB of weights, gradients and AdamW moments) and the
# [4096, 262144] logits fit beside each other. The D2FT-LoRA run takes the
# LoRA example's own settings (repro_torch/examples/lora_finetune.py)
GM_BATCH = 4
GM_SEQ = 1024
GM_STEPS = 3
GM_LR = 1e-3
GM_D2FT = dict(n_microbatches=4, n_pf=3, n_po=1)

# the recurrentgemma-2b fine-tune: the launcher's defaults (3 p_f + 1 p_o of
# 4 micro-batches, G = n_heads = 10) with its SGD (momentum 0.9: weights,
# gradients and one moment, 3 x 14.2 GB), batch 4 x seq 512, chosen by
# memory before any run (PERF.md, section 4)
RG_BATCH = 4
RG_SEQ = 512
RG_STEPS = 3
RG_LR = 1e-3
RG_D2FT = dict(n_microbatches=4, n_pf=3, n_po=1)
RG_CHUNK = 128                     # repro/models/rglru.py's scan chunk
RG_PARAMS = 3_549_934_080          # the JAX init_model's, by jax.eval_shape

# the olmoe-1b-7b fine-tunes (PERF.md, section 4): the full model's 27.7 GB
# of float32 weights leave no room for a full fine-tune's gradients and
# optimizer state, so full depth runs as D2FT-LoRA (rank 8 on wq/wk/wv and
# per-expert w_up, the LoRA example's SGD 0.1 and n_pf 3 / n_po 0 of 4) and
# the launcher's loop (its SGD, n_pf 3 / n_po 1 of 4, G 16) runs at full
# width on 8 of the 16 layers; batch 4 x seq 512 (capacity 320 of 2048
# tokens x 8 / 64 experts, 384 after the pad to block_c 128)
MO_BATCH = 4
MO_SEQ = 512
MO_STEPS = 3
MO_LR = 1e-3
MO_D2FT = dict(n_microbatches=4, n_pf=3, n_po=1)
MO_LORA_D2FT = dict(n_microbatches=4, n_pf=3, n_po=0)
MO_LORA_TARGETS = ("wq", "wk", "wv", "w_up")
MO_LORA_PARAMS = 26_738_688        # the JAX init_lora's, by jax.eval_shape
MO_LAYERS = 8
MO_PARAMS = 6_919_096_320          # the JAX init_model's, by jax.eval_shape
MO_PARAMS_8 = 3_562_571_776        # the same at 8 layers
MO_BLOCK_C = 128                   # repro/models/moe.py's apply_moe default
ACTS_ALL = ("silu", "gelu", "relu")

# the packed D2FT path on gemma3-1b (phase 23): phase 13's shapes, seed
# and optimizer, at the launcher's budget (3 p_f + 1 p_o of 4 micro-batches
# of one sample: every group gathers all four samples, so this budget
# measures the gather's overhead) and the LLM example's (2 p_f + 1 p_o:
# every group skips one sample)
PK_STEPS = 3                       # 8 took the phase past 150 s
# the first 6 of gemma3-1b's 26 layers (one cycle of five local and one
# global): phase 23 took 140-165 s at full depth, which with phases 26-27
# pushed the whole script near its limit; 13 layers before phase 30, 6 since
# phase 30
PK_LAYERS = 6
PK_BUDGETS = ((3, 1), (2, 1))
PK_PROFILE_BUDGET = (2, 1)
PK_REMAT_STEPS = 2
PK_EXAMPLE_STEPS = 20              # the LLM example's steps on each path

# serving the recurrent and MoE families (phase 24): recurrentgemma-2b's
# and mamba2-130m's trace, prompts 24 to 2040, two of whose requests pass
# recurrentgemma-2b's 2048 window during decode (2030 + 32, 2040 + 24);
# olmoe-1b-7b's, prompts 24 to 1024
RS_PROMPTS = (24, 300, 700, 1100, 1500, 1900, 2030, 2040)
RS_NEW = (32, 32, 32, 32, 24, 24, 32, 24)
MO_SERVE_PROMPTS = (24, 130, 256, 400, 511, 700, 900, 1024)
MO_SERVE_NEW = (16, 16, 16, 16, 16, 16, 16, 16)
MO_SERVE_LAYERS = 16

# the rest of the model surface (phase 25): stablelm-3b through the
# launcher at full size; phi-3-vision-4.2b and hubert-xlarge at full size
# and qwen1.5-32b, mixtral-8x22b and moonshot-v1-16b-a3b at full width,
# cut in depth to fit 80 GB beside their gradients (k of 64, 56 and 48
# layers: about 3.7, 5.4 and 5.4 B parameters), through
# train/loop.py::finetune on the kernel route; the four causal text archs
# served, mixtral-8x22b with one request past its 4096 window
NA_BATCH = 4
NA_SEQ = 512
NA_STEPS = 2
# (a)'s stablelm-3b through the launcher on 16 of its 32 layers (full
# depth before phase 30; phase 28 (b) runs it on 8, serving at full size)
NA_LM_DEPTH = 16
NA_LR = 1e-3
NA_D2FT = dict(n_microbatches=4, n_pf=3, n_po=1)
VL_TEXT = 448                      # + 576 patch rows: 1024 positions
AU_FRAMES = 1024
NA_DEPTH = {"qwen1.5-32b": 4, "mixtral-8x22b": 2, "moonshot-v1-16b-a3b": 8}
NA_SERVE_PROMPTS = (24, 200, 700, 1000)
MX_SERVE_PROMPTS = (24, 300, 1000, 4090)   # 4090 + 16 new pass 4096
NA_SERVE_NEW = 16
# B10 at the served archs' decode shapes: (config, H, n_kv, hd, window),
# lengths past 4096 and a table of 270 pages (4320 positions)
NEW_DECODE_SHAPES = (("qwen1.5-32b", 40, 40, 128, 0),
                     ("mixtral-8x22b", 48, 8, 128, 4096),
                     ("moonshot-v1-16b-a3b", 16, 16, 128, 0))
NEW_DECODE_CASES = (([15, 16, 17, 700], "edges"),
                    ([63, 4095, 4096, 4200], "slot"),
                    ([731, 2063, 4097, 4150], "one"))
NEW_DECODE_NPMAX = 270

# data-parallel D2FT on gemma3-1b (phase 26): phase 13's model, seed,
# budget and optimizer at 3 steps (4 before phase 30), re-planned every
# 2; the paper's concentrated schedule mix (p_f, p_o, p_s shares of the
# subnets) for the second two-rank run; a rank process's time limit
DP_STEPS = 3
DP_REFRESH = 2
# phase 26 (b)'s run on the launcher's schedule: its first plan only, cut
# from 4 steps to keep the whole script inside its time limit
DP_LAUNCHER_STEPS = 2
# phase 26 (b) and 27 (b)'s runs on the concentrated mix, cut from 4 steps
# to 3 to make room for phase 29, then to 2 re-planned at step 1 for
# phase 30: still one re-plan, so zero_relayout runs, and ZeRO-1 SGD's
# elided gather meets ever_live;
# phase 27 (b)'s masked / ZeRO-1 SGD pair on 6 of the 26 layers (one
# pattern cycle: five windowed layers and one global) to keep the whole
# script inside its time limit (its AdamW runs stay at 26: ZeRO-3's
# between-step bytes are held to 1 % of a state that depth shrinks)
DP_MIX_STEPS = 2
DP_MIX_REFRESH = 1
DP_SGD_DEPTH = 6
DP_MIX = (0.4, 0.3, 0.3)
DP_TIMEOUT = 800

# multi-axis D2FT (phase 28): (b)'s depth (stablelm-3b, 8 of 32 layers) and
# a rank process's time limit; (a) takes phase 26's settings, (b) phase
# 25's batch, budget and learning rate
MX_DEPTH = 8
MX_MIX_STEPS = 2        # phase 28 (a) on the concentrated mix: one plan
MX_STEPS = 3            # phase 28 (a) (4 before phase 29): one re-plan

# the elastic layer (phase 29): gemma3-1b at full width on 6 of its 26
# layers (one pattern cycle: five local layers and one global), phase
# 26's budget, re-planned every 2 steps. (a)'s plan: rank 1 twice as
# slow, a NaN burst on rank 1 at step 1, rank 1 dropped at step 4,
# checkpoints every 3 steps, 5 steps (6 would write a ckpt_6 no check
# reads); (b)'s: the syncs of steps 1 and 2 dropped (the lo-fi fallback),
# merged every 2 steps, 6 steps. Two 5.56 GB checkpoints are on the disk
# at once; a rank process's time limit grows by EL_TIMEOUT
EL_DEPTH = 6
EL_STEPS_A = 5
EL_STEPS = 6
EL_CKPT_EVERY = 3
EL_PLAN_A = dict(slowdowns=((1, 2.0),), grad_faults=((1, 1, float("nan")),),
                 dropout=(4, 1))
EL_PLAN_B = dict(dropped_syncs=(1, 2))
EL_MERGE_EVERY = 2
EL_DISK = 12e9
EL_RESUME_TOL = 1e-6
EL_TIMEOUT = 360
EL_LEGS = "ea,er,eb"
MX_UPDATE_TOL = 1e-4    # (b)'s leaf update norms against the one rank's
MX_TIMEOUT = 400

# the distributed measurement layer (phase 30): measure_distributed_step
# on gemma3-1b at full width on 6 of its 26 layers (phase 29's model),
# batch 8 x 512 in 8 micro-batches, the kernel path, one timed step after
# a warm-up, in phase 28's ranks; measure_elastic on four ranks at its own
# config. A rank process's time limit grows by DM_TIMEOUT; EM_TIMEOUT is
# the four-rank run's
DM_DEPTH = 6
DM_BATCH = 8
DM_SEQ = 512
DM_MB = 8
DM_TIME_STEPS = 1
DM_TIMEOUT = 360
EM_RANKS = 4
EM_TIMEOUT = 300


# marks every process this script starts: each inherits the variable (a
# sub-run's value extends the script's), whatever session it makes, so
# what outlives its run is found and stopped
RUN_ENV = "CHIP_SMOKE_RUN"


def _alive(pid) -> bool:
    """Whether ``pid`` is a process that has not yet exited (a zombie has:
    it holds nothing, and its parent or init reaps it)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat[stat.rfind(")") + 2:].split()[0] not in ("Z", "X")


def stop_marked(prefix, what, wait_s=30.0):
    """SIGKILL every other process whose ``RUN_ENV`` is ``prefix`` or
    extends it (``prefix/...``), then wait up to ``wait_s`` for them to
    exit (a process that held the card may take seconds to release it);
    prints each one it stops to stderr. Returns their number."""
    stopped = {}
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit() or int(proc.name) == os.getpid():
            continue
        try:
            env = (proc / "environ").read_bytes().split(b"\0")
            mark = next((e[len(RUN_ENV) + 1:].decode() for e in env
                         if e.startswith(RUN_ENV.encode() + b"=")), None)
            if mark is None or (mark != prefix
                                and not mark.startswith(prefix + "/")):
                continue
            cmd = (proc / "cmdline").read_bytes().replace(b"\0", b" ")
            os.kill(int(proc.name), signal.SIGKILL)
        except (OSError, ValueError):
            continue                  # gone, a zombie, or not ours to read
        stopped[int(proc.name)] = cmd.decode(errors="replace")[:200]
    t_end = time.monotonic() + wait_s
    while any(map(_alive, stopped)) and time.monotonic() < t_end:
        time.sleep(0.1)
    for pid, cmd in stopped.items():
        gone = "" if not _alive(pid) else f" (still exiting after {wait_s} s)"
        print(f"[processes] {what}: stopped {pid} {cmd}{gone}",
              file=sys.stderr, flush=True)
    return len(stopped)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def paged_inputs(torch, gen, lengths, *, n_pages, n_pmax, H=4, n_kv=1,
                 hd=256, ps=PAGE_SIZE, gated=()):
    """Random pools and queries on the card; each slot's table holds
    distinct pages up to its length and is null-padded past it."""
    dev = gen.device
    B = len(lengths)
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    kp = torch.randn((n_pages, ps, n_kv, hd), generator=gen, device=dev)
    vp = torch.randn((n_pages, ps, n_kv, hd), generator=gen, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = torch.zeros((B, n_pmax), dtype=torch.int32, device=dev)
    for b, t in enumerate(lengths):
        n = t // ps + 1
        table[b, :n] = perm[b * n_pmax:b * n_pmax + n]
    g = torch.ones((B, H), device=dev)
    for b, h in gated:
        g[b, h] = 0.0
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, ln, g


def bound(lengths, window, *, H, n_kv, hd, n_pmax, itemsize=4):
    """Least time (ms) for one launch: K/V rows each slot must read, once,
    plus q, the output, the table, lengths and gates, over HBM bandwidth;
    against the QK and PV flops over the float32 peak. Returns (ms, by)."""
    rows = sum(min(t + 1, window) if window else t + 1 for t in lengths)
    B = len(lengths)
    nbytes = (2 * rows * n_kv * hd + 2 * B * H * hd + B * H) * itemsize \
        + (B * n_pmax + B) * 4
    flops = 4 * rows * H * hd                      # QK and PV, 2 each
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def page_check_host_time(torch, new_engine, reqs, n_steps):
    """Host ms per decode step that the page-id range check and the paged
    entry's work outside the kernel launcher take, two ways, each over
    n_steps decode steps of ``reqs`` in a fresh engine from
    ``new_engine()``: as the engine runs (one ``check_page_ids`` of its
    host table a step, then the unchecked entry ``_paged_decode_impl`` at
    every attention layer), and with a range check of the device table
    added before every layer's entry, as the checked entry
    ``ops.paged_decode_attention`` does (its ``.tolist()`` waits for the
    device once a call; the time the host then blocks is part of it).
    The two run in turns (step, per layer, per layer, step). Returns
    {mode: [(host ms per step, range checks per step, entry calls per
    step, wall ms per step), ...]} for modes "step" and "per_layer"."""
    import repro_torch.kernels.ops as kops
    import repro_torch.serving.engine as seng
    entry, launcher, check = (kops._paged_decode_impl,
                              kops.paged_flash_decode, seng.check_page_ids)
    result = {"step": [], "per_layer": []}
    for mode in ("step", "per_layer", "per_layer", "step"):
        outer, inner, checks = [], [], []

        def timed(fn, sink, per_layer=False):
            def call(*a, **k):
                t = time.perf_counter()
                if per_layer:
                    kops.check_page_ids(a[3], a[1].shape[0])
                out = fn(*a, **k)
                sink.append(time.perf_counter() - t)
                return out
            return call

        engine = new_engine()
        for r in reqs:
            engine.submit(r)
        engine.step()                              # admits all of them
        torch.cuda.synchronize()
        n_checks = kops.check_page_ids.calls
        kops._paged_decode_impl = timed(entry, outer, mode == "per_layer")
        kops.paged_flash_decode = timed(launcher, inner)
        seng.check_page_ids = timed(check, checks)
        try:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            kops._paged_decode_impl = entry
            kops.paged_flash_decode = launcher
            seng.check_page_ids = check
        if len(outer) != len(inner) or not outer:
            raise AssertionError(f"{len(outer)} entry calls, {len(inner)} "
                                 "launcher calls")
        result[mode].append((
            1e3 * (sum(outer) - sum(inner) + sum(checks)) / n_steps,
            (kops.check_page_ids.calls - n_checks) / n_steps,
            len(outer) / n_steps, 1e3 * wall / n_steps))
    return result


# decode shapes of configs whose serving is not ported yet, held and timed
# apart from gemma3-1b's: (config, H, n_kv, hd, window)
DECODE_SHAPES = (("recurrentgemma-2b", 10, 1, 256, 2048),
                 ("stablelm-3b", 32, 32, 80, 0),
                 ("phi3-vision-42b", 32, 32, 96, 0))


DECODE_CASES = (([15, 16, 17, 700], "edges"), ([63, 64, 2047, 2063], "slot"),
                ([731, 1131, 1551, 2063], "one"))


def decode_shapes_vs_plain(torch, gen, shapes=DECODE_SHAPES,
                           cases=DECODE_CASES, n_pmax=130):
    """Phase 3's other shapes: B10 at recurrentgemma-2b's decode (10 query
    heads on 1 KV head of 256, two head groups of 5 a block, window 2048)
    and at stablelm-3b's (hd 80) and phi3-vision-42b's (hd 96), 32 heads
    each, against the plain version: lengths at page and run boundaries,
    tables null-padded over whole runs, gated heads and a slot with every
    head gated; <= 1e-5, exact zeros, bitwise equal across two calls."""
    from repro_torch.kernels.ops import paged_decode_attention
    from repro_torch.kernels.paged_decode import paged_decode_ref
    for name, H, n_kv, hd, window in shapes:
        worst = 0.0
        for lengths, which in cases:
            gated = {"edges": ((1, 0), (1, H - 1), (2, 0)),
                     "slot": tuple((3, h) for h in range(H)),
                     "one": ((0, H // 2),)}[which]
            args = paged_inputs(torch, gen, lengths,
                                n_pages=max(600, 4 * n_pmax + 1),
                                n_pmax=n_pmax, H=H, n_kv=n_kv, hd=hd,
                                gated=gated)
            out = paged_decode_attention(*args[:5], g_f=args[5],
                                         window=window)
            again = paged_decode_attention(*args[:5], g_f=args[5],
                                           window=window)
            torch.cuda.synchronize()
            err = float((out - paged_decode_ref(*args, window=window))
                        .abs().max())
            dead = float(out[args[5] == 0].abs().max())
            if err > KERNEL_TOL or dead != 0.0 or \
                    not torch.isfinite(out).all() or \
                    not torch.equal(out, again):
                raise AssertionError(
                    f"kernel vs plain, {name} (H {H} n_kv {n_kv} hd {hd} "
                    f"window {window}) lengths {lengths}: max abs err {err} "
                    f"(tol {KERNEL_TOL}), dead heads {dead}, bitwise equal "
                    f"{torch.equal(out, again)}")
            worst = max(worst, err)
        print(f"[kernel vs plain] paged_decode {name} decode shape: H {H} "
              f"n_kv {n_kv} hd {hd} window {window}, ps {PAGE_SIZE}, n_pmax "
              f"{n_pmax}, lengths {[c[0] for c in cases]} (at page and run "
              f"boundaries), gated heads and a gated slot: max abs err <= "
              f"{worst:.3e}, zeros exact, bitwise equal across two calls",
              flush=True)


def decode_shapes_timing(torch, gen, lengths, n_pmax, tag,
                         shapes=DECODE_SHAPES):
    """Phase 5's other shapes: CUDA-event times of B10 at DECODE_SHAPES
    with the trace's final lengths, through the launcher and alone,
    beside the plain version, gather + SDPA (enable_gqa) and the bytes
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode as pd
    for name, H, n_kv, hd, window in shapes:
        args = paged_inputs(torch, gen, lengths, n_pages=n_pmax * 4 + 1,
                            n_pmax=n_pmax, H=H, n_kv=n_kv, hd=hd)
        B, L = len(lengths), n_pmax * PAGE_SIZE
        q, kp, vp, table, ln, _ = args

        def library():
            idx = table.long()
            keys = kp[idx].reshape(B, L, n_kv, hd).transpose(1, 2)
            vals = vp[idx].reshape(B, L, n_kv, hd).transpose(1, 2)
            pos = torch.arange(L, device="cuda")[None, :]
            t = ln.long()[:, None]
            mask = pos <= t
            if window:
                mask &= pos > t - window
            return F.scaled_dot_product_attention(
                q[:, :, None, :], keys, vals,
                attn_mask=mask[:, None, None, :], enable_gqa=True)[:, :, 0]
        out = torch.empty_like(q)
        ws = torch.empty(pd.workspace_floats(B, H, hd, n_pmax, PAGE_SIZE),
                         device="cuda")
        k_ms = time_ms(torch, lambda: pd.paged_flash_decode(
            *args, window=window))
        alone = time_ms(torch, lambda: pd._decode_call(
            *args, out, ws, window=window))
        p_ms = time_ms(torch, lambda: pd.paged_decode_ref(*args,
                                                          window=window))
        l_ms = time_ms(torch, library)
        b_ms, by = bound(lengths, window, H=H, n_kv=n_kv, hd=hd,
                         n_pmax=n_pmax)
        n_hg = -(-(H // n_kv) // 8)
        print(f"[kernel timing] paged_decode {name} H {H} n_kv {n_kv} hd "
              f"{hd} window {window} lengths {lengths}, split grid "
              f"{(n_kv * n_hg, B, pd.n_splits(n_pmax, PAGE_SIZE))} "
              f"({n_hg} head group(s) a KV head): launcher call {k_ms:.4f} "
              f"ms (kernels alone {alone:.4f} ms), plain {p_ms:.4f} ms, "
              f"library (gather+sdpa) {l_ms:.4f} ms, bound {b_ms:.5f} ms by "
              f"{by}, {b_ms / k_ms:.1%} of bound ({b_ms / alone:.1%} alone) "
              f"{tag}", flush=True)
        del args, out, ws
    torch.cuda.empty_cache()


def attn_inputs(torch, gen, B, H, S, hd):
    """q, k, v, a cotangent and a p_f / p_o / p_s gate mix in the
    fine-tune's 3 : 1 : 1 proportions (slice op = random permutation mod
    5), on the card."""
    q, k, v, do = (torch.randn((B, H, S, hd), generator=gen, device="cuda")
                   for _ in range(4))
    op = torch.randperm(B * H, generator=gen, device="cuda") % 5
    g_f = (op != 4).float().reshape(B, H)
    g_b = (op <= 2).float().reshape(B, H)
    return q, k, v, do, g_f, g_b


def roofline(nbytes, flops):
    """(ms, by): the larger of bytes over HBM bandwidth and FLOPs over the
    float32 peak, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tc_roofline(nbytes, flops):
    """(ms, by) for a kernel whose float32 products run on the tensor
    cores as 3xTF32 (csrc/tf32x3.cuh): three TF32 products for each, so
    3 x flops over the TF32 peak (165 TFLOP/s of float32-accurate work),
    against the bytes over HBM bandwidth."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bwd_alone(torch, q, k, v, o, lse, do, g_b, *, causal, window,
                        live):
    """CUDA-event ms of the attention backward's kernels alone: the
    compaction table and the zero-filled outputs that each launcher call
    builds on the card are made once, outside the timed window (as phases
    18 and 22 do)."""
    from repro_torch.kernels import d2ft_attention as d2a
    _, _, n_disp, idx = d2a._prepare(q, k, v, g_b, live)
    bufs = [torch.zeros_like(q) for _ in range(3)] + [
        torch.empty(q.shape[:3], device="cuda")]
    return time_ms(torch, lambda: d2a._bwd_call(
        q, k, v, o, do, lse, g_b, idx, *bufs, n_disp, causal=causal,
        window=window))


def attention_fwd_alone(torch, q, k, v, g_f, *, causal, window, live):
    """CUDA-event ms of the attention forward's kernel alone: the
    compaction table and the outputs that each launcher call makes are
    made once, outside the timed window."""
    from repro_torch.kernels import d2ft_attention as d2a
    _, _, n_disp, idx = d2a._prepare(q, k, v, g_f, live)
    o, lse = d2a._fwd_outputs(q)
    return time_ms(torch, lambda: d2a._fwd_call(
        q, k, v, g_f, idx, o, lse, n_disp, causal=causal, window=window))


def print_resources(name, tag):
    """The -Xptxas -v registers and spills of each kernel of a source."""
    from repro_torch.kernels import build
    print(f"[{tag}] {name}.cu registers / spill stores / spill loads: "
          + "; ".join(f"{k} {r} / {st} B / {ld} B"
                      for k, r, st, ld in build.resources(name)), flush=True)


def time_ms(torch, fn, *, iters=50, warmup=5):
    """Median CUDA-event time of one call, with L2 flushed before each
    (decode finds a layer's pages cold: 26 layers of pools and 4 GB of
    weights pass through L2 between two launches of one layer)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def attn_tiles(S, causal, window, hd):
    """Live tiles per live slice of each attention kernel with a counter
    (the forward's square tiles, the backward's dQ and dK/dV ones)."""
    from repro_torch.kernels import d2ft_attention as d2a
    return {kind: d2a.kernel_live_tiles(S, causal, window, hd, kind)
            for kind in d2a.KERNEL_KINDS}


def attention_case(torch, q, k, v, do, g_f, g_b, *, causal, window, live):
    """One comparison of the gated attention kernels with their plain
    version: forward and backward through ``gated_flash_attention`` and a
    direct ``flash_fwd`` for lse, executed tiles counted, against the plain
    version and its autograd gradients. Returns (o/lse err, grad err, max
    |plain| of o and of the grads, exact zeros and finite, tile counts,
    the counts the schedule wants)."""
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    with contract.count_tiles("cuda") as tc:
        qk, kk, vk = (t.clone().requires_grad_() for t in (q, k, v))
        out = d2a.gated_flash_attention(
            qk, kk, vk, g_f, g_b, causal=causal, window=window,
            live_fwd=live[0], live_bwd=live[1])
        out.backward(do)
        o2, lse = d2a.flash_fwd(q, k, v, g_f, causal=causal, window=window,
                                live=live[0])
        torch.cuda.synchronize()
        counts = tc.read()
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = d2a.gated_attention_ref(qr, kr, vr, g_f, g_b, causal=causal,
                                  window=window)
    ref.backward(do)
    lse_ref = d2a.gated_attention_lse_ref(q, k, g_f, causal=causal,
                                          window=window)
    out, ref = out.detach(), ref.detach()
    e_f = max(float((out - ref).abs().max()),
              float((lse - lse_ref).abs().max()))
    e_b = max(float((a.grad - b.grad).abs().max())
              for a, b in ((qk, qr), (kk, kr), (vk, vr)))
    s_f = float(ref.abs().max())
    s_b = max(float(t.grad.abs().max()) for t in (qr, kr, vr))
    # (a schedule's layer may hold no dead slice: then nothing to hold)
    zeros = (_dead_max(out, g_f == 0) == 0.0
             and torch.equal(o2, out)
             and bool((lse[g_f == 0] == d2a.LSE_MASKED).all())
             and all(_dead_max(t.grad, g_b == 0) == 0.0
                     for t in (qk, kk, vk))
             and bool(torch.isfinite(out).all()))
    tiles = attn_tiles(q.shape[2], causal, window, q.shape[3])
    want = {"fwd": 2 * n_f * tiles["fwd"], "bwd_dkdv": n_b * tiles["bwd_dkdv"],
            "bwd_dq": n_b * tiles["bwd_dq"], "ssd_fwd": 0, "ssd_bwd": 0,
            "rglru_fwd": 0, "rglru_bwd": 0, "moe_fwd": 0, "moe_bwd": 0}
    return e_f, e_b, s_f, s_b, zeros, counts, want


def attention_vs_plain(torch, gen):
    """Phase 6. Returns the largest errors {"fwd": o/lse, "bwd": grads}."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    # (B, H, S, hd, causal, window, bounds): ViT-small without bounds, at
    # the live counts and above them; causal; sliding window
    cases = [(40, 6, 197, 64, False, 0, None),
             (40, 6, 197, 64, False, 0, "exact"),
             (40, 6, 197, 64, False, 0, "above"),
             (4, 8, 256, 128, True, 0, "above"),
             (4, 4, 512, 64, True, 128, "exact"),
             # stablelm-3b's (hd 80) and phi3-vision-42b's (hd 96)
             # attention at S 1024, causal
             (2, 32, 1024, 80, True, 0, "exact"),
             (2, 32, 1024, 96, True, 0, "above")]
    for B, H, S, hd, causal, window, mode in cases:
        q, k, v, do, g_f, g_b = attn_inputs(torch, gen, B, H, S, hd)
        n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
        live = {None: (None, None), "exact": (n_f, n_b),
                "above": (n_f + 7, n_b + 5)}[mode]
        e_f, e_b, _, _, zeros, counts, want = attention_case(
            torch, q, k, v, do, g_f, g_b, causal=causal, window=window,
            live=live)
        what = (f"B {B} H {H} S {S} hd {hd} causal {causal} window "
                f"{window} bounds {live}")
        if e_f > KERNEL_TOL or e_b > GRAD_TOL or not zeros or \
                counts != want:
            raise AssertionError(
                f"attention kernels vs plain, {what}: o/lse err {e_f} (tol "
                f"{KERNEL_TOL}), grad err {e_b} (tol {GRAD_TOL}), exact "
                f"zeros {zeros}, tiles {counts} != {want}")
        worst = {"fwd": max(worst["fwd"], e_f), "bwd": max(worst["bwd"], e_b)}
        print(f"[attention vs plain] {what}: live {n_f}/{n_b} of {B * H}, "
              f"o/lse err {e_f:.3e}, grad err {e_b:.3e}, zeros exact, "
              f"tiles {counts}", flush=True)
    print(f"[attention vs plain] max abs err fwd {worst['fwd']:.3e} <= "
          f"{KERNEL_TOL}, bwd {worst['bwd']:.3e} <= {GRAD_TOL}", flush=True)
    return worst


def kernel_name(key):
    """A profiler kernel name cut to the kernel and its integer template
    arguments (``moe_bwd_dw_kernel<1>``), mangled or not, whichever way the
    demangler writes the arguments (``<1>``, ``<(int)1>``)."""
    import re
    from repro_torch.kernels import build
    if key.startswith("_Z"):
        return build._demangle(key)
    m = re.search(r"(\w+_kernel)(?:<([^<>]*)>)?", key)
    if not m:
        return key
    args = re.findall(r"\d+", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def profile_steps(torch, step, key, n_prof=3):
    """One warm-up call of step(), then a profiler window over n_prof calls.
    Returns (device busy ms per step, wall ms per step under the profiler,
    idle share, ms per step in kernels whose name holds ``key``, its share
    of busy, the top-8 (ms per step, calls per step, name), and those
    kernels by ``kernel_name``: {name: (ms per step, calls per step)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    # a window late in this process has once come back with no device
    # events at all (CUPTI's records lost): take it again, and say so
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
        busy_us = sum(t for t, _, _ in dev)
        if busy_us > 0:
            break
        print(f"[profile] window {attempt} of 3 saw no device time "
              f"({key} kernels)", flush=True)
    else:
        raise AssertionError("the profiler saw no device time in 3 windows")
    key_us = sum(t for t, _, k in dev if key in k)
    top = [(t / 1e3 / n_prof, c // n_prof, k) for t, c, k in dev[:8]]
    named = {}
    for t, c, k in dev:
        if key in k:
            ms, n = named.get(kernel_name(k), (0.0, 0))
            named[kernel_name(k)] = (ms + t / 1e3 / n_prof, n + c / n_prof)
    return (busy_us / 1e3 / n_prof, 1e3 * wall / n_prof,
            1 - busy_us / 1e6 / wall, key_us / 1e3 / n_prof,
            key_us / busy_us, top, named)


def print_profile(what, prof, key_name, tag, breakdown=False):
    busy, wall, idle, key_ms, share, top, named = prof
    print(f"[profile] {what}: device busy {busy:.3f} ms per step, wall "
          f"{wall:.3f} ms per step under the profiler, idle share "
          f"{idle:.1%}; {key_name} {key_ms:.3f} ms per step ({share:.1%} of "
          f"busy) {tag}")
    print("[profile] top device time per step: " + "; ".join(
        f"{k[:60]} x{c}: {t:.3f} ms" for t, c, k in top), flush=True)
    if breakdown:
        print(f"[profile] {key_name} per step: " + "; ".join(
            f"{k} x{n:g}: {ms:.3f} ms ({ms / busy:.1%} of busy)"
            for k, (ms, n) in sorted(named.items(), key=lambda kv: -kv[1][0])
        ) + f" {tag}", flush=True)


def dw_launches(named):
    """Calls per step of the MoE backward's dW kernels, by template
    argument: <2> dW_up with dW_gate, <1> one of them or dW_down."""
    return {nb: sum(n for k, (_, n) in named.items()
                    if k == f"moe_bwd_dw_kernel<{nb}>") for nb in (1, 2)}


def finetune(torch, np, tag):
    """Phase 7. Returns {"launches": {"fwd", "bwd"}}."""
    from repro_torch.configs import vit_small_paper
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.cost_model import compute_cost
    from repro_torch.core.d2ft import plan_schedule
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.core.scores import compute_scores, vit_blocks
    from repro_torch.data.synthetic import (image_batches, make_image_task,
                                            microbatch_assignment)
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.models.vit import init_vit, vit_loss
    from repro_torch.optim.optimizers import sgd
    from repro_torch.train.loop import finetune_vit, make_vit_step

    cfg = vit_small_paper.CONFIG
    d2 = D2FTConfig(**FT_D2FT)
    n_mb = d2.n_microbatches
    task = make_image_task(3, n_classes=cfg.n_classes,
                           image_size=cfg.image_size)
    scheds = []

    def schedule_fn(step, model, images, labels):       # the quickstart's
        if step % 16 != 0:
            return None
        mbs = list(zip(np.split(images, n_mb), np.split(labels, n_mb)))

        def loss_fn(p, mb):
            return vit_loss(model, torch.as_tensor(mb[0], device="cuda"),
                            torch.as_tensor(mb[1], device="cuda"), cfg)[0]

        bw, fw = compute_scores(loss_fn, dict(model.named_parameters()),
                                vit_blocks, mbs, cfg.n_heads)
        scheds.append(plan_schedule(d2, bw, fw, cfg.n_layers, cfg.n_heads))
        return scheds[-1]

    def run(use_kernel, sched_fn):
        model = init_vit(cfg, seed=0, device="cuda")
        _, _, log = finetune_vit(model, cfg, sgd(FT_LR),
                                 image_batches(task, 5, FT_BATCH, FT_STEPS),
                                 steps=FT_STEPS, schedule_fn=sched_fn,
                                 n_microbatches=n_mb, use_kernel=use_kernel)
        return model, log

    torch.cuda.reset_peak_memory_stats()
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    with contract.count_tiles("cuda") as tc:
        model, log_k = run(True, schedule_fn)
        counts = tc.read()
    launches = {"fwd": d2a.flash_fwd.launches, "bwd": d2a.flash_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    sched = scheds[0]
    mb_of = microbatch_assignment(FT_BATCH, n_mb)
    bounds = live_slice_bounds(sched, mb_of)
    N = FT_BATCH * cfg.n_heads
    tiles = attn_tiles(cfg.n_patches + 1, False, 0,
                       cfg.d_model // cfg.n_heads)
    frac = {k: counts[k] / (FT_STEPS * cfg.n_layers * N * t)
            for k, t in tiles.items()}
    per_step = cfg.n_layers * FT_STEPS
    if launches != {"fwd": per_step, "bwd": per_step}:
        raise AssertionError(f"kernel launches {launches} != {cfg.n_layers} "
                             f"per step x {FT_STEPS} steps each")
    if frac != {"fwd": 0.8, "bwd_dkdv": 0.6, "bwd_dq": 0.6} or \
            bounds != (192, 144):
        raise AssertionError(f"executed tile fractions {frac} (want 0.800 "
                             f"fwd, 0.600 bwd), live bounds {bounds}")
    losses = np.asarray(log_k.losses)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")

    def replay(step, *_):
        return sched if step == 0 else None
    del model
    _, log_m = run(False, replay)
    if d2a.flash_fwd.launches != launches["fwd"]:
        raise AssertionError("the masked path launched the kernel")
    diff = np.abs(losses - np.asarray(log_m.losses))
    lim = 1e-4 * np.maximum(1.0, np.abs(np.asarray(log_m.losses)))
    if not (diff <= lim).all():
        raise AssertionError(f"kernel-path losses {losses.tolist()} vs "
                             f"masked {log_m.losses}: diff {diff.tolist()}")
    # timed in turns, kernel masked full full masked kernel, so that no
    # path gains from running later in the process
    _, log_f = run(True, None)
    rounds = {"kernel": [log_k.step_times], "masked": [log_m.step_times],
              "full": [log_f.step_times]}
    for name in ("full", "masked", "kernel"):
        _, lg = run(name != "masked", None if name == "full" else replay)
        rounds[name].append(lg.step_times)
    p50 = {k: 1e3 * float(np.median(r[0] + r[1])) for k, r in rounds.items()}
    print(f"[fine-tune] ViT-small full size ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads, S {cfg.n_patches + 1}, f32, "
          f"seed 0), batch {FT_BATCH} in {n_mb} micro-batches, n_pf "
          f"{d2.n_pf} n_po {d2.n_po} (compute {compute_cost(sched.table):.0%}),"
          f" SGD lr {FT_LR}, {FT_STEPS} steps: kernel launches {launches}, "
          f"live (sample, group) bounds {bounds} x "
          f"{cfg.n_heads // sched.n_groups} heads per group, executed tile "
          f"fractions fwd {frac['fwd']:.3f} bwd "
          f"{frac['bwd_dkdv']:.3f}/{frac['bwd_dq']:.3f}", flush=True)
    print(f"[fine-tune] losses kernel {[round(float(x), 6) for x in losses]}"
          f" | masked {[round(x, 6) for x in log_m.losses]} | max diff "
          f"{float(diff.max()):.3e}", flush=True)
    print(f"[fine-tune] p50 step ms over 2 x {FT_STEPS} steps: kernel path "
          f"{p50['kernel']:.3f}, masked path {p50['masked']:.3f}, standard "
          f"full fine-tuning (kernel, all-ones gates) {p50['full']:.3f}; "
          f"per round " + ", ".join(
              f"{k} {1e3 * float(np.median(r[0])):.3f} / "
              f"{1e3 * float(np.median(r[1])):.3f}"
              for k, r in rounds.items()) + f" {tag}")
    print(f"[fine-tune] images/s: kernel path "
          f"{FT_BATCH / p50['kernel'] * 1e3:.1f}, masked "
          f"{FT_BATCH / p50['masked'] * 1e3:.1f}, full "
          f"{FT_BATCH / p50['full'] * 1e3:.1f} {tag}")
    print(f"[fine-tune] max_memory_allocated (kernel path, scoring "
          f"included) {peak} bytes ({peak / 2**30:.2f} GiB) {tag}",
          flush=True)

    # where a kernel-path step's time goes
    model = init_vit(cfg, seed=0, device="cuda")
    opt = sgd(FT_LR)
    state = opt.init(dict(model.named_parameters()))
    step = make_vit_step(cfg, opt, True, use_kernel=True)
    gates = gates_from_schedule(sched, mb_of, "cuda")
    images, labels = next(image_batches(task, 5, FT_BATCH, 1))
    x = torch.as_tensor(images, device="cuda")
    y = torch.as_tensor(labels, device="cuda")
    print_profile("3 kernel-path fine-tune steps", profile_steps(
        torch, lambda: step(model, state, x, y, gates, bounds), "d2ft_attn"),
        "d2ft attention kernels", tag)
    return {"launches": launches}


def attention_timing(torch, gen, tag):
    """Phase 8. Returns {"fwd"|"bwd": (ms, plain_ms, library_ms, bound_ms,
    bound_by)} at the fine-tune's shapes and live counts."""
    import torch.nn.functional as F
    from repro_torch.kernels import d2ft_attention as d2a
    B, H, S, hd = FT_BATCH, 6, 197, 64
    q, k, v, do, g_f, g_b = attn_inputs(torch, gen, B, H, S, hd)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    if (n_f, n_b) != (192, 144):
        raise AssertionError(f"live slices {n_f}/{n_b} != 192/144")
    o, lse = d2a.flash_fwd(q, k, v, g_f, causal=False, live=n_f)

    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = d2a.gated_attention_ref(qr, kr, vr, g_f, g_b, causal=False)

    def flat(t, gate):                     # [live, S, hd], gathered once
        return t.reshape(B * H, S, hd)[gate.reshape(-1) != 0].contiguous()

    lq, lk, lv = (flat(t, g_f) for t in (q, k, v))
    bq, bk, bv = (flat(t, g_b).requires_grad_() for t in (q, k, v))
    lib_o = F.scaled_dot_product_attention(bq, bk, bv)
    ldo = flat(do, g_b)
    out = {}
    fwd_bytes = 4 * (3 * n_f * S * hd + B * H * S * hd + B * H * S)
    fwd_flops = n_f * 2 * 2 * S * S * hd
    # both kernels run 3xTF32 on the tensor cores: held to that bound
    out["fwd"] = (
        time_ms(torch, lambda: d2a.flash_fwd(q, k, v, g_f, causal=False,
                                             live=n_f)),
        time_ms(torch, lambda: d2a.gated_attention_ref(q, k, v, g_f, g_b,
                                                       causal=False)),
        time_ms(torch, lambda: F.scaled_dot_product_attention(lq, lk, lv)),
        *tc_roofline(fwd_bytes, fwd_flops))
    # backward: q, k, v, o, do and lse of each live slice read once, dq, dk,
    # dv written for every slice; 5 products per live slice (s recomputed)
    bwd_bytes = 4 * (5 * n_b * S * hd + n_b * S + 3 * B * H * S * hd)
    bwd_flops = n_b * 5 * 2 * S * S * hd
    out["bwd"] = (
        time_ms(torch, lambda: d2a.flash_bwd(q, k, v, g_b, o, lse, do,
                                             causal=False, live=n_b)),
        time_ms(torch, lambda: torch.autograd.grad(
            ref, (qr, kr, vr), do, retain_graph=True)),
        time_ms(torch, lambda: torch.autograd.grad(
            lib_o, (bq, bk, bv), ldo, retain_graph=True)),
        *tc_roofline(bwd_bytes, bwd_flops))
    work = {"fwd": (fwd_bytes, fwd_flops), "bwd": (bwd_bytes, bwd_flops)}
    alone = {"fwd": attention_fwd_alone(torch, q, k, v, g_f, causal=False,
                                        window=0, live=n_f),
             "bwd": attention_bwd_alone(torch, q, k, v, o, lse, do, g_b,
                                        causal=False, window=0, live=n_b)}
    for kind, (k_ms, p_ms, l_ms, b_ms, by) in out.items():
        print(f"[attention timing] d2ft_attention_{kind} B {B} H {H} S {S} "
              f"hd {hd}, live {n_f if kind == 'fwd' else n_b} of {B * H}: "
              f"launcher call {k_ms:.4f} ms (kernels alone, table and "
              f"outputs built outside the window, "
              f"{alone[kind]:.4f} ms), plain {p_ms:.4f} ms, library (sdpa "
              f"{'forward' if kind == 'fwd' else 'autograd backward'} on "
              f"the live slices) {l_ms:.4f} ms; bounds: float32 FMA "
              f"{roofline(*work[kind])[0]:.5f} ms, 3xTF32 tensor cores "
              f"{b_ms:.5f} ms by {by}; held to the 3xTF32 one, "
              f"{b_ms / k_ms:.1%} of it ({b_ms / alone[kind]:.1%} alone) "
              f"{tag}", flush=True)
    for name in ("d2ft_attention_fwd", "d2ft_attention_bwd"):
        print_resources(name, "attention timing")
    # stablelm-3b's and phi3-vision-42b's attention (no path runs them
    # yet): B 2, H 32, S 1024, causal, the fine-tune's 3 : 1 : 1 mix
    for name, hd in (("stablelm-3b", 80), ("phi3-vision-42b", 96)):
        _, _, _, _, g_f, g_b = attn_inputs(torch, gen, 2, 32, 1, hd)
        attention_timing_case(
            torch, gen, "attention timing", f"{name} (causal)", 2, 32, 1024,
            hd, 0, g_f, g_b, int((g_f != 0).sum()), int((g_b != 0).sum()),
            tag)
    return out


def ssd_inputs(torch, gen, B, H, S, P, N, *, g=None, operands=None):
    """Operands of the gated SSD scan, a unit-normal cotangent and gates.
    ``operands`` = (x, da, Bm, Cm) or, by default, the JAX block-kernel
    tests' distributions (x ~ N(0, 1), da = -softplus(N(0, 1)), B and C
    ~ N(0, 0.25)); ``g`` = (g_f, g_b) or a p_f / p_o / p_s mix in the LLM
    fine-tune's 2 : 1 : 1 proportions."""
    if operands is None:
        operands = (
            torch.randn((B, S, H, P), generator=gen, device="cuda"),
            -torch.nn.functional.softplus(
                torch.randn((B, S, H), generator=gen, device="cuda")),
            torch.randn((B, S, N), generator=gen, device="cuda") * 0.5,
            torch.randn((B, S, N), generator=gen, device="cuda") * 0.5)
    dy = torch.randn((B, S, H, P), generator=gen, device="cuda")
    if g is None:
        op = torch.randperm(B * H, generator=gen, device="cuda") % 4
        g = ((op != 3).float().reshape(B, H), (op <= 1).float().reshape(B, H))
    return (*operands, dy, g[0], g[1])


def main_path_operands(torch):
    """x * dt, dt * A, B and C of mamba2-130m's first SSD layer (random
    weights from seed 0) on the launcher's first batch (B 8, S 2048): the
    operands the main path gives the kernels."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_embedding, apply_norm
    from repro_torch.models.transformer import init_model
    cfg = get_config("mamba2-130m")
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = next(lm_batches(0, cfg.vocab_size, LM_BATCH, LM_SEQ, 1))
    d_inner, H, P, N = ssm._dims(cfg.d_model, cfg.ssm)
    with torch.no_grad():
        tokens = torch.as_tensor(batch["tokens"], device="cuda")
        layer = model.layers[0]
        h = apply_norm(layer.norm1, apply_embedding(model.embed, tokens),
                       cfg.norm)
        _, xBC, dt = ssm._split_in(layer.ssd, h, cfg.d_model, cfg.ssm)
        xBC = ssm._causal_conv(xBC, layer.ssd.conv_w, layer.ssd.conv_b)
        xin = xBC[..., :d_inner].reshape(*h.shape[:2], H, P)
        dt = F.softplus(dt + layer.ssd.dt_bias)
        A = -torch.exp(layer.ssd.A_log.float())
        return ((xin * dt[..., None]).contiguous(), (dt * A).contiguous(),
                xBC[..., d_inner:d_inner + N].contiguous(),
                xBC[..., d_inner + N:].contiguous())


def ssd_case(torch, args, chunk, live):
    """One kernel-vs-plain comparison: the kernels through
    ``ops.gated_ssd_scan`` (forward, backward, executed-step counts) and a
    direct ``ssd_fwd`` for prevs; the plain version and its autograd
    gradients in float32 and in float64 on the same inputs. Returns
    (kernel - plain32, plain32 - plain64, kernel - plain64) max abs errors
    as [y, prevs, dx, ddA, dB, dC], the float32 plain version's max |value|
    of each, exact-zero flag, step counts, Sp // Q."""
    import torch.nn.functional as F
    from repro_torch.kernels import contract, ops
    from repro_torch.kernels import d2ft_ssd as d2s
    x, da, Bm, Cm, dy, g_f, g_b = args
    S = x.shape[1]
    Q, Sp = ops._scan_pad(S, chunk)
    with contract.count_tiles("cuda") as tc:
        ins = [t.clone().requires_grad_() for t in (x, da, Bm, Cm)]
        y = ops.gated_ssd_scan(*ins, g_f, g_b, chunk=chunk, live_fwd=live[0],
                               live_bwd=live[1])
        y.backward(dy)
        torch.cuda.synchronize()
        counts = tc.read()
    with torch.no_grad():
        pin = [F.pad(x, (0, 0, 0, 0, 0, Sp - S))] + [
            F.pad(t, (0, 0, 0, Sp - S)) for t in (da, Bm, Cm)]
        _, prevs = d2s.ssd_fwd(*pin, g_f, chunk=Q, live=live[0])
    y = y.detach()
    mine = [y, prevs] + [t.grad for t in ins]
    refs = {}
    for dt in (torch.float32, torch.float64):
        leaves = [t.to(dt, copy=True).requires_grad_()
                  for t in (x, da, Bm, Cm)]
        padded = [F.pad(leaves[0], (0, 0, 0, 0, 0, Sp - S))] + [
            F.pad(t, (0, 0, 0, Sp - S)) for t in leaves[1:]]
        out = d2s.gated_ssd_ref(*padded, g_f.to(dt), g_b.to(dt),
                                chunk=Q)[:, :S]
        out.backward(dy.to(dt))
        with torch.no_grad():
            pv = d2s.gated_ssd_prevs_ref(*padded, g_f.to(dt), chunk=Q)
        refs[dt] = [out.detach(), pv] + [t.grad for t in leaves]
        del out, padded

    def err(a, b):
        return [float((u.double() - v.double()).abs().max())
                for u, v in zip(a, b)]
    zeros = (float(y.transpose(1, 2)[g_f == 0].abs().max()) == 0.0
             and float(prevs[g_f.reshape(-1) == 0].abs().max()) == 0.0
             and float(ins[0].grad.transpose(1, 2)[g_b == 0].abs().max())
             == 0.0
             and float(ins[1].grad.transpose(1, 2)[g_b == 0].abs().max())
             == 0.0)
    steps = {"ssd_fwd": counts["ssd_fwd"], "ssd_bwd": counts["ssd_bwd"]}
    scale = [float(r.abs().max()) for r in refs[torch.float32]]
    return (err(mine, refs[torch.float32]),
            err(refs[torch.float32], refs[torch.float64]),
            err(mine, refs[torch.float64]), scale, zeros, steps, Sp // Q)


def _errs(e):
    return (f"y/prevs {max(e[:2]):.2e}, dx/ddA/dB/dC "
            + "/".join(f"{v:.2e}" for v in e[2:]))


def _scales(r):
    return ("max |plain| y/prevs/dx/ddA/dB/dC "
            + "/".join(f"{v:.3g}" for v in r))


def ssd_vs_plain(torch):
    """Phase 9. Returns the largest errors {"fwd": y/prevs, "bwd": grads}."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, H, P, N, chunk = LM_BATCH, 24, SSD_P, SSD_N, SSD_CHUNK
    operands = main_path_operands(torch)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for S, mode in ((2048, None), (2048, "exact"), (2048, "above"),
                    (1000, "exact"), (1000, None)):
        args = ssd_inputs(torch, gen, B, H, S, P, N,
                          operands=[t[:, :S].contiguous() for t in operands])
        g_f, g_b = args[5:]
        n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
        live = {None: (None, None), "exact": (n_f, n_b),
                "above": (n_f + 7, n_b + 5)}[mode]
        e32, p64, k64, scale, zeros, steps, nc = ssd_case(torch, args,
                                                          chunk, live)
        want = {"ssd_fwd": n_f * nc, "ssd_bwd": n_b * nc}
        e_f, e_b = max(e32[:2]), max(e32[2:])
        what = (f"B {B} H {H} S {S} P {P} N {N} chunk {chunk} bounds {live}")
        if e_f > KERNEL_TOL or e_b > GRAD_TOL or not zeros or steps != want:
            raise AssertionError(
                f"SSD kernels vs plain, {what}: {_errs(e32)} (tol "
                f"{KERNEL_TOL} / {GRAD_TOL}), exact zeros {zeros}, steps "
                f"{steps} != {want}")
        worst = {"fwd": max(worst["fwd"], e_f), "bwd": max(worst["bwd"], e_b)}
        print(f"[ssd vs plain] {what}, the main path's operands: live "
              f"{n_f}/{n_b} of {B * H}, kernel vs plain {_errs(e32)} "
              f"({_scales(scale)}); plain vs its float64 evaluation "
              f"{_errs(p64)}; kernel vs float64 {_errs(k64)}; zeros exact, "
              f"steps {steps}", flush=True)
    # the JAX block-kernel tests' operand scale at these widths: outputs of
    # ~50 and gradients of ~200, where float32's own rounding is of the
    # order of the absolute tolerances; held to them scaled by the plain
    # version's max |value|, err <= tol * max(1, max |plain|)
    args = ssd_inputs(torch, gen, B, H, 2048, P, N)
    e32, p64, k64, scale, zeros, steps, nc = ssd_case(torch, args, chunk,
                                                      (None, None))
    n_f, n_b = int((args[5] != 0).sum()), int((args[6] != 0).sum())
    tols = [KERNEL_TOL] * 2 + [GRAD_TOL] * 4
    over = [i for i, (e, r, t) in enumerate(zip(e32, scale, tols))
            if e > t * max(1.0, r)]
    what = (f"N(0, 1) operands (the JAX tests' scale), S 2048: kernel vs "
            f"plain {_errs(e32)} ({_scales(scale)}); plain vs its float64 "
            f"evaluation {_errs(p64)}; kernel vs float64 {_errs(k64)}")
    if over or not zeros or steps != {"ssd_fwd": n_f * nc,
                                      "ssd_bwd": n_b * nc}:
        raise AssertionError(
            f"SSD kernels vs plain, {what}: outputs {over} over tol x max(1, "
            f"max |plain|) (tol {KERNEL_TOL} / {GRAD_TOL}), exact zeros "
            f"{zeros}, steps {steps}")
    print(f"[ssd vs plain] {what}; each within tol x max(1, max |plain|); "
          f"zeros exact, steps {steps}", flush=True)
    print(f"[ssd vs plain] max abs err fwd {worst['fwd']:.3e} <= "
          f"{KERNEL_TOL}, bwd {worst['bwd']:.3e} <= {GRAD_TOL}", flush=True)
    return worst


def launcher_paths(argv, drive=None, own=None):
    """(run, scheds): run(name) drives ``repro_torch.launch.train.main`` on
    argv plus the path's flags ("kernel": --d2ft --kernel, "masked": --d2ft,
    "packed": --d2ft --packed, "full": none, standard full fine-tuning), or
    ``drive(flags)`` where one is given, or ``own[name]()`` for a path the
    launcher does not run, and returns its TrainLog. The first D2FT run
    keeps its step-0 schedule in ``scheds``; later runs replay it, so every
    path runs on the same schedule."""
    from repro_torch.launch import train as launcher
    from repro_torch.train import loop
    scheds = []
    plan = loop.plan_from_scores

    def recording(*a, **k):
        scheds.append(plan(*a, **k))
        return scheds[-1]

    def replay(*a, **k):
        return scheds[0]

    def run(name):
        loop.plan_from_scores = recording if not scheds else replay
        try:
            if own and name in own:
                return own[name]()
            flags = {"kernel": ["--d2ft", "--kernel"], "masked": ["--d2ft"],
                     "packed": ["--d2ft", "--packed"], "full": []}[name]
            return (drive or launcher.main)(flags if drive else argv + flags)
        finally:
            loop.plan_from_scores = plan
    return run, scheds


def in_turns(np, run, first, last="full"):
    """Step times of every path twice, in turns: ``first`` holds the first
    round's logs of the kernel and masked paths; then ``last``, again
    ``last``, masked, kernel, so that no path gains from running later in
    the process. Returns (p50 ms per path, per-round p50 ms)."""
    rounds = {"kernel": [first["kernel"].step_times],
              "masked": [first["masked"].step_times],
              last: [run(last).step_times]}
    for name in (last, "masked", "kernel"):
        rounds[name].append(run(name).step_times)
    p50 = {k: 1e3 * float(np.median(r[0] + r[1])) for k, r in rounds.items()}
    per = {k: [1e3 * float(np.median(x)) for x in r]
           for k, r in rounds.items()}
    return p50, per


def check_losses(np, log_k, log_m):
    """Finite kernel-path losses within 1e-4 x max(1, |loss|) of the masked
    path's. Returns the largest difference."""
    losses = np.asarray(log_k.losses)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    diff = np.abs(losses - np.asarray(log_m.losses))
    lim = 1e-4 * np.maximum(1.0, np.abs(np.asarray(log_m.losses)))
    if not (diff <= lim).all():
        raise AssertionError(f"kernel-path losses {losses.tolist()} vs "
                             f"masked {log_m.losses}: diff {diff.tolist()}")
    return float(diff.max())


def lm_finetune(torch, np, tag):
    """Phase 10. Returns {"launches": {"fwd", "bwd"}, "gates": layer 0's
    per-head (g_f, g_b) of the step-0 split, "bounds": per-head bounds}."""
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import lm_batches, microbatch_assignment
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_ssd as d2s
    from repro_torch.models.ssm import _dims
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train import loop

    cfg = get_config("mamba2-130m")
    _, H, _, _ = _dims(cfg.d_model, cfg.ssm)
    B, S, n_mb = LM_BATCH, LM_SEQ, LM_D2FT["n_microbatches"]
    run, scheds = launcher_paths(
        ["--arch", "mamba2-130m", "--full", "--batch", str(B), "--seq",
         str(S), "--steps", str(LM_STEPS), "--lr", str(LM_LR),
         "--n-microbatches", str(n_mb), "--n-pf", str(LM_D2FT["n_pf"]),
         "--n-po", str(LM_D2FT["n_po"])])

    torch.cuda.reset_peak_memory_stats()
    d2s.ssd_fwd.launches = d2s.ssd_bwd.launches = 0
    with contract.count_tiles("cuda") as tc:
        log_k = run("kernel")
        counts = tc.read()
    launches = {"fwd": d2s.ssd_fwd.launches, "bwd": d2s.ssd_bwd.launches}
    peak_k = torch.cuda.max_memory_allocated()
    sched = scheds[0]
    mb_of = microbatch_assignment(B, n_mb)
    bounds = live_slice_bounds(sched, mb_of)
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")    # [L, B, G]
    rep = H // sched.n_groups
    nc = S // cfg.ssm.chunk
    live_f = int(g_f.sum()) * rep * nc * LM_STEPS
    live_b = int(g_b.sum()) * rep * nc * LM_STEPS
    total = cfg.n_layers * B * H * nc * LM_STEPS
    frac = {"fwd": counts["ssd_fwd"] / total, "bwd": counts["ssd_bwd"] / total}
    per_step = cfg.n_layers * LM_STEPS
    if launches != {"fwd": per_step, "bwd": per_step}:
        raise AssertionError(f"SSD kernel launches {launches} != "
                             f"{cfg.n_layers} per step x {LM_STEPS} steps")
    if counts["ssd_fwd"] != live_f or counts["ssd_bwd"] != live_b or \
            counts["fwd"] or counts["bwd_dkdv"] or counts["bwd_dq"] or \
            counts["rglru_fwd"] or counts["rglru_bwd"] or \
            counts["moe_fwd"] or counts["moe_bwd"]:
        raise AssertionError(f"executed steps {counts} != the schedule's "
                             f"live (sample, head, chunk) counts "
                             f"{live_f} / {live_b}")
    torch.cuda.reset_peak_memory_stats()
    log_m = run("masked")
    peak_m = torch.cuda.max_memory_allocated()
    if d2s.ssd_fwd.launches != launches["fwd"]:
        raise AssertionError("the masked path launched the kernel")
    diff = check_losses(np, log_k, log_m)
    p50, per = in_turns(np, run, {"kernel": log_k, "masked": log_m})
    print(f"[lm fine-tune] mamba2-130m full size ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {H} SSD heads of {cfg.ssm.head_dim}, N "
          f"{cfg.ssm.state_dim}, chunk {cfg.ssm.chunk}, vocab "
          f"{cfg.vocab_size}, f32, seed 0) through repro_torch.launch.train, "
          f"batch {B} x seq {S} in {n_mb} micro-batches, n_pf "
          f"{LM_D2FT['n_pf']} n_po {LM_D2FT['n_po']}, G {sched.n_groups}, "
          f"AdamW lr {LM_LR}, {LM_STEPS} steps: SSD kernel launches "
          f"{launches}, live (sample, group) bounds {bounds} x {rep} heads "
          f"per group, executed step fractions fwd {frac['fwd']:.3f} bwd "
          f"{frac['bwd']:.3f} (= the schedule's live counts)", flush=True)
    print(f"[lm fine-tune] losses kernel "
          f"{[round(float(x), 6) for x in log_k.losses]} | masked "
          f"{[round(x, 6) for x in log_m.losses]} | max diff {diff:.3e}",
          flush=True)
    print(f"[lm fine-tune] p50 step ms over 2 x {LM_STEPS} steps: kernel path "
          f"{p50['kernel']:.3f}, masked path {p50['masked']:.3f}, standard "
          f"full fine-tuning (d2ft off, plain scan) {p50['full']:.3f}; per "
          f"round " + ", ".join(f"{k} {r[0]:.3f} / {r[1]:.3f}"
                                for k, r in per.items()) + f" {tag}")
    print(f"[lm fine-tune] tokens/s: kernel path "
          f"{B * S / p50['kernel'] * 1e3:.1f}, masked "
          f"{B * S / p50['masked'] * 1e3:.1f}, full "
          f"{B * S / p50['full'] * 1e3:.1f} {tag}")
    print(f"[lm fine-tune] max_memory_allocated, scoring included: kernel "
          f"path {peak_k} bytes ({peak_k / 2**30:.2f} GiB), masked path "
          f"{peak_m} bytes ({peak_m / 2**30:.2f} GiB) {tag}", flush=True)

    # where a kernel-path step's time goes
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw(LM_LR)
    state = opt.init(dict(model.named_parameters()))
    step = loop.make_train_step(cfg, opt, use_gates=True, use_kernel=True,
                                live_bounds=bounds)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(0, cfg.vocab_size, B, S, 1)).items()}
    gates = (g_f.cuda(), g_b.cuda())
    print_profile("3 kernel-path LM fine-tune steps", profile_steps(
        torch, lambda: step(model, state, batch, gates), "ssd_"),
        "d2ft SSD kernels", tag)
    del model, state, batch
    torch.cuda.empty_cache()
    gh_f = torch.repeat_interleave(g_f[0], rep, dim=1).cuda()
    gh_b = torch.repeat_interleave(g_b[0], rep, dim=1).cuda()
    return {"launches": launches, "gates": (gh_f, gh_b),
            "bounds": (bounds[0] * rep, bounds[1] * rep)}


def ssd_alone(torch, d2s, x, da, Bm, Cm, dy, g_f, g_b, prevs, Q, live):
    """(forward, backward) callables of the SSD kernels alone: outputs and
    workspaces made once, outside the timed window (the launchers fill
    nothing and build no table, so that is all they add)."""
    N = Bm.shape[-1]
    fb, bb = d2s._fwd_buffers(x, N, Q), d2s._bwd_buffers(x, N, Q)
    nf = d2s._prepare(x, da, Bm, Cm, g_f, Q, live[0])[2]
    nb = d2s._prepare(x, da, Bm, Cm, g_b, Q, live[1])[2]
    return (lambda: d2s._fwd_call(x, da, Bm, Cm, g_f, fb, nf, Q),
            lambda: d2s._bwd_call(x, da, Bm, Cm, g_b, prevs, dy, bb, nb, Q))


def ssd_timing(torch, train, tag):
    """Phase 11. Returns {"fwd"|"bwd": (ms, plain_ms, bound_ms, bound_by)}
    at phase 10's shapes, layer 0's gates and the per-head bounds; prints
    the same launcher and alone times with both bounds at every slice live
    and at one request's prefill (B 1, S 8192)."""
    from repro_torch.kernels import d2ft_ssd as d2s
    gen = torch.Generator(device="cuda").manual_seed(11)
    H, P, N, Q = 24, SSD_P, SSD_N, SSD_CHUNK
    ones = {B: (torch.ones((B, H), device="cuda"),) * 2 for B in (1, LM_BATCH)}
    occ = {kind: d2s.blocks_per_sm(kind, P, N) for kind in ("fwd", "bwd")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for what, B, S, g, bounds in (
            ("layer 0's gates", LM_BATCH, LM_SEQ, train["gates"],
             train["bounds"]),
            ("every slice live", LM_BATCH, LM_SEQ, ones[LM_BATCH],
             (LM_BATCH * H,) * 2),
            ("one request's prefill", 1, 8192, ones[1], (H, H))):
        x, da, Bm, Cm, dy, g_f, g_b = ssd_inputs(torch, gen, B, H, S, P, N,
                                                 g=g)
        lf, lb = bounds
        _, prevs = d2s.ssd_fwd(x, da, Bm, Cm, g_f, chunk=Q, live=lf)
        g_np, b_np = g_f.cpu().numpy(), g_b.cpu().numpy()
        fl = d2s.needed_flops(g_np, b_np, S, P, N, chunk=Q)
        by = d2s.needed_bytes(g_np, b_np, S, P, N, chunk=Q)
        alone = ssd_alone(torch, d2s, x, da, Bm, Cm, dy, g_f, g_b, prevs, Q,
                          bounds)
        calls = {"fwd": lambda: d2s.ssd_fwd(x, da, Bm, Cm, g_f, chunk=Q,
                                            live=lf),
                 "bwd": lambda: d2s.ssd_bwd(x, da, Bm, Cm, g_b, prevs, dy,
                                            chunk=Q, live=lb)}
        plain = {}
        if not out:                      # the plain version at phase 10's
            refs = [t.clone().requires_grad_() for t in (x, da, Bm, Cm)]
            ref = d2s.gated_ssd_ref(*refs, g_f, g_b, chunk=Q)
            plain = {"fwd": time_ms(torch, lambda: d2s.gated_ssd_ref(
                         x, da, Bm, Cm, g_f, g_b, chunk=Q), iters=20),
                     "bwd": time_ms(torch, lambda: torch.autograd.grad(
                         ref, refs, dy, retain_graph=True), iters=20)}
        live = {"fwd": int((g_f != 0).sum()), "bwd": int((g_b != 0).sum())}
        for i, (kind, fn) in enumerate(calls.items()):
            k_ms = time_ms(torch, fn, iters=20)
            a_ms = time_ms(torch, alone[i], iters=20)
            fma_ms, _ = roofline(by[i], fl[i])
            b_ms, bb = tc_roofline(by[i], fl[i])
            p_txt = (f", plain {plain[kind]:.4f} ms, library none"
                     if plain else "")
            print(f"[ssd timing] d2ft_ssd_{kind} B {B} S {S} H {H} P {P} N "
                  f"{N} chunk {Q}, {what}: live {live[kind]} of {B * H} "
                  f"(bound {bounds[i]}): launcher call {k_ms:.4f} ms "
                  f"(kernels alone, outputs and workspaces allocated "
                  f"outside the window, {a_ms:.4f} ms){p_txt}; bounds "
                  f"3xTF32 {b_ms:.5f} ms by {bb}, float32 FMA {fma_ms:.5f} "
                  f"ms ({fl[i] / 1e9:.3f} GFLOP with C.B^T once per "
                  f"(sample, chunk), causal halves; {by[i] / 1e6:.1f} MB); "
                  f"{b_ms / k_ms:.1%} of the 3xTF32 bound ({b_ms / a_ms:.1%} "
                  f"alone) {tag}", flush=True)
            if plain:
                out[kind] = (k_ms, plain[kind], b_ms, bb)
        grids = d2s.launch_grids(B, S, H, P, N, Q)
        for kind, per_sm in occ.items():
            print(f"[ssd timing] d2ft_ssd_{kind} at B {B} S {S}, grid, "
                  f"blocks an SM, waves on {sms} SMs: " + "; ".join(
                      f"{k} {g} {per_sm[k]} "
                      f"{math.prod(g) / (sms * per_sm[k]):.2f}"
                      for k, g in grids[kind].items()), flush=True)
        del x, da, Bm, Cm, dy, prevs, alone, calls
        torch.cuda.empty_cache()
    for name in ("d2ft_ssd_fwd", "d2ft_ssd_bwd"):
        print_resources(name, "ssd timing")
    return out


def gemma_attention_operands(torch):
    """Post-rope q and kv-expanded k, v [B, H, S, hd] of gemma3-1b's layer 0
    (local, window 512) and layer 5 (global), random weights from seed 0
    (the launcher's), on phase 13's first batch (B 4, S 1024): the
    operands the main path gives the hd-256 kernels."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import (apply_embedding, apply_norm,
                                           apply_rope)
    from repro_torch.models.transformer import apply_block, init_model
    cfg = get_config("gemma3-1b")
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = next(lm_batches(0, cfg.vocab_size, GM_BATCH, GM_SEQ, 1))
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    pos = torch.arange(GM_SEQ, device="cuda")[None, :]
    out = {}
    with torch.no_grad():
        x = apply_embedding(model.embed,
                            torch.as_tensor(batch["tokens"], device="cuda"))
        for i, (p, kind) in enumerate(zip(model.layers, cfg.layer_kinds)):
            if i in (0, 5):
                h = apply_norm(p.norm1, x, cfg.norm)
                q, k, v = attn._project_qkv(p.attn, h, H, cfg.n_kv_heads, hd)
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
                out[i] = tuple(attn._repeat_kv(t, H).transpose(1, 2)
                               .contiguous() for t in (q, k, v))
            if i == 5:
                break
            x, _ = apply_block(p, x, kind, cfg)
    del model
    torch.cuda.empty_cache()
    return cfg, out


def hd256_attention_vs_plain(torch, gen, label, cfg, B, S, operands,
                             unit_windows):
    """The hd-256 attention kernels against their plain version on the
    main path's operands, ``operands`` = [(layer, (q, k, v), window)],
    without compaction bounds, at the bounds and above them, and on N(0, 1)
    operands at each window of ``unit_windows``, under a p_f / p_o / p_s
    mix of per-head gates. Returns the largest errors {"fwd": o/lse,
    "bwd": grads} over the main path's operands."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    cases = [(f"layer {layer}'s operands", qkv, window, mode)
             for layer, qkv, window in operands
             for mode in (None, "exact", "above")]
    cases += [("N(0, 1) operands", None, window, "exact")
              for window in unit_windows]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for what, qkv, window, mode in cases:
        q, k, v, do, g_f, g_b = attn_inputs(torch, gen, B, H, S, hd)
        if qkv is not None:
            q, k, v = qkv
        n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
        live = {None: (None, None), "exact": (n_f, n_b),
                "above": (n_f + 3, n_b + 2)}[mode]
        e_f, e_b, s_f, s_b, zeros, counts, want = attention_case(
            torch, q, k, v, do, g_f, g_b, causal=True, window=window,
            live=live)
        # the main path's operands are held to the absolute limits; the
        # N(0, 1) case to them scaled by max(1, max |plain|), as phase 9
        scaled = qkv is None
        lim_f = KERNEL_TOL * (max(1.0, s_f) if scaled else 1.0)
        lim_b = GRAD_TOL * (max(1.0, s_b) if scaled else 1.0)
        what = (f"{what}, B {B} H {H} S {S} hd {hd} causal window {window} "
                f"bounds {live}")
        if e_f > lim_f or e_b > lim_b or not zeros or counts != want:
            raise AssertionError(
                f"{label}, {what}: o/lse err {e_f} (limit {lim_f}), grad err "
                f"{e_b} (limit {lim_b}), exact zeros {zeros}, tiles {counts} "
                f"!= {want}")
        if not scaled:
            worst = {"fwd": max(worst["fwd"], e_f),
                     "bwd": max(worst["bwd"], e_b)}
        print(f"[{label}] {what}: live {n_f}/{n_b} of {B * H}, o/lse err "
              f"{e_f:.3e} (max |plain o| {s_f:.3g}), grad err {e_b:.3e} (max "
              f"|plain grad| {s_b:.3g}), zeros exact, tiles {counts}",
              flush=True)
    print(f"[{label}] max abs err on the main path's operands fwd "
          f"{worst['fwd']:.3e} <= {KERNEL_TOL}, bwd {worst['bwd']:.3e} <= "
          f"{GRAD_TOL}", flush=True)
    return worst


def gemma_attention_vs_plain(torch, gen):
    """Phase 12. Returns the largest errors {"fwd": o/lse, "bwd": grads}
    over the main path's operands."""
    cfg, operands = gemma_attention_operands(torch)
    return hd256_attention_vs_plain(
        torch, gen, "hd-256 attention vs plain", cfg, GM_BATCH, GM_SEQ,
        [(0, operands[0], cfg.window), (5, operands[5], 0)],
        (cfg.window, 0))


def schedule_tiles(sched, mb_of, cfg, steps, seq=GM_SEQ):
    """Attention tiles the schedule makes each kernel (forward, dK/dV, dQ)
    execute in ``steps`` steps at length ``seq``, and those full
    fine-tuning would: per layer, the live (sample, head) slices times the
    kernel's live tiles per slice under that layer's causal, window or
    (an encoder's) full mask. Returns two {kind: tiles}: the schedule's
    and full's."""
    from repro_torch.core.schedule import gates_from_schedule
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")       # [L, B, G]
    rep = cfg.n_heads // sched.n_groups
    want = dict.fromkeys(("fwd", "bwd_dkdv", "bwd_dq"), 0)
    full = dict.fromkeys(want, 0)
    for layer, kind in enumerate(cfg.layer_kinds):
        window = cfg.window if kind == "attn_local" else 0
        tiles = attn_tiles(seq, cfg.causal or window > 0, window,
                           cfg.resolved_head_dim)
        for k in want:
            g = g_f if k == "fwd" else g_b
            want[k] += steps * int(g[layer].sum()) * rep * tiles[k]
            full[k] += steps * g_f.shape[1] * cfg.n_heads * tiles[k]
    return want, full


def launcher_finetune(torch, np, tag, arch, label, B, S, steps, lr, d2,
                      head_layers, call=None):
    """Phases 13 and 25a: ``repro_torch.launch.train --arch <arch> --full
    --d2ft --kernel`` (AdamW, batch B x seq S in d2's micro-batches, G =
    the heads): launches per step, executed tile fractions from the device
    counter equal to the schedule's, finite losses within 1e-4 x max(1,
    |loss|) of the masked path; p50 step ms of the kernel path, the masked
    path and standard full fine-tuning (each twice, in turns), tokens/s,
    peak memory, a profiler window. ``call``: a list that takes B2's
    first call (its operands). Returns {"launches": {"fwd", "bwd"},
    "heads": {layer: per-head (g_f, g_b)} of the step-0 split for
    ``head_layers``, "bounds": per-head bounds}."""
    import contextlib
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import lm_batches, microbatch_assignment
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.models import attention as attn_mod
    from repro_torch.launch import train as launcher
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train import loop

    # the launcher's config (a caller may have cut its depth)
    cfg = launcher.get_config(arch)
    n_mb = d2["n_microbatches"]
    run, scheds = launcher_paths(
        ["--arch", arch, "--full", "--batch", str(B), "--seq", str(S),
         "--steps", str(steps), "--lr", str(lr), "--n-microbatches",
         str(n_mb), "--n-pf", str(d2["n_pf"]), "--n-po", str(d2["n_po"])])

    torch.cuda.reset_peak_memory_stats()
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    grab = contextlib.nullcontext() if call is None else \
        capture_first(torch, attn_mod, "gated_flash_attention", call)
    with contract.count_tiles("cuda") as tc, grab:
        log_k = run("kernel")
        counts = tc.read()
    launches = {"fwd": d2a.flash_fwd.launches, "bwd": d2a.flash_bwd.launches}
    peak_k = torch.cuda.max_memory_allocated()
    sched = scheds[0]
    mb_of = microbatch_assignment(B, n_mb)
    bounds = live_slice_bounds(sched, mb_of)
    rep = cfg.n_heads // sched.n_groups
    want, full = schedule_tiles(sched, mb_of, cfg, steps, S)
    frac = {k: counts[k] / full[k] for k in want}
    per_step = cfg.n_layers * steps
    if launches != {"fwd": per_step, "bwd": per_step}:
        raise AssertionError(f"attention kernel launches {launches} != "
                             f"{cfg.n_layers} per step x {steps} steps")
    if counts != {**want, "ssd_fwd": 0, "ssd_bwd": 0, "rglru_fwd": 0,
                  "rglru_bwd": 0, "moe_fwd": 0, "moe_bwd": 0}:
        raise AssertionError(f"executed tiles {counts} != the schedule's "
                             f"{want}")
    torch.cuda.reset_peak_memory_stats()
    log_m = run("masked")
    peak_m = torch.cuda.max_memory_allocated()
    if d2a.flash_fwd.launches != launches["fwd"]:
        raise AssertionError("the masked path launched the kernel")
    diff = check_losses(np, log_k, log_m)
    torch.cuda.reset_peak_memory_stats()
    p50, per = in_turns(np, run, {"kernel": log_k, "masked": log_m})
    peak_all = torch.cuda.max_memory_allocated()
    print(f"[{label}] {arch} at full width ({cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} query heads and {cfg.n_kv_heads} KV "
          f"head(s) of {cfg.resolved_head_dim}, window {cfg.window}, "
          f"{cfg.norm} norm, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, f32, "
          f"seed 0) through repro_torch.launch.train, batch {B} x seq {S} "
          f"in {n_mb} micro-batches, n_pf {d2['n_pf']} n_po {d2['n_po']}, G "
          f"{sched.n_groups}, AdamW lr {lr}, {steps} steps: attention "
          f"kernel launches {launches}, live (sample, group) bounds {bounds} "
          f"x {rep} heads per group, executed tile fractions fwd "
          f"{frac['fwd']:.3f} bwd {frac['bwd_dkdv']:.3f}/{frac['bwd_dq']:.3f}"
          f" (= the schedule's: {want} of {full} tiles)",
          flush=True)
    print(f"[{label}] losses kernel "
          f"{[round(float(x), 6) for x in log_k.losses]} | masked "
          f"{[round(x, 6) for x in log_m.losses]} | max diff {diff:.3e}",
          flush=True)
    print(f"[{label}] p50 step ms over 2 x {steps} steps: kernel "
          f"path {p50['kernel']:.3f}, masked path {p50['masked']:.3f}, "
          f"standard full fine-tuning (d2ft off, plain attention) "
          f"{p50['full']:.3f}; per round " + ", ".join(
              f"{k} {r[0]:.3f} / {r[1]:.3f}" for k, r in per.items())
          + f" {tag}")
    print(f"[{label}] tokens/s: kernel path "
          f"{B * S / p50['kernel'] * 1e3:.1f}, masked "
          f"{B * S / p50['masked'] * 1e3:.1f}, full "
          f"{B * S / p50['full'] * 1e3:.1f} {tag}")
    print(f"[{label}] max_memory_allocated, scoring included: kernel "
          f"path {peak_k} bytes ({peak_k / 2**30:.2f} GiB), masked path "
          f"{peak_m} bytes ({peak_m / 2**30:.2f} GiB), the largest of the "
          f"timed rounds (full fine-tuning's AdamW state included) "
          f"{peak_all} bytes ({peak_all / 2**30:.2f} GiB) {tag}", flush=True)

    # where a kernel-path step's time goes
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw(lr)
    state = opt.init(dict(model.named_parameters()))
    step = loop.make_train_step(cfg, opt, use_gates=True, use_kernel=True,
                                live_bounds=bounds)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(0, cfg.vocab_size, B, S, 1)).items()}
    gates = (g_f.cuda(), g_b.cuda())
    print_profile(f"3 kernel-path {arch} fine-tune steps", profile_steps(
        torch, lambda: step(model, state, batch, gates), "d2ft_attn"),
        "d2ft attention kernels", tag, breakdown=True)
    del model, state, batch, opt, step
    torch.cuda.empty_cache()
    heads = {layer: tuple(torch.repeat_interleave(g[layer], rep, dim=1)
                          .cuda() for g in (g_f, g_b))
             for layer in head_layers}
    return {"launches": launches, "heads": heads,
            "bounds": (bounds[0] * rep, bounds[1] * rep)}


def lora_cases(torch, x, lora_w, gen):
    """B3 against its plain version on phase 14's own layer-0 operands (the
    normed hidden states x [4096, 1152] against wq, wk, wv with the trained
    A, B, scale 1) and on the ragged path (M 4095 x N 1000 of x and wq)
    at ranks 1, 8, 64 and 240 (A, B at init_lora's and a trained adapter's
    scales), each against ``lora_matmul_ref`` and x @ (W + s·A@B), within
    1e-5 x max(1, max |plain|). Returns the largest absolute error."""
    from repro_torch.kernels import lora_matmul as lm
    cases = [(name, x, w, a, b) for name, (w, a, b) in lora_w.items()]
    K = x.shape[1]
    w_r = lora_w["wq"][0][:, :1000].contiguous()
    for r in (1, 8, 64, 240):
        a = torch.randn((K, r), generator=gen, device="cuda") / K ** 0.5
        b = torch.randn((r, 1000), generator=gen, device="cuda") / r ** 0.5
        cases.append((f"ragged r {r}", x[:4095].contiguous(), w_r, a, b))
    worst = 0.0
    for name, xx, w, a, b in cases:
        y = lm.lora_matmul(xx, w, a, b, 1.0)
        ref = lm.lora_matmul_ref(xx, w, a, b, 1.0)
        merged = xx @ (w + 1.0 * a @ b)
        scale = float(ref.abs().max())
        e_ref = float((y - ref).abs().max())
        e_m = float((y - merged).abs().max())
        lim = KERNEL_TOL * max(1.0, scale)
        if e_ref > lim or e_m > lim or not torch.isfinite(y).all():
            raise AssertionError(
                f"LoRA kernel vs plain, {name} M {xx.shape[0]} K {K} N "
                f"{w.shape[1]} r {a.shape[1]}: err {e_ref} vs the plain "
                f"version, {e_m} vs the merged product (limit {lim})")
        worst = max(worst, e_ref)
        print(f"[lora vs plain] {name}: M {xx.shape[0]} K {K} N {w.shape[1]} "
              f"r {a.shape[1]}: err {e_ref:.3e} vs lora_matmul_ref, {e_m:.3e} "
              f"vs x @ (W + s A@B), max |plain| {scale:.3g}, limit "
              f"{lim:.3g}", flush=True)
    return worst


def gemma_lora(torch, np, tag):
    """Phase 14. Returns {"launches": {"lora", "fwd", "bwd"}, "err": B3's
    largest error, "wq": (x, W, A, B) of layer 0's wq}."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import init_lora, lora_param_count, lora_params
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import lm_batches, microbatch_assignment
    from repro_torch.examples import lora_finetune as ex
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.models.layers import apply_embedding, apply_norm
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import sgd

    cfg = get_config("gemma3-1b")
    B, S = GM_BATCH, GM_SEQ
    kw = dict(device="cuda", batch=B, seq=S, steps=GM_STEPS)
    torch.cuda.reset_peak_memory_stats()
    lm.lora_matmul.launches = 0
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    with contract.count_tiles("cuda") as tc:
        model, lora, sched, y, log_k = ex.run(cfg, use_kernel=True, **kw)
        counts = tc.read()
    launches = {"lora": lm.lora_matmul.launches,
                "fwd": d2a.flash_fwd.launches, "bwd": d2a.flash_bwd.launches}
    peak_k = torch.cuda.max_memory_allocated()
    per_step = cfg.n_layers * GM_STEPS
    if launches != {"lora": 1, "fwd": per_step, "bwd": per_step}:
        raise AssertionError(f"kernel launches {launches} != 1 fused LoRA "
                             f"call and {cfg.n_layers} attention launches "
                             f"per step x {GM_STEPS} steps")
    mb_of = microbatch_assignment(B, ex.D2.n_microbatches)
    want, full = schedule_tiles(sched, mb_of, cfg, GM_STEPS)
    if counts != {**want, "ssd_fwd": 0, "ssd_bwd": 0, "rglru_fwd": 0,
                  "rglru_bwd": 0, "moe_fwd": 0, "moe_bwd": 0}:
        raise AssertionError(f"executed tiles {counts} != the schedule's "
                             f"{want}")
    frac = {k: counts[k] / full[k] for k in want}
    n_adapters = lora_param_count(lora)
    want_n = cfg.n_layers * (
        cfg.d_model * ex.RANK + ex.RANK * cfg.n_heads * cfg.resolved_head_dim
        + 2 * (cfg.d_model * ex.RANK
               + ex.RANK * cfg.n_kv_heads * cfg.resolved_head_dim))
    if n_adapters != want_n or n_adapters != 1_038_336:
        raise AssertionError(f"{n_adapters} adapter parameters != {want_n}")
    # the frozen base is the seed-0 model bit for bit; the adapters moved
    fresh = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    same = all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 fresh.parameters()))
    init = init_lora(torch.Generator(device="cuda").manual_seed(1),
                     dict(fresh.named_parameters()), rank=ex.RANK)
    moved = all(not torch.equal(ab[k], init[n][k])
                for n, ab in lora.items() for k in ("a", "b"))
    if not same or not moved:
        raise AssertionError(f"base bit-identical {same}, adapters moved "
                             f"{moved}")
    # the example's fused call on the card against its plain version
    xd = torch.randn((128, cfg.d_model),
                     generator=torch.Generator(device="cuda").manual_seed(2),
                     device="cuda")
    ab0 = init["layers.0.attn.wq"]
    y_ref = lm.lora_matmul_ref(xd, fresh.layers[0].attn.wq.detach(),
                               ab0["a"].detach(), ab0["b"].detach(),
                               ex.FUSED_SCALE)
    e_y = float((y - y_ref).abs().max())
    if e_y > KERNEL_TOL * max(1.0, float(y_ref.abs().max())):
        raise AssertionError(f"the fused call differs from its plain "
                             f"version by {e_y}")
    del fresh, init, xd, y_ref
    torch.cuda.empty_cache()
    # B3 vs plain on this run's own layer-0 operands
    batch = next(lm_batches(0, cfg.vocab_size, B, S, 1))
    with torch.no_grad():
        tokens = torch.as_tensor(batch["tokens"], device="cuda")
        layer = model.layers[0]
        x = apply_norm(layer.norm1, apply_embedding(model.embed, tokens),
                       cfg.norm).reshape(B * S, cfg.d_model).contiguous()
        lora_w = {t: (getattr(layer.attn, t).detach(),
                      lora[f"layers.0.attn.{t}"]["a"].detach(),
                      lora[f"layers.0.attn.{t}"]["b"].detach())
                  for t in ("wq", "wk", "wv")}
        err = lora_cases(torch, x, lora_w,
                         torch.Generator(device="cuda").manual_seed(14))
    # where a kernel-path LoRA step's time goes
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
    opt = sgd(ex.LR)
    state = opt.init(lora_params(lora))
    step = ex.make_lora_step(model, cfg, opt, use_kernel=True)
    bt = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    gates = (g_f.cuda(), g_b.cuda())
    bounds = live_slice_bounds(sched, mb_of)
    prof = profile_steps(torch, lambda: step(lora, state, bt, gates, bounds),
                         "d2ft_attn")
    wq = (x, *lora_w["wq"])
    del model, lora, state, step, bt, lora_w
    torch.cuda.empty_cache()

    # the masked path on the same schedule, plain LoRA without D2FT, then
    # each again in turns
    runs = {"kernel": dict(use_kernel=True, sched=sched),
            "masked": dict(sched=sched), "plain": dict(d2=None)}
    logs = {"kernel": [log_k]}
    peaks = {"kernel": peak_k}
    for name in ("masked", "plain", "plain", "masked", "kernel"):
        torch.cuda.reset_peak_memory_stats()
        before = d2a.flash_fwd.launches
        logs.setdefault(name, []).append(ex.run(cfg, **runs[name], **kw)[-1])
        peaks[name] = max(peaks.get(name, 0),
                          torch.cuda.max_memory_allocated())
        if d2a.flash_fwd.launches - before != \
                (per_step if name == "kernel" else 0):
            raise AssertionError(f"the {name} path launched the attention "
                                 f"kernel {d2a.flash_fwd.launches - before} "
                                 "times")
        torch.cuda.empty_cache()
    diff = check_losses(np, log_k, logs["masked"][0])
    p50 = {k: 1e3 * float(np.median(v[0].step_times + v[1].step_times))
           for k, v in logs.items()}
    print(f"[lora fine-tune] D2FT-LoRA on gemma3-1b full size through "
          f"repro_torch.examples.lora_finetune: rank {ex.RANK} on "
          f"{'/'.join(('wq', 'wk', 'wv'))} ({n_adapters} adapter parameters = "
          f"lora_param_count), SGD {ex.LR}, n_pf {ex.D2.n_pf} n_po "
          f"{ex.D2.n_po} of {ex.D2.n_microbatches}, {ex.D2.head_groups} head "
          f"groups, batch {B} x seq {S}, {GM_STEPS} steps: kernel launches "
          f"{launches}, executed tile fractions fwd {frac['fwd']:.3f} bwd "
          f"{frac['bwd_dkdv']:.3f}/{frac['bwd_dq']:.3f} (= the schedule's: "
          f"{want} of {full} tiles), base bit-identical, "
          f"adapters moved, fused call err {e_y:.3e}", flush=True)
    print(f"[lora fine-tune] losses kernel "
          f"{[round(float(v), 6) for v in log_k.losses]} | masked "
          f"{[round(v, 6) for v in logs['masked'][0].losses]} | max diff "
          f"{diff:.3e} | plain LoRA "
          f"{[round(v, 6) for v in logs['plain'][0].losses]}", flush=True)
    print(f"[lora fine-tune] p50 step ms over 2 x {GM_STEPS} steps: kernel "
          f"path {p50['kernel']:.3f}, masked path {p50['masked']:.3f}, plain "
          f"LoRA (no D2FT) {p50['plain']:.3f}; per round " + ", ".join(
              f"{k} " + " / ".join(
                  f"{1e3 * float(np.median(lg.step_times)):.3f}" for lg in v)
              for k, v in logs.items()) + f" {tag}")
    print(f"[lora fine-tune] tokens/s: kernel path "
          f"{B * S / p50['kernel'] * 1e3:.1f}, masked "
          f"{B * S / p50['masked'] * 1e3:.1f}, plain LoRA "
          f"{B * S / p50['plain'] * 1e3:.1f} {tag}")
    print("[lora fine-tune] max_memory_allocated, scoring included: " +
          ", ".join(f"{k} {v} bytes ({v / 2**30:.2f} GiB)"
                    for k, v in peaks.items()) + f" {tag}", flush=True)
    print_profile("3 kernel-path D2FT-LoRA steps", prof,
                  "d2ft attention kernels", tag)
    return {"launches": launches, "err": err, "wq": wq}


def attention_timing_case(torch, gen, label, what, B, H, S, hd, window,
                          g_f, g_b, lf, lb, tag, causal=True):
    """CUDA-event times, L2 flushed, of both attention kernels on N(0, 1)
    q, k, v, do [B, H, S, hd], causal under ``window`` (bidirectional
    where ``causal`` is False: an encoder's), gates [B, H] and
    bounds (lf, lb): through the launcher and alone, beside the plain
    version, SDPA on the live slices (its forward; its autograd backward)
    and both bounds. Returns {"fwd"|"bwd": (ms, plain_ms, library_ms,
    bound_ms, bound_by)}, the bound the 3xTF32 one."""
    import torch.nn.functional as F
    from repro_torch.kernels import d2ft_attention as d2a
    q, k, v, do = (torch.randn((B, H, S, hd), generator=gen,
                               device="cuda") for _ in range(4))
    o, lse = d2a.flash_fwd(q, k, v, g_f, causal=causal, window=window,
                           live=lf)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = d2a.gated_attention_ref(qr, kr, vr, g_f, g_b, causal=causal,
                                  window=window)
    mask = d2a._mask(S, causal, window, "cuda")
    pairs = int(mask.sum())                # unmasked (q, k) pairs

    def flat(t, gate):                 # [live, S, hd], gathered once
        return t.reshape(B * H, S, hd)[gate.reshape(-1) != 0] \
            .contiguous()

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv,
                                              attn_mask=mask)
    lq, lk, lv = (flat(t, g_f) for t in (q, k, v))
    bq, bk, bv = (flat(t, g_b).requires_grad_() for t in (q, k, v))
    lib_o = sdpa(bq, bk, bv)
    ldo = flat(do, g_b)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    # q, k, v, o, do and lse of each live slice read once, dq, dk, dv
    # written for every slice; 5 products over the unmasked (q, k)
    # pairs of each live slice (s recomputed)
    work = {"fwd": (4 * (3 * n_f * S * hd + B * H * S * hd + B * H * S),
                    n_f * 2 * 2 * pairs * hd),
            "bwd": (4 * (5 * n_b * S * hd + n_b * S + 3 * B * H * S * hd),
                    n_b * 5 * 2 * pairs * hd)}
    res = {
        "fwd": (time_ms(torch, lambda: d2a.flash_fwd(
                    q, k, v, g_f, causal=causal, window=window, live=lf)),
                time_ms(torch, lambda: d2a.gated_attention_ref(
                    q, k, v, g_f, g_b, causal=causal, window=window)),
                time_ms(torch, lambda: sdpa(lq, lk, lv)),
                *tc_roofline(*work["fwd"])),
        # both run 3xTF32 on the tensor cores: held to that bound
        "bwd": (time_ms(torch, lambda: d2a.flash_bwd(
                    q, k, v, g_b, o, lse, do, causal=causal, window=window,
                    live=lb)),
                time_ms(torch, lambda: torch.autograd.grad(
                    ref, (qr, kr, vr), do, retain_graph=True)),
                time_ms(torch, lambda: torch.autograd.grad(
                    lib_o, (bq, bk, bv), ldo, retain_graph=True)),
                *tc_roofline(*work["bwd"]))}
    alone = {
        "fwd": attention_fwd_alone(torch, q, k, v, g_f, causal=causal,
                                   window=window, live=lf),
        "bwd": attention_bwd_alone(torch, q, k, v, o, lse, do, g_b,
                                   causal=causal, window=window, live=lb)}
    for kind, (k_ms, p_ms, l_ms, b_ms, by) in res.items():
        print(f"[{label}] d2ft_attention_{kind} {what} B {B} H {H} S {S} "
              f"hd {hd}, live "
              f"{n_f if kind == 'fwd' else n_b} of {B * H} (bound "
              f"{lf if kind == 'fwd' else lb}): launcher call "
              f"{k_ms:.4f} ms (kernels alone, table and outputs built "
              f"outside the window, {alone[kind]:.4f} "
              f"ms), plain {p_ms:.4f} ms, library (sdpa "
              f"{'forward' if kind == 'fwd' else 'autograd backward'} on "
              f"the live slices) {l_ms:.4f} ms; bounds: float32 FMA "
              f"{roofline(*work[kind])[0]:.5f} ms, 3xTF32 tensor cores "
              f"{b_ms:.5f} ms by {by}; held to the 3xTF32 one, "
              f"{b_ms / k_ms:.1%} of it ({b_ms / alone[kind]:.1%} "
              f"alone) {tag}", flush=True)
    del q, k, v, do, o, lse, qr, kr, vr, ref, lib_o
    torch.cuda.empty_cache()
    return res


def gemma_timing(torch, gm, lo, tag):
    """Phase 15. Returns {"lora"|"fwd"|"bwd": (ms, plain_ms, library_ms,
    bound_ms, bound_by)}: B3 at phase 14's wq operands, the hd-256
    attention kernels at phase 13's shapes, layer 0's gates and the
    per-head bounds (printed for layer 5, global, too)."""
    from repro_torch.kernels import lora_matmul as lm
    x, w, a, b = lo["wq"]
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    work = (lm.needed_bytes(M, K, N, r), lm.needed_flops(M, K, N, r))
    out = {"lora": (
        time_ms(torch, lambda: lm.lora_matmul(x, w, a, b, 1.0)),
        time_ms(torch, lambda: lm.lora_matmul_ref(x, w, a, b, 1.0)),
        time_ms(torch, lambda: torch.addmm(torch.matmul(x, w),
                                           torch.matmul(x, a), b)),
        *tc_roofline(*work))}
    k_ms, p_ms, l_ms, b_ms, by = out["lora"]
    print(f"[lora timing] lora_matmul M {M} K {K} N {N} r {r} (layer 0's wq, "
          f"trained adapter): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"library (addmm + two matmuls, cuBLAS) {l_ms:.4f} ms; bounds "
          f"({work[1] / 1e9:.3f} GFLOP, {work[0] / 1e6:.1f} MB): float32 "
          f"FMA {roofline(*work)[0]:.5f} ms, 3xTF32 tensor cores "
          f"{b_ms:.5f} ms by {by}; held to the 3xTF32 one, "
          f"{b_ms / k_ms:.1%} of it {tag}", flush=True)
    print_resources("lora_matmul", "lora timing")

    gen = torch.Generator(device="cuda").manual_seed(15)
    lf, lb = gm["bounds"]
    for layer, window in ((5, 0), (0, 512)):        # layer 0's last: kept
        g_f, g_b = gm["heads"][layer]
        res = attention_timing_case(
            torch, gen, "hd-256 attention timing",
            f"layer {layer} ({'window ' + str(window) if window else 'global'}"
            ", causal)", GM_BATCH, 4, GM_SEQ, 256, window, g_f, g_b, lf, lb,
            tag)
    out.update(res)
    torch.cuda.empty_cache()
    return out


def rglru_operands(torch):
    """recurrentgemma-2b's la and b [B 4, S 512, W 2560] of layer 0 (an
    RG-LRU block) and post-rope q and kv-expanded k, v [B, H 10, S, hd 256]
    of layer 2 (the first local attention block), random weights from seed
    0 drawn as the launcher's model draws them (at depth 3, init_model
    takes the same first draws), on phase 17's first batch: the operands
    the main path gives the kernels."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import attention as attn
    from repro_torch.models import rglru
    from repro_torch.models.layers import (apply_embedding, apply_norm,
                                           apply_rope)
    from repro_torch.models.transformer import apply_block, init_model
    cfg = get_config("recurrentgemma-2b")
    model = init_model(torch.Generator(device="cuda").manual_seed(0),
                       cfg.replace(n_layers=3))
    batch = next(lm_batches(0, cfg.vocab_size, RG_BATCH, RG_SEQ, 1))
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    with torch.no_grad():
        x = apply_embedding(model.embed,
                            torch.as_tensor(batch["tokens"], device="cuda"))
        p = model.layers[0].rglru
        u = rglru._causal_conv(apply_norm(model.layers[0].norm1, x, cfg.norm)
                               @ p.w_rec_branch, p.conv_w, p.conv_b)
        la, b = rglru._rglru_log_gates(p, u)
        for layer, kind in zip(model.layers[:2], cfg.layer_kinds):
            x, _ = apply_block(layer, x, kind, cfg)
        h = apply_norm(model.layers[2].norm1, x, cfg.norm)
        q, k, v = attn._project_qkv(model.layers[2].attn, h, H,
                                    cfg.n_kv_heads, hd)
        if cfg.rope:
            pos = torch.arange(RG_SEQ, device="cuda")[None, :]
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        qkv = tuple(attn._repeat_kv(t, H).transpose(1, 2).contiguous()
                    for t in (q, k, v))
    del model, x, u, h, q, k, v
    torch.cuda.empty_cache()
    return cfg, (la.contiguous(), b.contiguous()), qkv


def _dead_max(t, dead):
    sel = t[dead]
    return float(sel.abs().max()) if sel.numel() else 0.0


def rglru_case(torch, la, b, dy, g_f, g_b, live, f64=False):
    """One comparison of the RG-LRU kernels with their plain version: the
    kernels through ``ops.gated_rglru_scan`` (forward, backward, executed
    steps) against the plain version and its autograd gradients. Returns
    the max abs errors [h, dla, db], the plain version's max |value| of
    each, the exact-zero flag, the step counts and the ones wanted; with
    ``f64``, also (kernel - plain64, plain32 - plain64) errors against the
    plain version evaluated in float64."""
    import torch.nn.functional as F
    from repro_torch.kernels import contract, ops
    from repro_torch.kernels import d2ft_rglru as d2r
    B, S, W = la.shape
    G = g_f.shape[1]
    Q, Sp = ops._scan_pad(S, RG_CHUNK)
    with contract.count_tiles("cuda") as tc:
        ins = [t.clone().requires_grad_() for t in (la, b)]
        h = ops.gated_rglru_scan(*ins, g_f, g_b, chunk=RG_CHUNK,
                                 live_fwd=live[0], live_bwd=live[1])
        h.backward(dy)
        torch.cuda.synchronize()
        counts = tc.read()
    refs = [t.clone().requires_grad_() for t in (la, b)]
    ref = d2r.gated_rglru_ref(*[F.pad(t, (0, 0, 0, Sp - S)) for t in refs],
                              g_f, g_b, chunk=Q)[:, :S]
    ref.backward(dy)
    mine = [h.detach(), ins[0].grad, ins[1].grad]
    theirs = [ref.detach(), refs[0].grad, refs[1].grad]
    errs = [float((u - v).abs().max()) for u, v in zip(mine, theirs)]
    scale = [float(v.abs().max()) for v in theirs]
    e64 = None
    if f64:
        del ref
        r64 = [t.double().requires_grad_() for t in (la, b)]
        out = d2r.gated_rglru_ref(*[F.pad(t, (0, 0, 0, Sp - S)) for t in r64],
                                  g_f.double(), g_b.double(),
                                  chunk=Q)[:, :S]
        out.backward(dy.double())
        best = [out.detach(), r64[0].grad, r64[1].grad]
        e64 = ([float((u.double() - v).abs().max())
                for u, v in zip(mine, best)],
               [float((u.double() - v).abs().max())
                for u, v in zip(theirs, best)])
        del r64, out, best

    def bands(t):
        return t.reshape(B, S, G, W // G).transpose(1, 2)
    zeros = (_dead_max(bands(mine[0]), g_f == 0) == 0.0
             and _dead_max(bands(mine[1]), g_b == 0) == 0.0
             and _dead_max(bands(mine[2]), g_b == 0) == 0.0
             and all(bool(torch.isfinite(t).all()) for t in mine))
    nc = Sp // Q
    want = {"fwd": 0, "bwd_dkdv": 0, "bwd_dq": 0, "ssd_fwd": 0,
            "ssd_bwd": 0, "rglru_fwd": int((g_f != 0).sum()) * nc,
            "rglru_bwd": int((g_b != 0).sum()) * nc, "moe_fwd": 0,
            "moe_bwd": 0}
    del ins, refs, mine, theirs
    return errs, scale, zeros, counts, want, e64


def rglru_gates(torch, gen, B, G):
    """A p_f / p_o / p_s mix over the B x G (sample, band) slices, every op
    present from 3 slices on (slice op = random permutation mod 3)."""
    op = torch.randperm(B * G, generator=gen, device="cuda") % 3
    return (op != 2).float().reshape(B, G), (op == 0).float().reshape(B, G)


def rglru_vs_plain(torch):
    """Phase 16. Returns ({"fwd": h, "bwd": dla/db} largest absolute errors
    on the main path's operands at G 10, (la, b) of layer 0)."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    cfg, (la0, b0), qkv = rglru_operands(torch)

    # the hd-256 attention kernels under this path's conditions: 10 query
    # heads on 1 KV head, one gate group per head (rep 1), window 2048 >=
    # S 512, so causal with every tile of the causal triangle live
    hd256_attention_vs_plain(
        torch, gen, "rg attention vs plain", cfg, RG_BATCH, RG_SEQ,
        [(2, qkv, cfg.window)], ())
    del qkv
    torch.cuda.empty_cache()
    B, S0, W = la0.shape
    cases = [("layer 0's operands", S, G, mode)
             for S in (S0, 500) for G, modes in ((10, (None, "exact",
                                                      "above")),
                                                 (80, ("exact",)))
             for mode in modes]
    cases += [("unit-scale operands", S, G, mode, w)
              for S, G, mode, w in ((512, 10, "exact", W),
                                    (4096, 1, None, 256),
                                    (4096, 8, "above", 256))]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for case in cases:
        what, S, G, mode = case[:4]
        if len(case) == 4:
            la, b = (t[:, :S].contiguous() for t in (la0, b0))
        else:
            w = case[4]
            la = -(torch.randn((B, S, w), generator=gen, device="cuda")
                   * 0.1).abs()
            b = torch.randn((B, S, w), generator=gen, device="cuda")
        dy = torch.randn(la.shape, generator=gen, device="cuda")
        g_f, g_b = rglru_gates(torch, gen, B, G)
        n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
        live = {None: (None, None), "exact": (n_f, n_b),
                "above": (n_f + 7, n_b + 5)}[mode]
        errs, scale, zeros, counts, want, e64 = rglru_case(
            torch, la, b, dy, g_f, g_b, live,
            f64=len(case) == 4 and S == S0 and G == 10 and mode is None)
        lims = [KERNEL_TOL * max(1.0, scale[0])] + \
            [GRAD_TOL * max(1.0, r) for r in scale[1:]]
        desc = (f"{what}, B {B} S {S} W {la.shape[2]} G {G} (Wg "
                f"{la.shape[2] // G}) chunk {RG_CHUNK} bounds {live}")
        errs_s = (f"h {errs[0]:.3e}, dla {errs[1]:.3e}, db {errs[2]:.3e} "
                  f"(max |plain| {scale[0]:.3g} / {scale[1]:.3g} / "
                  f"{scale[2]:.3g})")
        if any(e > m for e, m in zip(errs, lims)) or not zeros or \
                counts != want:
            raise AssertionError(
                f"RG-LRU kernels vs plain, {desc}: {errs_s}, limits "
                f"{lims}, exact zeros {zeros}, steps {counts} != {want}")
        if len(case) == 4 and G == 10:
            worst = {"fwd": max(worst["fwd"], errs[0]),
                     "bwd": max(worst["bwd"], *errs[1:])}
        if e64 is not None:
            errs_s += ("; against the plain version in float64 h/dla/db: "
                       "kernel " + "/".join(f"{v:.2e}" for v in e64[0])
                       + ", plain " + "/".join(f"{v:.2e}" for v in e64[1]))
        print(f"[rglru vs plain] {desc}: live {n_f}/{n_b} of {B * G}, "
              f"{errs_s}, within tol x max(1, max |plain|), zeros exact, "
              f"steps fwd {counts['rglru_fwd']} bwd {counts['rglru_bwd']}",
              flush=True)
        del la, b, dy
        torch.cuda.empty_cache()
    print(f"[rglru vs plain] max abs err on the main path's operands fwd "
          f"{worst['fwd']:.3e}, bwd {worst['bwd']:.3e}", flush=True)
    return worst, (la0, b0)


def rg_schedule_counts(sched, mb_of, cfg, steps):
    """What the schedule makes the kernels execute in ``steps`` steps:
    RG-LRU (slice, chunk) steps and attention tiles, forward and backward,
    and those full fine-tuning would."""
    from repro_torch.core.schedule import gates_from_schedule
    from repro_torch.kernels import d2ft_attention as d2a
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")       # [L, B, G]
    nc = -(-RG_SEQ // RG_CHUNK)
    rep = cfg.n_heads // sched.n_groups
    want = dict.fromkeys(("fwd", "bwd_dkdv", "bwd_dq", "ssd_fwd", "ssd_bwd",
                          "rglru_fwd", "rglru_bwd", "moe_fwd", "moe_bwd"), 0)
    full = {"rglru": 0, "attn fwd": 0, "attn bwd": 0}
    for layer, kind in enumerate(cfg.layer_kinds):
        nf, nb = int(g_f[layer].sum()), int(g_b[layer].sum())
        if kind == "rglru":
            want["rglru_fwd"] += steps * nf * nc
            want["rglru_bwd"] += steps * nb * nc
            full["rglru"] += steps * g_f.shape[1] * g_f.shape[2] * nc
        else:
            tiles = attn_tiles(RG_SEQ, True, cfg.window,
                               cfg.resolved_head_dim)
            want["fwd"] += steps * nf * rep * tiles["fwd"]
            want["bwd_dkdv"] += steps * nb * rep * tiles["bwd_dkdv"]
            want["bwd_dq"] += steps * nb * rep * tiles["bwd_dq"]
            full["attn fwd"] += steps * g_f.shape[1] * cfg.n_heads \
                * tiles["fwd"]
            full["attn bwd"] += steps * g_f.shape[1] * cfg.n_heads \
                * tiles["bwd_dkdv"]
    return want, full


def rg_finetune(torch, np, tag):
    """Phase 17. Returns {"launches": {"fwd", "bwd"} RG-LRU launches,
    "gates": layer 0's (g_f, g_b) [B, G] of the step-0 split, "bounds":
    the (sample, band) bounds}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import lm_batches, microbatch_assignment
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.kernels import d2ft_rglru as d2r
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.train import loop

    cfg = get_config("recurrentgemma-2b")
    B, S, n_mb = RG_BATCH, RG_SEQ, RG_D2FT["n_microbatches"]
    argv = ["--arch", "recurrentgemma-2b", "--full", "--optimizer", "sgd",
            "--batch", str(B), "--seq", str(S), "--steps", str(RG_STEPS),
            "--lr", str(RG_LR), "--n-microbatches", str(n_mb), "--n-pf",
            str(RG_D2FT["n_pf"]), "--n-po", str(RG_D2FT["n_po"])]
    n_rg = cfg.layer_kinds.count("rglru")
    n_at = cfg.n_layers - n_rg

    def launches():
        return {"fwd": d2r.rglru_fwd.launches, "bwd": d2r.rglru_bwd.launches,
                "attn_fwd": d2a.flash_fwd.launches,
                "attn_bwd": d2a.flash_bwd.launches}

    def per_step(n_rglru, n_attn, steps):
        return {"fwd": n_rglru * steps, "bwd": n_rglru * steps,
                "attn_fwd": n_attn * steps, "attn_bwd": n_attn * steps}

    run, scheds = launcher_paths(argv)
    torch.cuda.reset_peak_memory_stats()
    d2r.rglru_fwd.launches = d2r.rglru_bwd.launches = 0
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    with contract.count_tiles("cuda") as tc:
        log_k = run("kernel")
        counts = tc.read()
    kernel_launches = launches()
    peaks = {"kernel": torch.cuda.max_memory_allocated()}
    if kernel_launches != per_step(n_rg, n_at, RG_STEPS):
        raise AssertionError(f"kernel launches {kernel_launches} != {n_rg} "
                             f"RG-LRU and {n_at} attention layers per step x "
                             f"{RG_STEPS} steps")
    sched = scheds[0]
    mb_of = microbatch_assignment(B, n_mb)
    bounds = live_slice_bounds(sched, mb_of)
    want, full = rg_schedule_counts(sched, mb_of, cfg, RG_STEPS)
    if counts != want:
        raise AssertionError(f"executed work {counts} != the schedule's "
                             f"{want}")
    frac = {"rglru fwd": counts["rglru_fwd"] / full["rglru"],
            "rglru bwd": counts["rglru_bwd"] / full["rglru"],
            "attention fwd": counts["fwd"] / full["attn fwd"],
            "attention bwd": counts["bwd_dkdv"] / full["attn bwd"]}
    if not np.isfinite(log_k.losses).all():
        raise AssertionError(f"non-finite losses {log_k.losses}")

    # standard full fine-tuning (no D2FT: the doubling scan, dense
    # attention), then each path again, in turns
    logs = {"kernel": [log_k], "full": []}
    for name in ("full", "full", "kernel"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        logs[name].append(run(name))
        peaks[name] = max(peaks.get(name, 0),
                          torch.cuda.max_memory_allocated())
        got = {k: launches()[k] - before[k] for k in before}
        if got != per_step(n_rg if name == "kernel" else 0,
                           n_at if name == "kernel" else 0, RG_STEPS):
            raise AssertionError(f"the {name} path launched {got}")
        if not np.isfinite(logs[name][-1].losses).all():
            raise AssertionError(f"non-finite {name} losses")
    p50 = {k: 1e3 * float(np.median(v[0].step_times + v[1].step_times))
           for k, v in logs.items()}

    # one cycle (RG-LRU, RG-LRU, local attention): the kernel path against
    # the masked plain path, whose chunked scan builds [B, nc, Q, Q, W]
    # intermediates that full depth cannot hold
    torch.cuda.empty_cache()
    one = cfg.replace(n_layers=3)

    def one_cycle(flags):
        """The launcher's loop on ``one`` with the launcher's settings."""
        model = init_model(torch.Generator(device="cuda").manual_seed(0), one)
        d2 = D2FTConfig(**RG_D2FT, head_groups=one.n_heads)
        return loop.finetune(
            model, one, d2, sgd(RG_LR),
            lm_batches(0, one.vocab_size, B, S, RG_STEPS), steps=RG_STEPS,
            use_kernel="--kernel" in flags)[2]
    run1, _ = launcher_paths(argv, drive=one_cycle)
    before = launches()
    log1_k = run1("kernel")
    got = {k: launches()[k] - before[k] for k in before}
    if got != per_step(2, 1, RG_STEPS):
        raise AssertionError(f"one cycle: kernel launches {got}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log1_m = run1("masked")
    peaks["one-cycle masked"] = torch.cuda.max_memory_allocated()
    if launches() != {k: before[k] + got[k] for k in before}:
        raise AssertionError("the masked path launched a kernel")
    diff = check_losses(np, log1_k, log1_m)

    print(f"[rg fine-tune] recurrentgemma-2b full size ({cfg.n_layers} "
          f"layers: {n_rg} RG-LRU and {n_at} local attention, d "
          f"{cfg.d_model}, LRU width {cfg.rglru.lru_width}, {cfg.n_heads} "
          f"query heads and {cfg.n_kv_heads} KV head of "
          f"{cfg.resolved_head_dim}, window {cfg.window} >= seq {S} (so "
          f"causal), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, f32, seed 0) "
          f"through repro_torch.launch.train, batch {B} x seq {S} in {n_mb} "
          f"micro-batches, n_pf {RG_D2FT['n_pf']} n_po {RG_D2FT['n_po']}, G "
          f"{sched.n_groups}, SGD lr {RG_LR}, {RG_STEPS} steps: kernel "
          f"launches {kernel_launches}, live (sample, group) bounds "
          f"{bounds}, executed fractions " + ", ".join(
              f"{k} {v:.3f}" for k, v in frac.items())
          + " (= the schedule's)", flush=True)
    print(f"[rg fine-tune] losses kernel "
          f"{[round(float(x), 6) for x in log_k.losses]} | full "
          f"{[round(float(x), 6) for x in logs['full'][0].losses]}",
          flush=True)
    print(f"[rg fine-tune] one cycle (3 layers, full width), losses kernel "
          f"{[round(float(x), 6) for x in log1_k.losses]} | masked "
          f"{[round(x, 6) for x in log1_m.losses]} | max diff {diff:.3e}",
          flush=True)
    print(f"[rg fine-tune] p50 step ms over 2 x {RG_STEPS} steps: kernel "
          f"path {p50['kernel']:.3f}, standard full fine-tuning (d2ft off, "
          f"doubling scan, dense attention) {p50['full']:.3f}; per round "
          + ", ".join(f"{k} " + " / ".join(
              f"{1e3 * float(np.median(lg.step_times)):.3f}" for lg in v)
              for k, v in logs.items())
          + f"; one cycle: kernel "
          f"{1e3 * float(np.median(log1_k.step_times)):.3f}, masked "
          f"{1e3 * float(np.median(log1_m.step_times)):.3f} {tag}")
    print(f"[rg fine-tune] tokens/s: kernel path "
          f"{B * S / p50['kernel'] * 1e3:.1f}, full "
          f"{B * S / p50['full'] * 1e3:.1f} {tag}")
    print("[rg fine-tune] max_memory_allocated, scoring included: " +
          ", ".join(f"{k} {v} bytes ({v / 2**30:.2f} GiB)"
                    for k, v in peaks.items()) + f" {tag}", flush=True)

    # where a kernel-path step's time goes
    torch.cuda.empty_cache()
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(t.numel() for t in model.parameters())
    if n_params != RG_PARAMS:
        raise AssertionError(f"{n_params} parameters != {RG_PARAMS}")
    opt = sgd(RG_LR)
    state = opt.init(dict(model.named_parameters()))
    step = loop.make_train_step(cfg, opt, use_gates=True, use_kernel=True,
                                live_bounds=bounds)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(0, cfg.vocab_size, B, S, 1)).items()}
    gates = (g_f.cuda(), g_b.cuda())
    print(f"[rg fine-tune] parameters {n_params} (= the JAX init_model's)",
          flush=True)
    print_profile("3 kernel-path recurrentgemma-2b fine-tune steps",
                  profile_steps(torch, lambda: step(model, state, batch,
                                                    gates), "rglru"),
                  "d2ft RG-LRU kernels", tag)
    del model, state, batch, opt, step
    torch.cuda.empty_cache()
    return {"launches": {"fwd": kernel_launches["fwd"],
                         "bwd": kernel_launches["bwd"]},
            "gates": (g_f[0].cuda(), g_b[0].cuda()), "bounds": bounds}


def rglru_timing(torch, operands, rg, tag):
    """Phase 18. Returns {"fwd"|"bwd": (ms, plain_ms, bound_ms, bound_by)}
    at phase 17's shapes on layer 0's operands, gates and bounds."""
    from repro_torch.kernels import d2ft_rglru as d2r
    la, b = operands
    g_f, g_b = rg["gates"]
    lf, lb = rg["bounds"]
    B, S, W = la.shape
    Wg = W // g_f.shape[1]
    dy = torch.randn(la.shape, generator=torch.Generator(
        device="cuda").manual_seed(18), device="cuda")
    h = d2r.rglru_fwd(la, b, g_f, chunk=RG_CHUNK, live=lf)
    refs = [t.clone().requires_grad_() for t in (la, b)]
    ref = d2r.gated_rglru_ref(*refs, g_f, g_b, chunk=RG_CHUNK)
    g_np, b_np = g_f.cpu().numpy(), g_b.cpu().numpy()
    fl = d2r.needed_flops(g_np, b_np, S, Wg)
    by = d2r.needed_bytes(g_np, b_np, S, Wg)
    out = {
        "fwd": (time_ms(torch, lambda: d2r.rglru_fwd(
                    la, b, g_f, chunk=RG_CHUNK, live=lf)),
                time_ms(torch, lambda: d2r.gated_rglru_ref(
                    la, b, g_f, g_b, chunk=RG_CHUNK), iters=20),
                *roofline(by[0], fl[0])),
        "bwd": (time_ms(torch, lambda: d2r.rglru_bwd(
                    la, g_b, h, dy, chunk=RG_CHUNK, live=lb)),
                time_ms(torch, lambda: torch.autograd.grad(
                    ref, refs, dy, retain_graph=True), iters=20),
                *roofline(by[1], fl[1]))}
    # the kernels alone: the outputs each launcher call allocates are made
    # once, outside the timed window (the launchers build no table and
    # fill nothing: the kernels find which slices run and write the zeros)
    alone = {}
    for kind, gate, live_b, call, args, outs in (
            ("fwd", g_f, lf, d2r._fwd_call, (la, b, g_f), 1),
            ("bwd", g_b, lb, d2r._bwd_call, (la, h, dy, g_b), 2)):
        G, Q, n_disp = d2r._prepare(la, gate, RG_CHUNK, live_b)
        bufs = [torch.empty_like(la) for _ in range(outs)]
        alone[kind] = time_ms(torch, lambda: call(*args, *bufs, n_disp, G,
                                                  Q))
        del bufs
    live = {"fwd": int((g_f != 0).sum()), "bwd": int((g_b != 0).sum())}
    for kind, (k_ms, p_ms, b_ms, bb) in out.items():
        i = 0 if kind == "fwd" else 1
        print(f"[rglru timing] d2ft_rglru_{kind} B {B} S {S} W {W} Wg {Wg} "
              f"chunk {RG_CHUNK}, layer 0's operands and gates, live "
              f"{live[kind]} of {g_f.numel()} (bound "
              f"{lf if kind == 'fwd' else lb}): launcher call {k_ms:.4f} ms "
              f"(kernel alone, outputs allocated outside the window, "
              f"{alone[kind]:.4f} ms), plain {p_ms:.4f} ms, library "
              f"none (no PyTorch call computes the scan), bound {b_ms:.5f} "
              f"ms by {bb} ({by[i] / 1e6:.1f} MB, {fl[i] / 1e9:.3f} GFLOP), "
              f"{b_ms / k_ms:.1%} of bound ({b_ms / alone[kind]:.1%} alone) "
              f"{tag}", flush=True)
    for name in ("d2ft_rglru_fwd", "d2ft_rglru_bwd"):
        print_resources(name, "rglru timing")
    del h, refs, ref, dy
    torch.cuda.empty_cache()
    return out


def capture(module, name, sink):
    """Context manager: calls of ``module.name`` record their (args,
    kwargs) in ``sink`` and run as before."""
    import contextlib

    @contextlib.contextmanager
    def patched():
        orig = getattr(module, name)

        def grab(*a, **k):
            sink.append((a, k))
            return orig(*a, **k)
        setattr(module, name, grab)
        try:
            yield sink
        finally:
            setattr(module, name, orig)
    return patched()


def moe_operands(torch, layer_gates, bounds):
    """The MoE kernels' operands on the main path: olmoe-1b-7b's layer 0,
    random weights from seed 0 as the fine-tunes draw them (at depth 1,
    init_model takes the same first draws), on phases 20-21's first batch
    (B 4, S 512), under layer 0's gates [B, G] and the (sample, group)
    bounds: the capacity buffer [E 64, C 320, D 2048], the expert weights,
    both slot masks and the two slot bounds ``apply_moe`` hands to
    ``ops._gated_moe_impl``, captured from one kernel-path block forward."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.models.layers import apply_embedding
    from repro_torch.models.transformer import apply_block, init_model
    cfg = get_config("olmoe-1b-7b")
    model = init_model(torch.Generator(device="cuda").manual_seed(0),
                       cfg.replace(n_layers=1))
    batch = next(lm_batches(0, cfg.vocab_size, MO_BATCH, MO_SEQ, 1))
    calls = []
    with torch.no_grad(), capture(ops, "_gated_moe_impl", calls):
        x = apply_embedding(model.embed,
                            torch.as_tensor(batch["tokens"], device="cuda"))
        apply_block(model.layers[0], x, "attn_global", cfg, layer_gates,
                    use_kernel=True, live_bounds=bounds)
    (buf, wu, wg, wd, fs, bs), kw = calls[0]
    out = (buf.clone(), wu.detach(), wg.detach(), wd.detach(), fs.clone(),
           bs.clone(), kw["live_slots"], kw["live_bwd_slots"])
    del model, x, calls
    torch.cuda.empty_cache()
    return out


def _top(slots):
    """One past the highest occupied slot of an [E, C] mask."""
    idx = (slots != 0).any(0).nonzero()
    return int(idx.max()) + 1 if idx.numel() else 0


def moe_case(torch, xb, wu, wg, wd, dy, fs, bs, *, act, live, live_b,
             need=(True, True, True)):
    """One comparison of the MoE kernels with their plain version: the
    kernels through ``ops.gated_moe_ffn`` (forward, backward, executed
    tiles, the launched block masks), with requires_grad on xb and on the
    weights ``need`` names, against the plain version on the same grid and
    its autograd gradients. Returns errors and max |plain| of [y, dx,
    dw_up, dw_gate, dw_down] (0.0 for a weight gradient not needed), the
    exact-zero flag (None where a gradient is not needed, and nowhere
    else), the counts, the tiles the launched masks hold and the
    outputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import contract, ops
    from repro_torch.kernels import d2ft_moe as d2m
    masks = {}
    d2m.dispatch = lambda kind, grid, m: masks.__setitem__(kind, m.clone())
    try:
        with contract.count_tiles("cuda") as tc:
            ins = [xb.clone().requires_grad_()] + [
                w.clone().requires_grad_(n)
                for w, n in zip((wu, wg, wd), need)]
            y = ops.gated_moe_ffn(*ins, fs, bs, act=act, block_c=MO_BLOCK_C,
                                  live_slots=live, live_bwd_slots=live_b)
            y.backward(dy)
            torch.cuda.synchronize()
            counts = tc.read()
    finally:
        d2m.dispatch = None
    E, C, _ = xb.shape
    bc = min(MO_BLOCK_C, C)
    Cp = -(-C // bc) * bc

    def blocks(slots):
        return (F.pad(slots, (0, Cp - C)).reshape(E, -1, bc).sum(-1)
                > 0).float()
    fm, bm = blocks(fs), blocks(bs)
    refs = [t.clone().requires_grad_() for t in (xb, wu, wg, wd)]
    ref = d2m.gated_moe_ffn_ref(F.pad(refs[0], (0, 0, 0, Cp - C)),
                                *refs[1:], fm, bm, act=act,
                                block_c=bc)[:, :C]
    ref.backward(dy)
    mine = [y.detach()] + [t.grad for t in ins]
    theirs = [ref.detach()] + [t.grad for t in refs]
    errs = [0.0 if a is None else float((a - b).abs().max())
            for a, b in zip(mine, theirs)]
    scale = [float(t.abs().max()) for t in theirs]
    rows_f = fm.repeat_interleave(bc, 1)[:, :C] == 0
    rows_b = bm.repeat_interleave(bc, 1)[:, :C] == 0
    dead_e = bm.sum(1) == 0
    got = [g for g in mine[2:] if g is not None]
    zeros = (_dead_max(mine[0], rows_f) == 0.0
             and _dead_max(mine[1], rows_b) == 0.0
             and all(_dead_max(g, dead_e) == 0.0 for g in got)
             and all(bool(torch.isfinite(t).all()) for t in mine[:2] + got)
             and [g is None for g in mine[2:]] == [not n for n in need])
    mirror = {"moe_fwd": int(masks["fwd"].sum()),
              "moe_bwd": int(masks["bwd"].sum())}
    grids = (tuple(masks["fwd"].shape), tuple(masks["bwd"].shape))
    del ins, refs, ref, theirs
    return errs, scale, zeros, counts, mirror, grids, mine


def moe_dw_launches(torch, xb, wu, wg, wd, dy, fs, bs, *, act, live, live_b,
                    need):
    """The MoE kernels a forward and backward through ``ops.gated_moe_ffn``
    launches, with requires_grad on xb and on the weights ``need`` names,
    from a profiler window over one call: ({1: <1>, 2: <2>} launches of
    the backward's dW kernels, every moe_ kernel's launches by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import ops

    def step():
        # the host waits 20 ms before it launches (at the N(0, 1) cases' 4
        # experts the call's kernels take microseconds) and 100 ms after
        # they end, so that CUPTI delivers their records before the window
        # moves on
        time.sleep(0.02)
        ins = [xb.clone().requires_grad_()] + [
            w.clone().requires_grad_(n) for w, n in zip((wu, wg, wd), need)]
        ops.gated_moe_ffn(*ins, fs, bs, act=act, block_c=MO_BLOCK_C,
                          live_slots=live, live_bwd_slots=live_b).backward(dy)
        torch.cuda.synchronize()
        time.sleep(0.1)
    # every backward launches its dx kernel once: a window without it lost
    # CUPTI's records (seen on the card late in this process: every kernel
    # but the last two gone, in five windows in a row that traced from
    # their first call), so the window traces a warm-up call before the
    # one it counts, and waits for the records; where it still loses them,
    # it is taken again, and says so
    step()
    for attempt in range(1, 6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            for _ in range(2):
                step()
                prof.step()
        named = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "moe_" in e.key:
                ms, n = named.get(kernel_name(e.key), (0.0, 0))
                named[kernel_name(e.key)] = (ms + e.self_device_time_total
                                             / 1e3, n + e.count)
        if "moe_bwd_dx_kernel" in named:
            break
        print(f"[profile] MoE window {attempt} of 5 lost the backward's dx "
              f"kernel (saw {sorted(named)})", flush=True)
    return dw_launches(named), {k: n for k, (_, n) in named.items()}


def moe_vs_plain(torch):
    """Phase 19. Returns ({"fwd": y, "bwd": dx/dW} largest absolute errors
    on the main path's operands)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    operands = {}
    # two sample mixes, every head group alike: p_f / p_o / p_s / p_f, and
    # p_s / p_o / p_f / p_s, where fewer live samples leave room for the
    # slot bounds to cut the grids (at the first, an expert at capacity
    # puts the highest occupied slot at C)
    for mix, op in (("p_f/p_o/p_s/p_f", (0, 1, 2, 0)),
                    ("p_s/p_o/p_f/p_s", (2, 1, 0, 2))):
        ops_ = torch.tensor(op, device="cuda")[:, None].repeat(1, 16)
        g_f, g_b = (ops_ != 2).float(), (ops_ == 0).float()
        operands[mix] = moe_operands(torch, (g_f, g_b),
                                     (int(g_f.sum()), int(g_b.sum())))
    D, Fd = operands[mix][0].shape[2], operands[mix][1].shape[2]
    cases = [("layer 0's operands, " + mix, "silu", mode)
             for mix, modes in (("p_f/p_o/p_s/p_f", (None, "model")),
                                ("p_s/p_o/p_f/p_s", ("at", "above")))
             for mode in modes]
    cases += [("N(0, 1) operands", act, mode)
              for act, mode in zip(ACTS_ALL, ("at", "above", None))]
    worst = {"fwd": 0.0, "bwd": 0.0, "bwd_dw_up": 0.0}
    for what, act, mode in cases:
        # the main path's first case also as D2FT-LoRA's step asks for it:
        # dW_up alone, on the same cotangent
        needs = [(True, True, True)] + (
            [(True, False, False)] if mode == "model" else [])
        if what.startswith("N"):
            e, c = 4, 300
            xs = torch.randn((e, c, D), generator=gen, device="cuda")
            ws = [torch.randn(s, generator=gen, device="cuda") / s[1] ** 0.5
                  for s in ((e, D, Fd), (e, D, Fd), (e, Fd, D))]
            slot = torch.arange(c, device="cuda")[None, :]
            fs = (slot < torch.tensor([0, 250, 171, 40],
                                      device="cuda")[:, None]).float()
            bs = (slot < torch.tensor([0, 100, 60, 40],
                                      device="cuda")[:, None]).float()
            model = (None, None)
        else:
            xs, *ws, fs, bs = operands[what.split(", ")[1]][:6]
            model = operands[what.split(", ")[1]][6:]
        C = xs.shape[1]
        top_f, top_b = _top(fs), _top(bs)
        live, live_b = {None: (None, None), "model": model,
                        "at": (top_f, top_b),
                        "above": (min(C, top_f + 50),
                                  min(C, top_b + 50))}[mode]
        dy = torch.randn(xs.shape, generator=gen, device="cuda")
        first = None
        for need in needs:
            errs, scale, zeros, counts, mirror, grids, outs = moe_case(
                torch, xs, *ws, dy, fs, bs, act=act, live=live,
                live_b=live_b, need=need)
            dw, seen = moe_dw_launches(torch, xs, *ws, dy, fs, bs, act=act,
                                       live=live, live_b=live_b, need=need)
            lims = [KERNEL_TOL * max(1.0, scale[0])] + \
                [GRAD_TOL * max(1.0, r) for r in scale[1:]]
            got = {k: counts[k] for k in ("moe_fwd", "moe_bwd")}
            # <2>: dW_up with dW_gate; <1>: one of them, and dW_down
            want_dw = {1: int(need[0] != need[1]) + int(need[2]),
                       2: int(need[0] and need[1])}
            first = first or outs
            same = all(a is None or torch.equal(a, b)
                       for a, b in zip(outs, first))
            desc = (f"{what}, E {xs.shape[0]} C {C} D {D} F {Fd} block_c "
                    f"{MO_BLOCK_C} {act}, dW wanted (up, gate, down) "
                    f"{need}, slot bounds ({live}, {live_b}) of occupied "
                    f"({top_f}, {top_b}), launched grids {grids}")
            errs_s = (f"y {errs[0]:.3e}, dx/dw_up/dw_gate/dw_down "
                      + "/".join(f"{v:.3e}" for v in errs[1:])
                      + " (max |plain| "
                      + " / ".join(f"{v:.3g}" for v in scale) + ")")
            # the window saw the backward: its dx kernel, once
            if any(e > m for e, m in zip(errs, lims)) or not zeros or \
                    got != mirror or dw != want_dw or not same or \
                    seen.get("moe_bwd_dx_kernel") != 1 or \
                    any(counts[k] for k in counts if not k.startswith("moe")):
                raise AssertionError(
                    f"MoE kernels vs plain, {desc}: {errs_s}, limits "
                    f"{lims}, exact zeros and None where not wanted "
                    f"{zeros}, tiles {counts} != {mirror}, dW kernel "
                    f"launches {dw} != {want_dw} (the moe_ kernels in the "
                    f"profile: {seen}), bitwise = all-three {same}")
            if not what.startswith("N"):
                key = "bwd" if all(need) else "bwd_dw_up"
                worst["fwd"] = max(worst["fwd"], errs[0])
                worst[key] = max(worst[key], *errs[1:])
            print(f"[moe vs plain] {desc}: {errs_s}, within tol x max(1, "
                  f"max |plain|), zeros exact, executed tiles fwd "
                  f"{got['moe_fwd']} bwd {got['moe_bwd']} (= the launched "
                  f"masks'), dW kernel launches <1> {dw[1]:g} <2> "
                  f"{dw[2]:g}"
                  + ("" if all(need) else ", skipped dW None, the others "
                     "bitwise equal to the all-three call's"), flush=True)
            del outs
        del xs, ws, dy, first
        torch.cuda.empty_cache()
    print(f"[moe vs plain] max abs err on the main path's operands fwd "
          f"{worst['fwd']:.3e}, bwd {worst['bwd']:.3e}, bwd with dW_up "
          f"alone {worst['bwd_dw_up']:.3e}", flush=True)
    del operands
    torch.cuda.empty_cache()
    return worst


def mask_sums():
    """A ``d2ft_moe.dispatch`` hook and its record: the launched masks'
    sums per kind, left on the card (no synchronisation per launch)."""
    sums = {"fwd": [], "bwd": []}

    def hook(kind, grid, mask):
        sums[kind].append(mask.sum())
    return hook, sums


def moe_launches():
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.kernels import d2ft_moe as d2m
    return {"fwd": d2m.moe_fwd.launches, "bwd": d2m.moe_bwd.launches,
            "attn_fwd": d2a.flash_fwd.launches,
            "attn_bwd": d2a.flash_bwd.launches}


def olmoe_lora(torch, np, tag):
    """Phase 20. Returns {"launches": MoE and attention launches}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.lora import init_lora, lora_param_count
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import lm_batches, microbatch_assignment
    from repro_torch.examples import lora_finetune as ex
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.kernels import d2ft_moe as d2m
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import sgd

    cfg = get_config("olmoe-1b-7b")
    B, S, steps = MO_BATCH, MO_SEQ, MO_STEPS
    d2 = D2FTConfig(**MO_LORA_D2FT, head_groups=cfg.n_heads)
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    params = dict(model.named_parameters())
    n_params = sum(t.numel() for t in params.values())

    def adapters():
        return init_lora(torch.Generator(device="cuda").manual_seed(1),
                         params, rank=ex.RANK, targets=MO_LORA_TARGETS)
    lora = adapters()
    n_adapters = lora_param_count(lora)
    if n_params != MO_PARAMS or n_adapters != MO_LORA_PARAMS:
        raise AssertionError(f"{n_params} parameters, {n_adapters} adapter "
                             f"parameters != {MO_PARAMS}, {MO_LORA_PARAMS}")
    if tuple(lora["layers.0.moe.w_up"]["a"].shape) != (64, cfg.d_model,
                                                        ex.RANK):
        raise AssertionError("w_up adapters are not per expert")
    batches = list(lm_batches(0, cfg.vocab_size, B, S, steps))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sched = ex.plan_lora(model, cfg, lora, d2, batches[0])
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    peak_plan = torch.cuda.max_memory_allocated()
    mb_of = microbatch_assignment(B, d2.n_microbatches)

    hook, sums = mask_sums()
    d2m.moe_fwd.launches = d2m.moe_bwd.launches = 0
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    d2m.dispatch = hook
    torch.cuda.reset_peak_memory_stats()
    try:
        with contract.count_tiles("cuda") as tc:
            _, _, log_k = ex.finetune_lora(model, cfg, lora, sgd(ex.LR),
                                           batches, steps=steps, sched=sched,
                                           use_kernel=True)
            counts = tc.read()
    finally:
        d2m.dispatch = None
    peak_k = torch.cuda.max_memory_allocated()
    launches = moe_launches()
    per = cfg.n_layers * steps
    if launches != dict.fromkeys(launches, per):
        raise AssertionError(f"kernel launches {launches} != {cfg.n_layers} "
                             f"per step x {steps} steps")
    mirror = {k: int(sum(int(v) for v in sums[k])) for k in sums}
    want, full = schedule_tiles(sched, mb_of, cfg, steps, S)
    if counts["moe_fwd"] != mirror["fwd"] or \
            counts["moe_bwd"] != mirror["bwd"] or \
            any(counts[k] != want[k] for k in want):
        raise AssertionError(f"executed tiles {counts} != the masks' "
                             f"{mirror} / the schedule's attention {want}")
    # the frozen base is the seed-0 model bit for bit; the adapters moved
    fresh = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    same = all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 fresh.parameters()))
    del fresh
    torch.cuda.empty_cache()
    init = adapters()
    moved = all(not torch.equal(ab[k], init[n][k])
                for n, ab in lora.items() for k in ("a", "b"))
    if not same or not moved:
        raise AssertionError(f"base bit-identical {same}, adapters moved "
                             f"{moved}")
    del init, lora

    # the masked path on the same schedule, plain LoRA, then in turns
    runs = {"kernel": dict(use_kernel=True, sched=sched),
            "masked": dict(sched=sched), "plain": dict()}
    logs = {"kernel": [log_k]}
    peaks = {"kernel": peak_k}
    for name in ("masked", "plain", "plain", "masked", "kernel"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = moe_launches()
        logs.setdefault(name, []).append(ex.finetune_lora(
            model, cfg, adapters(), sgd(ex.LR), batches, steps=steps,
            **runs[name])[-1])
        peaks[name] = max(peaks.get(name, 0),
                          torch.cuda.max_memory_allocated())
        got = {k: moe_launches()[k] - before[k] for k in before}
        if got != dict.fromkeys(got, per if name == "kernel" else 0):
            raise AssertionError(f"the {name} path launched {got}")
    diff = check_losses(np, log_k, logs["masked"][0])
    p50 = {k: 1e3 * float(np.median(v[0].step_times + v[1].step_times))
           for k, v in logs.items()}
    n_tiles = cfg.n_layers * steps * cfg.moe.n_experts * 3
    frac = {k: counts[f"moe_{k}"] / n_tiles for k in ("fwd", "bwd")}
    print(f"[olmoe lora] D2FT-LoRA on olmoe-1b-7b full size ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of d_ff {cfg.moe.d_ff}, vocab {cfg.vocab_size}, "
          f"f32, seed 0, {n_params} parameters) through "
          f"repro_torch.examples.lora_finetune (plan_lora, finetune_lora): "
          f"rank {ex.RANK} on {'/'.join(MO_LORA_TARGETS)} (w_up per expert; "
          f"{n_adapters} adapter parameters), SGD {ex.LR}, n_pf "
          f"{d2.n_pf} n_po {d2.n_po} of {d2.n_microbatches}, G "
          f"{sched.n_groups}, batch {B} x seq {S}, {steps} steps: launches "
          f"{launches}, executed MoE tiles fwd {counts['moe_fwd']} bwd "
          f"{counts['moe_bwd']} (= the launched masks'; {frac['fwd']:.3f} / "
          f"{frac['bwd']:.3f} of the {n_tiles} tiles), attention "
          f"tiles = the schedule's ({want} of {full}), live "
          f"(sample, group) bounds {live_slice_bounds(sched, mb_of)}, base "
          f"bit-identical, adapters moved; scoring and knapsack "
          f"{plan_s:.1f} s", flush=True)
    print(f"[olmoe lora] losses kernel "
          f"{[round(float(v), 6) for v in log_k.losses]} | masked "
          f"{[round(v, 6) for v in logs['masked'][0].losses]} | max diff "
          f"{diff:.3e} | plain LoRA "
          f"{[round(v, 6) for v in logs['plain'][0].losses]}", flush=True)
    print(f"[olmoe lora] p50 step ms over 2 x {steps} steps: kernel path "
          f"{p50['kernel']:.3f}, masked path {p50['masked']:.3f}, plain "
          f"LoRA (no D2FT) {p50['plain']:.3f}; per round " + ", ".join(
              f"{k} " + " / ".join(
                  f"{1e3 * float(np.median(lg.step_times)):.3f}" for lg in v)
              for k, v in logs.items()) + f" {tag}")
    print(f"[olmoe lora] tokens/s: kernel path "
          f"{B * S / p50['kernel'] * 1e3:.1f}, masked "
          f"{B * S / p50['masked'] * 1e3:.1f}, plain LoRA "
          f"{B * S / p50['plain'] * 1e3:.1f} {tag}")
    print(f"[olmoe lora] max_memory_allocated: scoring {peak_plan} bytes "
          f"({peak_plan / 2**30:.2f} GiB); steps " + ", ".join(
              f"{k} {v} bytes ({v / 2**30:.2f} GiB)"
              for k, v in peaks.items()) + f" {tag}", flush=True)
    # where a kernel-path D2FT-LoRA step's time goes
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
    opt = sgd(ex.LR)
    lora = adapters()
    state = opt.init({f"{n}.{k}": ab[k] for n, ab in lora.items()
                      for k in ("a", "b")})
    step = ex.make_lora_step(model, cfg, opt, use_kernel=True)
    bt = {k: torch.as_tensor(v, device="cuda") for k, v in batches[0].items()}
    gates = (g_f.cuda(), g_b.cuda())
    bounds = live_slice_bounds(sched, mb_of)
    prof = profile_steps(torch, lambda: step(lora, state, bt, gates, bounds),
                         "moe_")
    print_profile("3 kernel-path olmoe-1b-7b D2FT-LoRA steps", prof,
                  "d2ft MoE kernels", tag, breakdown=True)
    # the merged w_gate and w_down are frozen: dW_up alone, one <1> launch
    # a layer and no dW_gate or dW_down work
    dw = dw_launches(prof[-1])
    if dw != {1: cfg.n_layers, 2: 0}:
        raise AssertionError(f"D2FT-LoRA step's dW kernel launches per step "
                             f"{dw}, not {cfg.n_layers} <1> (dW_up alone) "
                             f"and no <2>")
    print(f"[olmoe lora] dW kernel launches per step: <1> {dw[1]:g} (dW_up "
          f"alone, one a layer), <2> {dw[2]:g}: no dW_gate or dW_down work",
          flush=True)
    del model, params, lora, state, step, bt
    torch.cuda.empty_cache()
    return {"launches": launches}


def olmoe_finetune(torch, np, tag):
    """Phase 21. Returns {"launches": MoE and attention launches, "gates":
    layer 0's (g_f, g_b) [B, G] of the step-0 split, "bounds": the (sample,
    group) bounds}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import lm_batches, microbatch_assignment
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.kernels import d2ft_moe as d2m
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.train import loop

    cfg = get_config("olmoe-1b-7b").replace(n_layers=MO_LAYERS)
    B, S, steps, n_mb = MO_BATCH, MO_SEQ, MO_STEPS, MO_D2FT["n_microbatches"]
    argv = ["--arch", "olmoe-1b-7b", "--full", "--optimizer", "sgd",
            "--batch", str(B), "--seq", str(S), "--steps", str(steps),
            "--lr", str(MO_LR), "--n-microbatches", str(n_mb), "--n-pf",
            str(MO_D2FT["n_pf"]), "--n-po", str(MO_D2FT["n_po"])]
    n_params = {}

    def drive(flags):
        """The launcher's loop (``loop.finetune``, with the launcher's
        settings) on the model cut to 8 layers."""
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        n_params["n"] = sum(t.numel() for t in model.parameters())
        d2 = D2FTConfig(**MO_D2FT, head_groups=max(cfg.n_heads, 1)) \
            if "--d2ft" in flags else None
        return loop.finetune(
            model, cfg, d2, sgd(MO_LR),
            lm_batches(0, cfg.vocab_size, B, S, steps), steps=steps,
            use_kernel="--kernel" in flags)[2]
    run, scheds = launcher_paths(argv, drive=drive)

    hook, sums = mask_sums()
    d2m.moe_fwd.launches = d2m.moe_bwd.launches = 0
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    d2m.dispatch = hook
    torch.cuda.reset_peak_memory_stats()
    try:
        with contract.count_tiles("cuda") as tc:
            log_k = run("kernel")
            counts = tc.read()
    finally:
        d2m.dispatch = None
    launches = moe_launches()
    peaks = {"kernel": torch.cuda.max_memory_allocated()}
    per = cfg.n_layers * steps
    if launches != dict.fromkeys(launches, per):
        raise AssertionError(f"kernel launches {launches} != {cfg.n_layers} "
                             f"per step x {steps} steps")
    if n_params["n"] != MO_PARAMS_8:
        raise AssertionError(f"{n_params['n']} parameters != {MO_PARAMS_8}")
    sched = scheds[0]
    mb_of = microbatch_assignment(B, n_mb)
    bounds = live_slice_bounds(sched, mb_of)
    mirror = {k: int(sum(int(v) for v in sums[k])) for k in sums}
    want, full = schedule_tiles(sched, mb_of, cfg, steps, S)
    if counts["moe_fwd"] != mirror["fwd"] or \
            counts["moe_bwd"] != mirror["bwd"] or \
            any(counts[k] != want[k] for k in want):
        raise AssertionError(f"executed tiles {counts} != the masks' "
                             f"{mirror} / the schedule's attention {want}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = moe_launches()
    log_m = run("masked")
    peaks["masked"] = torch.cuda.max_memory_allocated()
    if moe_launches() != before:
        raise AssertionError("the masked path launched a kernel")
    diff = check_losses(np, log_k, log_m)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p50, per_round = in_turns(np, run, {"kernel": log_k, "masked": log_m})
    peaks["timed rounds (full fine-tuning included)"] = \
        torch.cuda.max_memory_allocated()
    n_tiles = cfg.n_layers * steps * cfg.moe.n_experts * 3
    frac = {k: counts[f"moe_{k}"] / n_tiles for k in ("fwd", "bwd")}
    print(f"[olmoe fine-tune] olmoe-1b-7b at full width, {cfg.n_layers} of "
          f"16 layers ({n_params['n']} parameters, f32, seed 0) through "
          f"the launcher's loop (train/loop.py::finetune, the launcher's "
          f"settings), batch {B} x seq {S} in {n_mb} micro-batches, n_pf "
          f"{MO_D2FT['n_pf']} n_po {MO_D2FT['n_po']}, G {sched.n_groups}, "
          f"SGD lr {MO_LR}, {steps} steps: launches {launches}, executed "
          f"MoE tiles fwd {counts['moe_fwd']} bwd {counts['moe_bwd']} (= the "
          f"launched masks'; {frac['fwd']:.3f} / {frac['bwd']:.3f} of the "
          f"{n_tiles} tiles), attention tiles = the schedule's "
          f"({want} of {full}), live (sample, group) bounds "
          f"{bounds}", flush=True)
    print(f"[olmoe fine-tune] losses kernel "
          f"{[round(float(x), 6) for x in log_k.losses]} | masked "
          f"{[round(x, 6) for x in log_m.losses]} | max diff {diff:.3e}",
          flush=True)
    print(f"[olmoe fine-tune] p50 step ms over 2 x {steps} steps: kernel "
          f"path {p50['kernel']:.3f}, masked path {p50['masked']:.3f}, "
          f"standard full fine-tuning (d2ft off, einsum experts) "
          f"{p50['full']:.3f}; per round " + ", ".join(
              f"{k} {r[0]:.3f} / {r[1]:.3f}" for k, r in per_round.items())
          + f" {tag}")
    print(f"[olmoe fine-tune] tokens/s: kernel path "
          f"{B * S / p50['kernel'] * 1e3:.1f}, masked "
          f"{B * S / p50['masked'] * 1e3:.1f}, full "
          f"{B * S / p50['full'] * 1e3:.1f} {tag}")
    print("[olmoe fine-tune] max_memory_allocated, scoring included: " +
          ", ".join(f"{k} {v} bytes ({v / 2**30:.2f} GiB)"
                    for k, v in peaks.items()) + f" {tag}", flush=True)
    # where a kernel-path step's time goes
    torch.cuda.empty_cache()
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = sgd(MO_LR)
    state = opt.init(dict(model.named_parameters()))
    step = loop.make_train_step(cfg, opt, use_gates=True, use_kernel=True,
                                live_bounds=bounds)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(0, cfg.vocab_size, B, S, 1)).items()}
    gates = (g_f.cuda(), g_b.cuda())
    prof = profile_steps(torch, lambda: step(model, state, batch, gates),
                         "moe_")
    print_profile("3 kernel-path olmoe-1b-7b fine-tune steps (8 layers)",
                  prof, "d2ft MoE kernels", tag, breakdown=True)
    # full fine-tuning: all three dW, <2> and <1> once a layer each
    dw = dw_launches(prof[-1])
    if dw != {1: cfg.n_layers, 2: cfg.n_layers}:
        raise AssertionError(f"full fine-tune's dW kernel launches per step "
                             f"{dw}, not {cfg.n_layers} of each")
    print(f"[olmoe fine-tune] dW kernel launches per step: <2> {dw[2]:g} "
          f"(dW_up and dW_gate), <1> {dw[1]:g} (dW_down)", flush=True)
    del model, state, batch, opt, step
    torch.cuda.empty_cache()
    return {"launches": launches, "gates": (g_f[0].cuda(), g_b[0].cuda()),
            "bounds": bounds}


def moe_timing(torch, mo, tag):
    """Phase 22. Returns {"fwd"|"bwd"|"bwd_dw_up": (ms, plain_ms,
    library_ms, bound_ms, bound_by)} at phase 21's layer-0 operands, gates
    and bounds; "bwd_dw_up" is the backward as D2FT-LoRA's step asks for
    it (dW_up alone). Then the hd-128 attention kernels at olmoe-1b-7b's
    shapes under phase 21's gates and bounds."""
    operands = moe_operands(torch, mo["gates"], mo["bounds"])
    out = moe_times(torch, *operands, "phase 21's layer-0 operands and "
                    "gates", "moe timing", tag)
    print_resources("d2ft_moe_fwd", "moe timing")
    print_resources("d2ft_moe_bwd", "moe timing")
    del operands
    torch.cuda.empty_cache()

    # olmoe-1b-7b's attention: hd 128, 16 heads, one gate per head (G 16)
    cfg_h, cfg_hd = 16, 128
    g_f, g_b = mo["gates"]
    lf, lb = mo["bounds"]
    res = attention_timing_case(
        torch, torch.Generator(device="cuda").manual_seed(22),
        "hd-128 attention timing", "phase 21's layer-0 gates (causal)",
        MO_BATCH, cfg_h, MO_SEQ, cfg_hd, 0, g_f, g_b, lf, lb, tag)
    return out, res


def moe_times(torch, xb, wu, wg, wd, fs, bs, live, live_b, what_ops, label,
              tag, *, iters=20, dw_up=True):
    """CUDA-event times, L2 flushed, of both MoE kernels on the operands
    ``apply_moe`` hands ``ops._gated_moe_impl`` (the capacity buffer, the
    expert weights, both slot masks and slot bounds), and, with ``dw_up``,
    of the backward with dW_up alone (D2FT-LoRA's): through the launcher
    call and alone (buffers allocated outside the window), beside the plain
    version, a library yardstick (three torch.bmm and silu on the
    truncated buffer, its autograd backward) and both bounds. Returns
    {"fwd"|"bwd"[|"bwd_dw_up"]: (ms, plain_ms, library_ms, bound_ms,
    bound_by)}."""
    import torch.nn.functional as F
    from repro_torch.kernels import d2ft_moe as d2m
    from repro_torch.kernels import ops
    calls = []
    with torch.no_grad(), capture(d2m, "gated_moe_ffn", calls):
        ops._gated_moe_impl(xb, wu, wg, wd, fs, bs, act="silu",
                            block_c=MO_BLOCK_C, live_slots=live,
                            live_bwd_slots=live_b)
    (xs, _, _, _, fm, bm), kw = calls[0]
    del calls
    xs, fm, bm = (t.contiguous() for t in (xs, fm, bm))
    bc, nb = kw["block_c"], kw["bwd_blocks"]
    E, Cr, D = xs.shape
    Fd = wu.shape[2]
    cb = nb * bc
    up = (True, False, False)
    dy = torch.randn(xs.shape, generator=torch.Generator(
        device="cuda").manual_seed(22), device="cuda")
    fmn, bmn = fm.cpu().numpy(), bm[:, :nb].cpu().numpy()
    fl = {"fwd": d2m.gated_moe_flops(fmn, bmn, bc, D, Fd)[0],
          "bwd": d2m.bwd_flops(bmn, bc, D, Fd),
          "bwd_dw_up": d2m.bwd_flops(bmn, bc, D, Fd, up)}
    by = {"fwd": d2m.needed_bytes(fmn, bmn, bc, D, Fd)[0],
          "bwd": d2m.needed_bytes(fmn, bmn, bc, D, Fd)[1],
          "bwd_dw_up": d2m.needed_bytes(fmn, bmn, bc, D, Fd, need=up)[1]}

    def library(x, u, g, d):
        return torch.bmm(F.silu(torch.bmm(x, g)) * torch.bmm(x, u), d)

    def timed(fn):
        return time_ms(torch, fn, iters=iters, warmup=min(5, iters))

    # every product runs 3xTF32 on the tensor cores: held to that bound
    out = {"fwd": (
        timed(lambda: d2m.moe_fwd(xs, wu, wg, wd, fm, act="silu",
                                  block_c=bc)),
        timed(lambda: d2m.gated_moe_ffn_ref(xs, wu, wg, wd, fm, bm,
                                            act="silu", block_c=bc)),
        timed(lambda: library(xs, wu, wg, wd)),
        *tc_roofline(by["fwd"], fl["fwd"]))}
    # the backward as full fine-tuning asks for it (every input requiring
    # grad) and, with dw_up, as D2FT-LoRA's step does (x and w_up alone)
    kinds = [("bwd", (True, True, True))] + (
        [("bwd_dw_up", up)] if dw_up else [])
    for kind, need in kinds:
        refs = [xs.clone().requires_grad_()] + [
            w.clone().requires_grad_() if n else w
            for w, n in zip((wu, wg, wd), need)]
        ref = d2m.gated_moe_ffn_ref(*refs, fm, bm, act="silu", block_c=bc)
        lib_in = [xs[:, :cb].clone().requires_grad_()] + [
            w.clone().requires_grad_() if n else w
            for w, n in zip((wu, wg, wd), need)]
        lib_out = library(*lib_in)
        wants = [t for t in refs if t.requires_grad]
        lib_wants = [t for t in lib_in if t.requires_grad]
        out[kind] = (
            timed(lambda: d2m.moe_bwd(xs, wu, wg, wd, bm, dy, act="silu",
                                      block_c=bc, bwd_blocks=nb,
                                      need=need)),
            timed(lambda: torch.autograd.grad(ref, wants, dy,
                                              retain_graph=True)),
            timed(lambda: torch.autograd.grad(lib_out, lib_wants,
                                              dy[:, :cb],
                                              retain_graph=True)),
            *tc_roofline(by[kind], fl[kind]))
        del refs, ref, lib_in, lib_out, wants, lib_wants
        torch.cuda.empty_cache()
    # the kernels alone: outputs, scratch and the work list allocated once,
    # outside the timed window
    y, mid = torch.empty_like(xs), torch.empty((E, Cr, Fd), device="cuda")
    work_f = torch.empty((E * (Cr // bc) + 1,), dtype=torch.int32,
                         device="cuda")
    dx = torch.zeros_like(xs)
    dws = [torch.empty_like(w) for w in (wu, wg, wd)]
    dhg = torch.empty((E, cb, 2 * Fd), device="cuda")
    ah = torch.empty((E, cb, Fd), device="cuda")
    work_b = torch.empty((E * nb + 1,), dtype=torch.int32, device="cuda")
    alone = {
        "fwd": timed(lambda: d2m._fwd_call(
            xs, wu, wg, wd, fm, y, mid, work_f, bc, "silu")),
        "bwd": timed(lambda: d2m._bwd_call(
            xs, wu, wg, wd, bm, dy, dx, *dws, dhg, ah, work_b, nb, bc,
            "silu"))}
    if dw_up:
        alone["bwd_dw_up"] = timed(lambda: d2m._bwd_call(
            xs, wu, wg, wd, bm, dy, dx, dws[0], None, None, dhg, None,
            work_b, nb, bc, "silu"))
    live_t = {"fwd": int((fm != 0).sum()), "bwd": int((bm[:, :nb] != 0).sum())}
    what = {"fwd": "three torch.bmm and silu on the truncated buffer",
            "bwd": "their autograd backward, every input requiring grad",
            "bwd_dw_up": "their autograd backward, x and w_up alone "
                         "requiring grad"}
    for kind, (k_ms, p_ms, l_ms, b_ms, bb) in out.items():
        grid = tuple(fm.shape) if kind == "fwd" else (E, nb)
        print(f"[{label}] d2ft_moe_{kind} E {E} C {xb.shape[1]} -> "
              f"{Cr} D {D} F {Fd} block_c {bc}, {what_ops}, slot bounds "
              f"({live}, {live_b}): grid {grid}, "
              f"{live_t[kind[:3]]} live tiles: launcher call {k_ms:.4f} ms "
              f"(kernels alone, buffers allocated outside the window, "
              f"{alone[kind]:.4f} ms), plain {p_ms:.4f} ms, library "
              f"({what[kind]}) {l_ms:.4f} ms; bounds ({fl[kind] / 1e9:.1f} "
              f"GFLOP, {by[kind] / 1e6:.1f} MB): float32 FMA "
              f"{roofline(by[kind], fl[kind])[0]:.4f} ms, 3xTF32 tensor "
              f"cores {b_ms:.4f} ms by {bb}; held to the 3xTF32 one, "
              f"{b_ms / k_ms:.1%} of it ({b_ms / alone[kind]:.1%} alone); "
              f"{fl[kind] / k_ms / 1e9:.1f} TFLOP/s of float32 work through "
              f"the launcher {tag}", flush=True)
    del xs, y, mid, dx, dws, dhg, ah, dy
    torch.cuda.empty_cache()
    return out


def csrc_kernel_names():
    """The ``__global__`` functions of ``src/repro_torch/kernels/csrc``."""
    import re
    names = set()
    for f in (SRC / "repro_torch" / "kernels" / "csrc").glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(?:void\s+)?(\w+)\s*\(", f.read_text()))
    return names


def mb_step_fn(cfg, opt, n_mb, n_pf, remat=False):
    """A training step over ``core.d2ft.packed_forward_mb`` (the deployment
    form: no backward graph is built for the p_o part), as
    ``loop.make_train_step``'s packed step: mean token cross-entropy, the
    global-norm clip, the optimizer update. step(model, opt_state, batch,
    plan) with the plan's (idx, bwd, val) on the device."""
    from repro_torch.core.d2ft import packed_forward_mb
    from repro_torch.models.transformer import fused_xent
    from repro_torch.optim.optimizers import clip_by_global_norm
    from repro_torch.train import loop

    def step(model, opt_state, batch, plan):
        params = dict(model.named_parameters())
        logits, _ = packed_forward_mb(model, cfg, batch["tokens"], plan,
                                      n_mb, remat=remat, n_pf=n_pf)
        loss = fused_xent(logits, batch["labels"])
        grads, gnorm = clip_by_global_norm(loop._grads(loss, params), 1.0)
        opt.update(grads, opt_state, params)
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}
    return step


def mb_drive(torch, cfg, sched, B, S, steps, lr):
    """The launcher's loop (``loop.finetune`` with its settings) over
    ``mb_step_fn``: the model from seed 0, AdamW, the plan of
    ``mb_packed_indices`` on the device before each step, the batch copied
    in inside the timed step. Returns a TrainLog."""
    from repro_torch.core.d2ft import mb_packed_indices
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.loop import TrainLog

    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw(lr)
    state = opt.init(dict(model.named_parameters()))
    n_mb = sched.n_microbatches
    plan = mb_packed_indices(sched, n_mb)
    step = mb_step_fn(cfg, opt, n_mb, int(plan[1].sum(-1).max()))
    log = TrainLog()
    for batch in lm_batches(0, cfg.vocab_size, B, S, steps):
        dev_plan = tuple(torch.as_tensor(a, device="cuda") for a in plan)
        t0 = time.perf_counter()
        _, state, m = step(model, state, {
            k: torch.as_tensor(v, device="cuda") for k, v in batch.items()},
            dev_plan)
        torch.cuda.synchronize()
        log.step_times.append(time.perf_counter() - t0)
        log.losses.append(float(m["loss"]))
    return log


def turns(torch, np, run, names):
    """Every path of ``names`` twice, in turns (names, then names
    reversed), so that no path gains from running later in the process.
    Returns (first-round logs, p50 ms over both rounds, per-round p50 ms,
    first-round peak memory, each run's wall seconds by path)."""
    logs, times, peaks = {}, {n: [] for n in names}, {}
    walls = {n: [] for n in names}
    for name in list(names) + list(reversed(names)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        log = run(name)
        walls[name].append(time.perf_counter() - t0)
        if name not in logs:
            logs[name] = log
            peaks[name] = torch.cuda.max_memory_allocated()
        times[name].append(log.step_times)
    p50 = {n: 1e3 * float(np.median(t[0] + t[1])) for n, t in times.items()}
    per = {n: [1e3 * float(np.median(x)) for x in t]
           for n, t in times.items()}
    return logs, p50, per, peaks, walls


def step_flops(torch, step):
    """FLOPs ``FlopCounterMode`` counts over one call of step(): the aten
    matmuls, einsums and attention ops of the forward and backward (the
    hand-written kernels are no aten ops and are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        step()
    torch.cuda.synchronize()
    return fc.get_total_flops()


def kernel_kinds(named):
    """Device ms per step by kind of kernel (``profile_steps``' by-name
    sums): GEMMs, the gathers and scatter-adds (index_select /
    index_add), softmax, reductions, elementwise passes, the rest."""
    kinds = (("GEMM", "gemm"), ("gather/scatter", "index"),
             ("softmax", "softmax"), ("reductions", "reduce"),
             ("elementwise", "elementwise"))
    out = dict.fromkeys([k for k, _ in kinds] + ["other"], 0.0)
    for name, (ms, _) in named.items():
        kind = next((k for k, sub in kinds if sub in name.lower()), "other")
        out[kind] += ms
    return out


def packed_finetune(torch, np, tag):
    """Phase 23a on gemma3-1b at full width, ``PK_LAYERS`` of its layers
    (the launcher builds the cut config). Returns the phase's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    cfg = get_config("gemma3-1b").replace(n_layers=PK_LAYERS)
    get = launcher.get_config
    launcher.get_config = lambda arch: cfg if arch == "gemma3-1b" \
        else get(arch)
    try:
        return _packed_finetune(torch, np, tag, cfg)
    finally:
        launcher.get_config = get


def _packed_finetune(torch, np, tag, cfg):
    from repro_torch.core.cost_model import compute_cost
    from repro_torch.core.d2ft import mb_packed_indices, packed_forward
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds, packed_indices)
    from repro_torch.data.synthetic import lm_batches, microbatch_assignment
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.models.transformer import fused_xent, init_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train import loop

    t_phase = time.perf_counter()
    B, S, n_mb, steps = GM_BATCH, GM_SEQ, GM_D2FT["n_microbatches"], PK_STEPS
    mb_of = microbatch_assignment(B, n_mb)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(0, cfg.vocab_size, B, S, 1)).items()}
    csrc = csrc_kernel_names()
    full = {}
    kept = {}
    secs = dict.fromkeys(("runs", "FLOP counts", "repeat", "profiles",
                          "remat"), 0.0)
    for n_pf, n_po in PK_BUDGETS:
        argv = ["--arch", "gemma3-1b", "--full", "--batch", str(B), "--seq",
                str(S), "--steps", str(steps), "--lr", str(GM_LR),
                "--n-microbatches", str(n_mb), "--n-pf", str(n_pf),
                "--n-po", str(n_po)]
        run, scheds = launcher_paths(argv, own={"mb": lambda: mb_drive(
            torch, cfg, scheds[0], B, S, steps, GM_LR)})
        names = ("packed", "mb", "masked", "kernel") + \
            (("full",) if not full else ())
        before = (d2a.flash_fwd.launches, d2a.flash_bwd.launches)
        t0 = time.perf_counter()
        logs, p50, per, peaks, walls = turns(torch, np, run, names)
        secs["runs"] += time.perf_counter() - t0
        if not full:
            full = {"p50": p50["full"], "per": per["full"],
                    "peak": peaks["full"]}
        sched = scheds[0]
        want = 2 * cfg.n_layers * steps
        if (d2a.flash_fwd.launches - before[0],
                d2a.flash_bwd.launches - before[1]) != (want, want):
            raise AssertionError("attention kernels launched outside the "
                                 "kernel path's two runs")
        d_pk = check_losses(np, logs["packed"], logs["masked"])
        d_mb = check_losses(np, logs["mb"], logs["masked"])
        idx, bwd, val, c_f = packed_indices(sched, mb_of)
        plan_mb = mb_packed_indices(sched, n_mb)
        cost = compute_cost(sched.table)

        # FLOPs of one step of each path on one model (seed 0)
        model = init_model(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
        opt = adamw(GM_LR)
        state = opt.init(dict(model.named_parameters()))
        g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
        gates = (g_f.cuda(), g_b.cuda())
        plan = tuple(torch.as_tensor(a, device="cuda")
                     for a in (idx, bwd, val))
        dev_mb = tuple(torch.as_tensor(a, device="cuda") for a in plan_mb)
        steps_of = {
            "packed": (loop.make_train_step(cfg, opt, use_gates=True,
                                            packed=True), plan),
            "mb": (mb_step_fn(cfg, opt, n_mb, int(plan_mb[1].sum(-1).max())),
                   dev_mb),
            "masked": (loop.make_train_step(cfg, opt, use_gates=True), gates),
            "kernel": (loop.make_train_step(
                cfg, opt, use_gates=True, use_kernel=True,
                live_bounds=live_slice_bounds(sched, mb_of)), gates)}
        if "flops" not in full:
            steps_of["full"] = (loop.make_train_step(cfg, opt,
                                                     use_gates=False), None)
        flops = {}
        t0 = time.perf_counter()
        for name, (fn, args) in steps_of.items():
            flops[name] = step_flops(torch, lambda: fn(model, state, batch,
                                                       args))
        secs["FLOP counts"] += time.perf_counter() - t0
        full.setdefault("flops", flops.pop("full", None))
        print(f"[packed] gemma3-1b full width, {cfg.n_layers} of 26 "
              f"layers (d "
              f"{cfg.d_model}, {cfg.n_heads} query heads and "
              f"{cfg.n_kv_heads} KV head of {cfg.resolved_head_dim}, f32, "
              f"seed 0) through repro_torch.launch.train --d2ft --packed, "
              f"batch {B} x seq {S} in {n_mb} micro-batches, n_pf {n_pf} "
              f"n_po {n_po}, G {sched.n_groups}, AdamW lr {GM_LR}, {steps} "
              f"steps: per (layer, group) {idx.shape[-1]} gathered samples "
              f"({c_f} p_f) of {B}, {plan_mb[0].shape[-1]} micro-batches in "
              f"the micro-batch form; schedule compute_cost {cost:.3f}",
              flush=True)
        print(f"[packed] losses packed "
              f"{[round(x, 6) for x in logs['packed'].losses]} | micro-batch "
              f"{[round(x, 6) for x in logs['mb'].losses]} | masked "
              f"{[round(x, 6) for x in logs['masked'].losses]} | max diff "
              f"packed {d_pk:.3e}, micro-batch {d_mb:.3e} (<= 1e-4 x max(1, "
              f"|loss|))", flush=True)
        p50["full"], per["full"] = full["p50"], full["per"]
        print(f"[packed] {n_pf}+{n_po} p50 step ms over 2 x {steps} steps: "
              + ", ".join(f"{k} {v:.3f}" for k, v in p50.items())
              + "; per round " + ", ".join(
                  f"{k} {r[0]:.3f} / {r[1]:.3f}" for k, r in per.items())
              + f" {tag}")
        print(f"[packed] {n_pf}+{n_po} wall s of each run (model init and "
              f"the first run's scoring included): " + ", ".join(
                  f"{k} " + " / ".join(f"{w:.1f}" for w in v)
                  for k, v in walls.items()), flush=True)
        print(f"[packed] {n_pf}+{n_po} tokens/s: " + ", ".join(
            f"{k} {B * S / v * 1e3:.1f}" for k, v in p50.items()) + f" {tag}")
        peaks["full"] = full["peak"]
        print(f"[packed] {n_pf}+{n_po} max_memory_allocated of each path's "
              f"first run (the first packed run's includes scoring): " +
              ", ".join(f"{k} {v} bytes ({v / 2**30:.2f} GiB)"
                        for k, v in peaks.items()) + f" {tag}", flush=True)
        print(f"[packed] {n_pf}+{n_po} FLOPs of one step (FlopCounterMode: "
              f"aten matmuls, forward and backward; the kernel path's "
              f"attention kernels not counted): " + ", ".join(
                  f"{k} {v:.4e} ({v / full['flops']:.4f} of full)"
                  for k, v in flops.items())
              + f", full {full['flops']:.4e}; schedule compute_cost "
              f"{cost:.4f}", flush=True)
        if (n_pf, n_po) == PK_PROFILE_BUDGET:
            kept = dict(model=model, opt=opt, state=state, plan=plan,
                        sched=sched, steps=steps_of)
        else:
            del model, state, opt, steps_of
        torch.cuda.empty_cache()

    # two calls of the packed loss and gradients on the same inputs
    model, state, plan = kept["model"], kept["state"], kept["plan"]
    params = list(model.parameters())

    def loss_grads():
        logits, _ = packed_forward(model, cfg, batch["tokens"], plan)
        loss = fused_xent(logits, batch["labels"])
        return [loss.detach()] + list(torch.autograd.grad(loss, params))

    t0 = time.perf_counter()
    a = loss_grads()
    b = loss_grads()
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    worst = max(float((x - y).abs().max()) for x, y in zip(a, b))
    del a, b
    secs["repeat"] = time.perf_counter() - t0
    print(f"[packed] two calls of the packed loss and its {len(params)} "
          f"gradients on the same inputs: bitwise equal {equal}, largest "
          f"difference {worst:.3e}", flush=True)

    # where a packed step's time goes, beside the micro-batch form's and
    # full fine-tuning's
    t0 = time.perf_counter()
    steps_of = kept["steps"]
    steps_of["full"] = (loop.make_train_step(cfg, kept["opt"],
                                             use_gates=False), None)
    # (one step in the windows beside the packed path's three: a window's
    # trace takes the profiler ~20 s to process on this path)
    for name, n_prof in (("packed", 3), ("mb", 1), ("full", 1)):
        fn, args = steps_of[name]
        busy, wall, idle, _, _, top, named = profile_steps(
            torch, lambda: fn(model, state, batch, args), "", n_prof)
        hits = sorted(k for k in named if any(c in k for c in csrc))
        if hits:
            raise AssertionError(f"csrc kernels ran on the {name} path: "
                                 f"{hits}")
        print(f"[profile] {n_prof} {name}-path gemma3-1b step(s) "
              f"({PK_PROFILE_BUDGET[0]}+{PK_PROFILE_BUDGET[1]}): device busy "
              f"{busy:.3f} ms per step, wall {wall:.3f} ms per step under "
              f"the profiler, idle share {idle:.1%}; none of the "
              f"{len(csrc)} kernels of csrc/ among its {len(named)} kernels; "
              f"device ms per step by kind: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in kernel_kinds(named).items())
              + f" {tag}")
        if name == "packed":
            print("[profile] top device time per step: " + "; ".join(
                f"{k[:60]} x{c}: {t:.3f} ms" for t, c, k in top),
                flush=True)
    secs["profiles"] = time.perf_counter() - t0
    sched = kept["sched"]
    del model, state, params, plan, steps_of, fn, args
    kept.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()

    # remat: the same steps with each layer checkpointed
    plan_np = packed_indices(sched, mb_of)[:3]
    res = {}
    for remat in (False, True):
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        opt = adamw(GM_LR)
        state = opt.init(dict(model.named_parameters()))
        step = loop.make_train_step(cfg, opt, use_gates=True, packed=True,
                                    remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for bt in lm_batches(0, cfg.vocab_size, B, S, PK_REMAT_STEPS):
            dev_plan = tuple(torch.as_tensor(x, device="cuda")
                             for x in plan_np)
            t0 = time.perf_counter()
            _, state, m = step(model, state, {
                k: torch.as_tensor(v, device="cuda") for k, v in bt.items()},
                dev_plan)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        res[remat] = (losses, torch.cuda.max_memory_allocated(), ms)
        del model, state, opt, step
        torch.cuda.empty_cache()
    off, on = res[False], res[True]
    diff = np.abs(np.asarray(on[0]) - np.asarray(off[0]))
    if not (np.isfinite(on[0]).all() and (diff <= 1e-4 * np.maximum(
            1.0, np.abs(np.asarray(off[0])))).all()):
        raise AssertionError(f"remat losses {on[0]} vs {off[0]}")
    print(f"[packed] remat ({PK_REMAT_STEPS} packed steps, each layer "
          f"checkpointed): losses {[round(x, 6) for x in on[0]]} vs "
          f"{[round(x, 6) for x in off[0]]} without (max diff "
          f"{float(diff.max()):.3e}); max_memory_allocated {on[1]} bytes "
          f"({on[1] / 2**30:.2f} GiB) vs {off[1]} ({off[1] / 2**30:.2f} GiB); "
          f"step ms {[round(x, 1) for x in on[2]]} vs "
          f"{[round(x, 1) for x in off[2]]} {tag}", flush=True)
    secs["remat"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(f"[packed] phase 23a in {total:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return total


def packed_examples(torch, np, tag):
    """Phase 23b: the two examples at their own sizes."""
    from repro_torch.examples import d2ft_llm_finetune, quickstart

    t0 = time.perf_counter()
    p50 = {}
    for name, kw in (("packed", dict(packed=True)),
                     ("kernel", dict(use_kernel=True)), ("masked", {})):
        log = d2ft_llm_finetune.run(device="cuda", steps=PK_EXAMPLE_STEPS,
                                    **kw)
        if len(log.losses) != PK_EXAMPLE_STEPS or \
                not np.isfinite(log.losses).all():
            raise AssertionError(f"LLM example, {name} path: losses "
                                 f"{log.losses}")
        p50[name] = (1e3 * float(np.median(log.step_times)), log.losses)
    cfg = d2ft_llm_finetune.CFG
    print(f"[examples] d2ft_llm_finetune.run ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab_size}, "
          f"batch {d2ft_llm_finetune.BATCH} x {d2ft_llm_finetune.SEQ}, 2 p_f "
          f"+ 1 p_o of 4, G 12), {PK_EXAMPLE_STEPS} steps: p50 step ms " +
          ", ".join(f"{k} {v[0]:.3f} (loss {v[1][0]:.3f} -> {v[1][-1]:.3f})"
                    for k, v in p50.items()) + f" {tag}", flush=True)
    acc_d2ft, acc_std = quickstart.run(device="cuda")
    for acc in (acc_d2ft, acc_std):
        if not 0.0 <= acc <= 1.0:
            raise AssertionError(f"quickstart top-1 {acc}")
    print(f"[examples] quickstart.run: top-1 D2FT@68% {acc_d2ft:.3f}, "
          f"standard@100% {acc_std:.3f}; both examples in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def family_requests(np, cfg, prompts, news, seed=0):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(seed)
    return [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=s)
                    .astype(np.int32), max_new_tokens=m)
            for i, (s, m) in enumerate(zip(prompts, news))]


def serve_trace(torch, np, model, cfg, reqs, use_kernel, *, warm=False):
    """Serve ``reqs`` through a fresh engine (4 slots, page size 16, the
    pool the trace's worst case needs); with ``warm``, one short request
    through another engine first. Returns (out, engine, decode-step s,
    prefill s per request in admission order, kernel launches, run s).
    Fails unless every request finishes with its prompt kept and every
    page returns."""
    from repro_torch.kernels.paged_decode import paged_flash_decode
    from repro_torch.serving.engine import PagedServingEngine, Request
    from repro_torch.serving.pages import pages_needed
    max_seq = max(r.prompt_len + r.max_new_tokens for r in reqs)
    kw = dict(page_size=PAGE_SIZE, max_slots=MAX_SLOTS, max_seq_len=max_seq,
              n_pages=MAX_SLOTS * pages_needed(max_seq, PAGE_SIZE) + 1,
              use_kernel=use_kernel)
    if warm:
        PagedServingEngine(model, cfg, **kw).run(
            [Request(uid=0, prompt=reqs[0].prompt, max_new_tokens=4)])
    eng = PagedServingEngine(model, cfg, **kw)
    step_s, prefill_s = [], []

    def timed(fn, sink):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t)
            return out
        return call

    eng._prefill = timed(eng._prefill, prefill_s)
    eng._step = timed(eng._step, step_s)
    before = paged_flash_decode.launches
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    for r in reqs:
        got = out.get(r.uid)
        if got is None or len(got) != r.prompt_len + r.max_new_tokens or \
                not np.array_equal(got[:r.prompt_len], r.prompt) or \
                got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name}: request {r.uid} did not "
                                 "finish cleanly")
    if eng.pm.n_free != eng.pm.capacity or eng.n_live or eng.waiting:
        raise AssertionError(f"{cfg.name}: pages leaked: {eng.stats()}")
    return (out, eng, step_s, prefill_s,
            paged_flash_decode.launches - before, run_s)


def first_difference(torch, model, cfg, req, mine, theirs, what):
    """Raise naming the first token where two greedy runs of ``req``
    differ, with the plain forward's two top logits at that step (so a
    near tie shows as one)."""
    from repro_torch.models.transformer import forward
    pos = next(i for i in range(len(mine)) if mine[i] != theirs[i])
    with torch.inference_mode():
        logits, _ = forward(model, cfg, torch.as_tensor(
            mine[None, :pos], device="cuda").long())
    top = torch.topk(logits[0, -1], 2)
    raise AssertionError(
        f"{cfg.name}, request {req.uid} (prompt {req.prompt_len}): {what} "
        f"differ first at position {pos} ({int(mine[pos])} against "
        f"{int(theirs[pos])}); the forward's top two logits there "
        f"{top.values.tolist()} at {top.indices.tolist()}")


def serve_line(np, cfg, eng, reqs, step_s, prefill_s, run_s, tag):
    n_gen = sum(r.max_new_tokens for r in reqs)
    print(f"[serve families] {cfg.name}: {eng.n_steps} decode steps, p50 "
          f"decode step ms {1e3 * float(np.median(step_s)):.3f} (min "
          f"{1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}); time to "
          f"first token (the admission's prefill call) p50 "
          f"{1e3 * float(np.median(prefill_s)):.2f} ms, per prompt "
          + ", ".join(f"{r.prompt_len}: {1e3 * t:.1f}"
                      for r, t in zip(reqs, prefill_s))
          + f"; generated tokens/s {n_gen / run_s:.2f} ({n_gen} tokens in "
          f"{run_s:.3f} s incl. prefill) {tag}", flush=True)


def serve_profile(torch, model, cfg, eng, reqs, key, use_kernel, tag):
    """A profiler window over 5 decode steps of the trace's four longest
    requests in a fresh engine shaped as ``eng``: busy and idle share, top
    kernels, and the share of busy time of the kernels whose name holds
    ``key``."""
    from repro_torch.serving.engine import PagedServingEngine
    prof_eng = PagedServingEngine(model, cfg, page_size=PAGE_SIZE,
                                  max_slots=MAX_SLOTS,
                                  max_seq_len=eng.max_seq_len,
                                  n_pages=eng.pm.n_pages,
                                  use_kernel=use_kernel)
    for r in reqs[-MAX_SLOTS:]:
        prof_eng.submit(r)
    prof_eng.step()                                # admits all four
    prof = profile_steps(torch, prof_eng.step, key, n_prof=5)
    print_profile(f"{cfg.name}, 5 decode steps, 4 live slots (prompts "
                  f"{[r.prompt_len for r in reqs[-MAX_SLOTS:]]})", prof, key,
                  tag)


def serve_families(torch, np, tag):
    """Phase 24. Returns B10's launches over the phase's kernel-path
    engine runs."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    from repro_torch.examples import serve
    from repro_torch.models.transformer import init_model, prefill_forward
    from repro_torch.serving.decode import generate, prefill_sequential
    t_phase = time.perf_counter()
    launches = 0

    def attn_layers(cfg):
        return sum(k in (ATTN_GLOBAL, ATTN_LOCAL) for k in cfg.layer_kinds)

    def model_of(cfg):
        with torch.no_grad():
            return init_model(torch.Generator(device="cuda").manual_seed(0),
                              cfg)

    # (a) recurrentgemma-2b: B10 at rep 10, window 2048, crossed in decode
    t0 = time.perf_counter()
    cfg = get_config("recurrentgemma-2b")
    model = model_of(cfg)
    reqs = family_requests(np, cfg, RS_PROMPTS, RS_NEW)
    out, eng, step_s, prefill_s, n_k, run_s = serve_trace(
        torch, np, model, cfg, reqs, True, warm=True)
    n_attn = attn_layers(cfg)
    if n_k != n_attn * eng.n_steps or n_k == 0:
        raise AssertionError(f"recurrentgemma-2b: kernel launches {n_k} != "
                             f"{n_attn} x {eng.n_steps} decode steps")
    launches += n_k
    plain, *_ = serve_trace(torch, np, model, cfg, reqs, False)
    for r in reqs:
        if not np.array_equal(out[r.uid], plain[r.uid]):
            first_difference(torch, model, cfg, r, out[r.uid],
                             plain[r.uid], "kernel and gather-path tokens")
    crossing = [r for r in reqs
                if r.prompt_len + r.max_new_tokens > cfg.window]
    if len(crossing) < 2:
        raise AssertionError("fewer than two requests cross the window")
    for r in crossing:
        alone = generate(model, cfg, torch.as_tensor(
            r.prompt[None], device="cuda").long(), r.max_new_tokens)
        alone = alone[0].cpu().numpy()
        if not np.array_equal(out[r.uid], alone):
            first_difference(torch, model, cfg, r, out[r.uid], alone,
                             "engine and generate tokens")
    print(f"[serve families] recurrentgemma-2b full size ({cfg.n_layers} "
          f"layers: {cfg.n_layers - n_attn} RG-LRU, {n_attn} local attention "
          f"of {cfg.n_heads} heads on {cfg.n_kv_heads} KV head of "
          f"{cfg.resolved_head_dim}, window {cfg.window}; d {cfg.d_model}, "
          f"f32, seed 0), "
          f"{len(reqs)} requests / {MAX_SLOTS} slots, prompts "
          f"{list(RS_PROMPTS)}, new {list(RS_NEW)}: paged_decode launches "
          f"{n_k} = {n_attn} x {eng.n_steps}, all finished, pool drained, "
          f"tokens == gather path; requests "
          f"{[r.uid for r in crossing]} pass {cfg.window} tokens in decode "
          f"and equal generate run on each alone "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    serve_line(np, cfg, eng, reqs, step_s, prefill_s, run_s, tag)
    serve_profile(torch, model, cfg, eng, reqs, "paged_decode", True, tag)
    del model, eng
    torch.cuda.empty_cache()

    # (b) mamba2-130m: the same trace shape, SSD state in the slots
    t0 = time.perf_counter()
    cfg = get_config("mamba2-130m")
    model = model_of(cfg)
    reqs = family_requests(np, cfg, RS_PROMPTS, RS_NEW)
    out, eng, step_s, prefill_s, n_k, run_s = serve_trace(
        torch, np, model, cfg, reqs, False, warm=True)
    if n_k:
        raise AssertionError(f"mamba2-130m launched paged_decode {n_k} times")
    for r in reqs:
        alone = generate(model, cfg, torch.as_tensor(
            r.prompt[None], device="cuda").long(), r.max_new_tokens)
        alone = alone[0].cpu().numpy()
        if not np.array_equal(out[r.uid], alone):
            first_difference(torch, model, cfg, r, out[r.uid], alone,
                             "engine and generate tokens")
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, 64)), device="cuda").long()
    with torch.inference_mode():
        _, dumped = prefill_forward(model, cfg, toks, raw_kv=True)
        _, seq = prefill_sequential(model, cfg, toks, 64)
    rel = max(float((a["state"] - b["state"]).abs().max()
                    / b["state"].abs().max()) for a, b in zip(dumped, seq))
    if not rel <= 1e-4:
        raise AssertionError(f"mamba2-130m: the prefill dump's SSD state is "
                             f"{rel:.3e} relative from prefill_sequential's")
    print(f"[serve families] mamba2-130m full size ({cfg.n_layers} SSD "
          f"layers, d {cfg.d_model}, chunk {cfg.ssm.chunk}, f32, seed 0), "
          f"the same "
          f"trace: all finished, pool drained, tokens == generate on each "
          f"request alone; the prefill dump's SSD state on a 64-token "
          f"prompt {rel:.3e} relative from prefill_sequential's (<= 1e-4) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    serve_line(np, cfg, eng, reqs, step_s, prefill_s, run_s, tag)
    serve_profile(torch, model, cfg, eng, reqs, "gemm", False, tag)
    del model, eng
    torch.cuda.empty_cache()

    # (c) olmoe-1b-7b: 64 experts top 8 in every layer, B10 at rep 1
    t0 = time.perf_counter()
    full = get_config("olmoe-1b-7b")
    cfg = full.replace(n_layers=min(full.n_layers, MO_SERVE_LAYERS))
    model = model_of(cfg)
    init_s = time.perf_counter() - t0
    reqs = family_requests(np, cfg, MO_SERVE_PROMPTS, MO_SERVE_NEW)
    out, eng, step_s, prefill_s, n_k, run_s = serve_trace(
        torch, np, model, cfg, reqs, True, warm=True)
    n_attn = attn_layers(cfg)
    if n_k != n_attn * eng.n_steps or n_k == 0:
        raise AssertionError(f"olmoe-1b-7b: kernel launches {n_k} != "
                             f"{n_attn} x {eng.n_steps} decode steps")
    launches += n_k
    plain, *_ = serve_trace(torch, np, model, cfg, reqs, False)
    for r in reqs:
        if not np.array_equal(out[r.uid], plain[r.uid]):
            first_difference(torch, model, cfg, r, out[r.uid],
                             plain[r.uid], "kernel and gather-path tokens")
    print(f"[serve families] olmoe-1b-7b full width ({cfg.n_layers} of "
          f"{full.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.moe.n_experts} experts top {cfg.moe.top_k}, "
          f"f32, seed 0; init {init_s:.1f} s), {len(reqs)} requests / "
          f"{MAX_SLOTS} slots, prompts {list(MO_SERVE_PROMPTS)}, new "
          f"{list(MO_SERVE_NEW)}: paged_decode launches {n_k} = {n_attn} x "
          f"{eng.n_steps}, all finished, pool drained, tokens == gather "
          f"path ({time.perf_counter() - t0:.1f} s)", flush=True)
    serve_line(np, cfg, eng, reqs, step_s, prefill_s, run_s, tag)
    serve_profile(torch, model, cfg, eng, reqs, "paged_decode", True, tag)
    del model, eng
    torch.cuda.empty_cache()

    # (d) the serve example at its smoke configs
    t0 = time.perf_counter()
    outs = serve.run(torch.device("cuda"))
    for arch, o in outs.items():
        if tuple(o.shape) != (serve.BATCH, serve.PROMPT + serve.NEW):
            raise AssertionError(f"serve example, {arch}: {tuple(o.shape)}")
    print(f"[serve families] the serve example: {sorted(outs)} in "
          f"{time.perf_counter() - t0:.1f} s; phase 24 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def plain_sgd(torch, lr):
    """SGD without momentum: no moment buffers, so that a 5.4 B-parameter
    float32 model, its gradients and a step's activations fit on one
    80 GB card (``optim.sgd`` keeps a momentum buffer, even at 0)."""
    from repro_torch.optim.optimizers import Optimizer

    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        with torch.no_grad():
            for n, p in params.items():
                p.add_(grads[n], alpha=-lr)
        state["step"] += 1
        return params, state
    return Optimizer(init, update, elidable=True, n_moments=0)


def head_groups(cfg):
    """D2FT head groups of a phase-25 run: one a head, as the launcher
    gives them, unless the dense FFN's width does not split into that many
    column groups (qwen1.5-32b: 40 heads, d_ff 27392 = 2^8 x 107), then the
    largest count that tiles both."""
    if cfg.moe is None and cfg.d_ff > 0:
        return math.gcd(cfg.n_heads, cfg.d_ff)
    return cfg.n_heads


def feature_batches(np, cfg, B, seq, steps, seed=0):
    """numpy batches of ``seq`` positions for ``loop.finetune``: for a
    frontend arch unit-normal stub embeddings of ``frontend.feature_spec``'s
    shape, with ``lm_batches``' text tokens and labels after a vision
    prefix, or uniform frame labels for an audio encoder; for a text arch
    ``lm_batches``."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.frontends import feature_spec, text_len
    n_text = text_len(cfg, seq)
    text = lm_batches(seed, cfg.vocab_size, B, n_text, steps) \
        if n_text else None
    rng = np.random.default_rng(seed + 1)
    for _ in range(steps):
        spec = feature_spec(cfg, B, seq)
        out = {} if spec is None else {
            "features": rng.standard_normal(spec[0], dtype=np.float32)}
        if text is not None:
            out.update(next(text))
        else:
            out["labels"] = rng.integers(0, cfg.vocab_size, (B, seq)) \
                .astype(np.int32)
        yield out


def capture_first(torch, module, name, sink):
    """Context manager: the first call of ``module.name`` records its
    (args, kwargs) in ``sink``, tensors detached (they outlive the step's
    graph); every call runs as before."""
    import contextlib

    @contextlib.contextmanager
    def patched():
        orig = getattr(module, name)

        def grab(*a, **k):
            if not sink:
                sink.append((tuple(t.detach() if isinstance(t, torch.Tensor)
                                   else t for t in a), dict(k)))
            return orig(*a, **k)
        setattr(module, name, grab)
        try:
            yield sink
        finally:
            setattr(module, name, orig)
    return patched()


def predicted_launches(cfg, steps):
    """``moe_launches`` after ``steps`` kernel-path steps: one B2 forward
    and backward an attention layer, one B8 and B9 call a layer with an
    MoE FFN."""
    n_attn = sum(k in ("attn_global", "attn_local") for k in cfg.layer_kinds)
    n_moe = cfg.n_layers if cfg.moe is not None else 0
    return {"fwd": n_moe * steps, "bwd": n_moe * steps,
            "attn_fwd": n_attn * steps, "attn_bwd": n_attn * steps}


def attention_operands_vs_plain(torch, name, call, gen):
    """B2 forward and backward on the operands the main path handed its
    first call (q, k, v [B, H, S, hd] with kv heads expanded, the per-head
    gates and bounds) and a unit-normal cotangent, against the plain
    version: o / lse <= 1e-5, grads <= 1e-4 (each x max(1, max |plain|)),
    exact zeros, executed tiles = live slices x live tiles. Returns (o/lse
    err, grad err, the call's shape and mask)."""
    (q, k, v, g_f, g_b), kw = call
    causal, window = kw["causal"], kw.get("window", 0)
    live = (kw.get("live_fwd"), kw.get("live_bwd"))
    do = torch.randn(q.shape, generator=gen, device="cuda")
    e_f, e_b, s_f, s_b, zeros, counts, want = attention_case(
        torch, q, k, v, do, g_f, g_b, causal=causal, window=window,
        live=live)
    B, H, S, hd = q.shape
    what = (f"{name}'s layer-0 operands (B {B} H {H} S {S} hd {hd}, "
            f"{'causal' if causal else 'bidirectional'}, window {window}, "
            f"bounds {live})")
    if e_f > KERNEL_TOL * max(1.0, s_f) or e_b > GRAD_TOL * max(1.0, s_b) \
            or not zeros or counts != want:
        raise AssertionError(
            f"attention kernels vs plain, {what}: o/lse err {e_f} (max "
            f"|plain| {s_f}), grad err {e_b} (max |plain| {s_b}), exact "
            f"zeros {zeros}, tiles {counts} != {want}")
    print(f"[new archs vs plain] d2ft_attention {what}: live "
          f"{int((g_f != 0).sum())}/{int((g_b != 0).sum())} of {B * H}, "
          f"o/lse err {e_f:.3e} (max |plain| {s_f:.3g}), grad err "
          f"{e_b:.3e} (max |plain| {s_b:.3g}), zeros exact, tiles = live "
          f"slices x live tiles", flush=True)
    return e_f, e_b, (B, H, S, hd, causal, window)


def moe_operands_vs_plain(torch, name, call, gen):
    """B8 / B9 on the operands the main path handed ``ops._gated_moe_impl``
    at its first call (layer 0's capacity buffer, expert weights, slot
    masks and bounds), against the plain version and its autograd
    gradients: y <= 1e-5, dx / dW <= 1e-4, each x max(1, max |plain|),
    exact zeros on dead tiles, executed tiles = the launched masks'."""
    (xb, wu, wg, wd, fs, bs), kw = call
    live, live_b = kw["live_slots"], kw["live_bwd_slots"]
    dy = torch.randn(xb.shape, generator=gen, device="cuda")
    errs, scale, zeros, counts, mirror, grids, _ = moe_case(
        torch, xb, wu, wg, wd, dy, fs, bs, act=kw["act"], live=live,
        live_b=live_b)
    tols = [KERNEL_TOL] + [GRAD_TOL] * 4
    bad = [i for i, (e, s, t) in enumerate(zip(errs, scale, tols))
           if not e <= t * max(1.0, s)]
    E, C, D = xb.shape
    what = (f"{name}'s layer-0 operands (E {E} C {C} D {D} F "
            f"{wu.shape[2]}, slot bounds ({live}, {live_b}), grids {grids})")
    if bad or not zeros or counts["moe_fwd"] != mirror["moe_fwd"] or \
            counts["moe_bwd"] != mirror["moe_bwd"]:
        raise AssertionError(
            f"MoE kernels vs plain, {what}: errors [y, dx, dW_up, dW_gate, "
            f"dW_down] {errs} against max |plain| {scale}, exact zeros "
            f"{zeros}, tiles {counts} != the masks' {mirror}")
    print(f"[new archs vs plain] d2ft_moe {what}: errors [y, dx, dW_up, "
          f"dW_gate, dW_down] " + ", ".join(f"{e:.3e}" for e in errs)
          + " against max |plain| " + ", ".join(f"{s:.3g}" for s in scale)
          + f", zeros exact, tiles {counts['moe_fwd']} / "
          f"{counts['moe_bwd']} = the launched masks'", flush=True)
    return max(errs[:1]), max(errs[1:])


def arch_finetune(torch, np, arch, cfg, B, seq, what, tag):
    """Phase 25b-d: ``loop.finetune(..., use_kernel=True)`` on ``cfg``
    (random weights from seed 0, f32), batch B x ``seq`` positions of
    ``feature_batches`` in 4 micro-batches, n_pf 3 / n_po 1, G =
    ``head_groups(cfg)``, momentum-free SGD, NA_STEPS steps: launches
    against the schedule's count, executed tiles, the first-step loss
    against the masked path's on the same weights, schedule and batch
    (its forward, without gradients), finite losses, p50 step ms, peak
    memory. Returns {"heads": layer 0's per-head gates, "bounds":
    per-head bounds, "attn": B2's first call, "moe": ``_gated_moe_impl``'s
    first call or None}."""
    from types import SimpleNamespace
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import microbatch_assignment
    from repro_torch.kernels import contract, ops
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.kernels import d2ft_moe as d2m
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import init_model, lm_loss
    from repro_torch.train import loop

    t0 = time.perf_counter()
    d2 = D2FTConfig(**NA_D2FT, head_groups=head_groups(cfg))
    n_mb, steps = d2.n_microbatches, NA_STEPS
    info = {}

    def kernel_path():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        torch.cuda.synchronize()
        info["params"] = sum(p.numel() for p in model.parameters())
        info["init_s"] = time.perf_counter() - t
        log = loop.finetune(model, cfg, d2, plain_sgd(torch, NA_LR),
                            feature_batches(np, cfg, B, seq, steps),
                            steps=steps, use_kernel=True)[2]
        info["peak"] = torch.cuda.max_memory_allocated()
        return log
    run, scheds = launcher_paths(None, own={"kernel": kernel_path})
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    d2m.moe_fwd.launches = d2m.moe_bwd.launches = 0
    hook, sums = mask_sums()
    attn_call, moe_call = [], []
    d2m.dispatch = hook
    try:
        with contract.count_tiles("cuda") as tc, \
                capture_first(torch, attn_mod, "gated_flash_attention",
                              attn_call), \
                capture_first(torch, ops, "_gated_moe_impl", moe_call):
            log_k = run("kernel")
            counts = tc.read()
    finally:
        d2m.dispatch = None
    launches = moe_launches()
    if launches != predicted_launches(cfg, steps):
        raise AssertionError(f"{arch}: launches {launches} != the "
                             f"schedule's {predicted_launches(cfg, steps)}")
    sched = scheds[0]
    mb_of = microbatch_assignment(B, n_mb)
    bounds = live_slice_bounds(sched, mb_of)
    want, full = schedule_tiles(sched, mb_of, cfg, steps, seq)
    mirror = {k: int(sum(int(v) for v in sums[k])) for k in sums}
    if any(counts[k] != want[k] for k in want) or \
            counts["moe_fwd"] != mirror["fwd"] or \
            counts["moe_bwd"] != mirror["bwd"]:
        raise AssertionError(f"{arch}: executed tiles {counts} != the "
                             f"schedule's attention {want} / the MoE "
                             f"masks' {mirror}")
    # the masked path's first-step loss: its forward on the same weights,
    # schedule and batch (its backward would keep [B, H, S, S] softmax
    # probabilities of every layer: 17 GB more at phi-3-vision-4.2b)
    torch.cuda.empty_cache()
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(feature_batches(np, cfg, B, seq, 1)).items()}
    with torch.no_grad():
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        loss_m = float(lm_loss(model, cfg, batch.get("tokens"),
                               batch["labels"],
                               features=batch.get("features"),
                               gates=(g_f.cuda(), g_b.cuda()))[0])
    if moe_launches() != launches:
        raise AssertionError(f"{arch}: the masked path launched a kernel")
    del model, batch
    torch.cuda.empty_cache()
    diff = check_losses(np, SimpleNamespace(losses=log_k.losses[:1]),
                        SimpleNamespace(losses=[loss_m]))
    if not np.isfinite(log_k.losses).all():
        raise AssertionError(f"{arch}: losses {log_k.losses}")
    p50 = 1e3 * float(np.median(log_k.step_times))
    peak = info["peak"]
    per_step = {k: v // steps for k, v in launches.items()}
    rep = cfg.n_heads // sched.n_groups
    print(f"[new archs] {what} ({info['params']} parameters, f32, seed 0; "
          f"init {info['init_s']:.1f} s) through train/loop.py::finetune "
          f"(use_kernel=True), batch {B} x {seq} positions in {n_mb} "
          f"micro-batches, n_pf {NA_D2FT['n_pf']} n_po {NA_D2FT['n_po']}, "
          f"G {sched.n_groups}, momentum-free SGD lr {NA_LR}, {steps} steps: "
          f"launches a step {per_step} (= the schedule's count), live "
          f"(sample, group) bounds {bounds} x {rep}, executed attention "
          f"tiles = the schedule's ({want} of {full}), MoE tiles "
          f"{counts['moe_fwd']} / {counts['moe_bwd']} = the launched masks'; "
          f"losses {[round(float(x), 6) for x in log_k.losses]}, first-step "
          f"masked-path loss {loss_m:.6f} (diff {diff:.3e}); p50 step ms "
          f"{p50:.3f} (steps {[round(1e3 * t, 1) for t in log_k.step_times]}"
          f"), max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB, "
          f"scoring included); {time.perf_counter() - t0:.1f} s {tag}",
          flush=True)
    heads = tuple(torch.repeat_interleave(g[0], rep, dim=1).cuda()
                  for g in (g_f, g_b))
    return {"heads": heads, "bounds": (bounds[0] * rep, bounds[1] * rep),
            "attn": attn_call[0], "moe": moe_call[0] if moe_call else None}


def serve_arch(torch, np, cfg, prompts, label, tag):
    """Phase 25e for one arch: 4 requests through 4 slots, page size 16,
    the kernel path (one warm-up engine first) and the gather path: B10
    launches = attention layers x decode steps, every request finishes,
    every page returns, the tokens equal; the requests whose prompt and
    new tokens pass the window are named (under an MoE FFN the slots share
    each expert's decode capacity, so ``generate`` on one request alone is
    no oracle for the engine's tokens, in the JAX package too; the gather
    path, which applies the same window, is); p50 decode step, a profile
    of 5 decode steps. Returns the trace's final lengths."""
    from repro_torch.models.transformer import init_model
    t0 = time.perf_counter()
    with torch.no_grad():
        model = init_model(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = family_requests(np, cfg, prompts, (NA_SERVE_NEW,) * len(prompts))
    out, eng, step_s, prefill_s, n_k, run_s = serve_trace(
        torch, np, model, cfg, reqs, True, warm=True)
    n_attn = sum(k in ("attn_global", "attn_local") for k in cfg.layer_kinds)
    if n_k != n_attn * eng.n_steps or n_k == 0:
        raise AssertionError(f"{cfg.name}: kernel launches {n_k} != "
                             f"{n_attn} x {eng.n_steps} decode steps")
    plain, *_ = serve_trace(torch, np, model, cfg, reqs, False)
    for r in reqs:
        if not np.array_equal(out[r.uid], plain[r.uid]):
            first_difference(torch, model, cfg, r, out[r.uid], plain[r.uid],
                             "kernel and gather-path tokens")
    crossing = [r for r in reqs if cfg.window and
                r.prompt_len + r.max_new_tokens > cfg.window]
    if cfg.window and not crossing:
        raise AssertionError(f"{cfg.name}: no request passes the window")
    print(f"[new archs serve] {label} (f32, seed 0; init {init_s:.1f} s), "
          f"{len(reqs)} requests / {MAX_SLOTS} slots, prompts "
          f"{list(prompts)}, {NA_SERVE_NEW} new each: paged_decode launches "
          f"{n_k} = {n_attn} x {eng.n_steps}, all finished, pool drained, "
          f"tokens == gather path"
          + (f"; requests {[r.uid for r in crossing]} pass the "
             f"{cfg.window} window in decode" if crossing else "")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    serve_line(np, cfg, eng, reqs, step_s, prefill_s, run_s, tag)
    serve_profile(torch, model, cfg, eng, reqs, "paged_decode", True, tag)
    final = [r.prompt_len + r.max_new_tokens - 1 for r in reqs]
    del model, eng, out, plain
    torch.cuda.empty_cache()
    return final


def new_archs(torch, np, tag):
    """Phase 25."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(25)

    def timing(arch, run, causal=True):
        B, H, S, hd = run["attn"][0][0].shape
        window = run["attn"][1].get("window", 0)
        attention_timing_case(
            torch, gen, "new archs attention timing",
            f"{arch}'s shape and layer-0 gates "
            f"({'causal' if causal else 'bidirectional'})", B, H, S, hd,
            window, *run["heads"], *run["bounds"], tag, causal=causal)

    # (a) stablelm-3b through the launcher on NA_LM_DEPTH of its layers;
    # served at full size
    from repro_torch.launch import train as launcher
    t0 = time.perf_counter()
    call = []
    get = launcher.get_config
    launcher.get_config = lambda arch: get(arch).replace(
        n_layers=NA_LM_DEPTH) if arch == "stablelm-3b" else get(arch)
    try:
        st = launcher_finetune(torch, np, tag, "stablelm-3b", "new archs",
                               NA_BATCH, NA_SEQ, NA_STEPS, NA_LR, NA_D2FT,
                               (0,), call)
    finally:
        launcher.get_config = get
    B, H, S, hd = attention_operands_vs_plain(torch, "stablelm-3b", call[0],
                                              gen)[2][:4]
    del call
    attention_timing_case(torch, gen, "new archs attention timing",
                          "stablelm-3b's shape and layer-0 gates (causal)",
                          B, H, S, hd, 0, *st["heads"][0], *st["bounds"],
                          tag)
    print(f"[new archs] phase 25a in {time.perf_counter() - t0:.1f} s",
          flush=True)
    serve_arch(torch, np, get_config("stablelm-3b"), NA_SERVE_PROMPTS,
               "stablelm-3b full size (32 layers, 32 heads of 80)", tag)

    # (b) phi-3-vision-4.2b, (c) hubert-xlarge: full size, feature batches
    for arch, seq, what in (
            ("phi-3-vision-4.2b", None, "phi-3-vision-4.2b full size (32 "
             "layers, d 3072, 32 heads of 96; 576 patch rows of 1024 + "
             f"{VL_TEXT} text tokens, causal)"),
            ("hubert-xlarge", AU_FRAMES, "hubert-xlarge full size (48 "
             f"layers, d 1280, 16 heads of 80, bidirectional; {AU_FRAMES} "
             "frames of 512)")):
        cfg = get_config(arch)
        seq = seq or cfg.frontend_tokens + VL_TEXT
        run = arch_finetune(torch, np, arch, cfg, NA_BATCH, seq, what, tag)
        attention_operands_vs_plain(torch, arch, run["attn"], gen)
        timing(arch, run, causal=cfg.causal)
        del run
        torch.cuda.empty_cache()

    # (d) qwen1.5-32b, mixtral-8x22b, moonshot-v1-16b-a3b at full width,
    # cut in depth; each then served at that depth
    final = None
    for arch, k in NA_DEPTH.items():
        full = get_config(arch)
        cfg = full.replace(n_layers=k)
        what = (f"{arch} at full width, {k} of {full.n_layers} layers (d "
                f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV "
                f"heads of {cfg.resolved_head_dim}"
                + (f", window {cfg.window}" if cfg.window else "")
                + (f", {cfg.moe.n_experts} experts top {cfg.moe.top_k} of "
                   f"d_ff {cfg.moe.d_ff}"
                   + (f" + {cfg.moe.n_shared_experts} shared"
                      if cfg.moe.n_shared_experts else "")
                   if cfg.moe else f", d_ff {cfg.d_ff}, q/k/v biases")
                + f", vocab {cfg.vocab_size})")
        run = arch_finetune(torch, np, arch, cfg, NA_BATCH, NA_SEQ, what,
                            tag)
        attention_operands_vs_plain(torch, arch, run["attn"], gen)
        if arch != "moonshot-v1-16b-a3b":      # olmoe-1b-7b's shape, row 2
            timing(arch, run)
        if run["moe"] is not None:
            moe_operands_vs_plain(torch, arch, run["moe"], gen)
            (xb, wu, wg, wd, fs, bs), kw = run["moe"]
            moe_times(torch, xb, wu, wg, wd, fs, bs, kw["live_slots"],
                      kw["live_bwd_slots"], f"{arch}'s layer-0 operands "
                      "and gates", "new archs moe timing", tag,
                      iters=5 if cfg.moe.d_ff > 4096 else 20, dw_up=False)
            del xb, wu, wg, wd, fs, bs
        del run
        torch.cuda.empty_cache()
        prompts = MX_SERVE_PROMPTS if cfg.window else NA_SERVE_PROMPTS
        lengths = serve_arch(torch, np, cfg, prompts, what, tag)
        if cfg.window:
            final = lengths

    # B10 at the new decode shapes: against the plain version (lengths
    # past mixtral's 4096 window) and timed at mixtral's final lengths
    decode_shapes_vs_plain(torch, gen, NEW_DECODE_SHAPES, NEW_DECODE_CASES,
                           NEW_DECODE_NPMAX)
    decode_shapes_timing(torch, gen, final, -(-max(final) // PAGE_SIZE) + 1,
                         tag, NEW_DECODE_SHAPES)
    print(f"[new archs] phase 25 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def concentrated_table(np, L, G, n_mb, mix=DP_MIX, seed=0):
    """[L*G, n_mb] schedule table of the paper's concentrated mix: a
    seeded round(mix[0] * K) of the K subnets p_f on every micro-batch,
    round(mix[1] * K) p_o on every one, the rest p_s (frozen heads stay
    frozen); the backward-dead subnets are what the masked sync skips."""
    K = L * G
    order = np.random.default_rng(seed).permutation(K)
    n_f, n_o = round(mix[0] * K), round(mix[1] * K)
    table = np.full((K, n_mb), 3, np.int8)
    table[order[:n_f]] = 1
    table[order[n_f:n_f + n_o]] = 2
    return table


def share_pinned(mesh_mod):
    """Every mesh this process makes from here on stages its collectives
    through one pinned host buffer, kept across the runs (a mesh's own
    buffer would be allocated anew, up to the largest bucket, by every
    run: 0.5-2.2 s a run a rank on the card). Returns the undo."""
    make, shared = mesh_mod.make_mesh, mesh_mod._Pinned()

    def make_shared(*a, **k):
        m = make(*a, **k)
        if m is not None:
            for ax in (m.world, m.data, m.stage, m.tensor):
                ax._host = shared
        return m
    mesh_mod.make_mesh = make_shared

    def undo():
        mesh_mod.make_mesh = make
    return undo


def dp_rank(torch, np, leg, runs, argv):
    """One rank of phases 26-27: ``repro_torch.launch.train.main`` on the
    card once a run, the kernel path only (a fallback raises), in one
    process. ``runs`` is "mode:optimizer[:flag...],...": each run adds
    ``--sync-mode mode --optimizer optimizer`` to ``argv``; the flags are
    ``streamed`` (the loop's ``ParallelConfig`` with ``streamed=True``,
    which the launcher has no flag for), ``launcher`` (the run's leg is
    "launcher", whatever ``leg`` says), ``steps=N``, ``refresh=N``
    (``--refresh-every N``) and ``depth=N`` (the model cut to N layers).
    Every mesh of the process stages through one pinned buffer
    (``share_pinned``). The schedule is
    the one the launcher plans (leg "launcher": the first such run plans
    and scores, the later ones replay its tables) or the concentrated mix
    ("mix"). After every step: the
    moments' bytes, the bytes allocated (what a ZeRO-3 rank keeps between
    steps: the bytes its live tensors requested, and
    ``memory_allocated``, which adds the allocator's rounding) and, where
    the parameters are replicated, their checksum. Prints
    one line a run, ``DPREC {json}``: the loss, step and sync times, the
    sync's bytes by collective and the plan's, the reports, the checksums,
    peak memory, B2's launches, the run's host-clock seconds by what took
    them (``dp_seconds_text``) and, for a
    streamed run after an unstreamed ZeRO-3 one, whether the canonical
    parameters are bitwise equal."""
    import dataclasses
    import os
    from repro_torch.core.schedule import Schedule
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launcher
    from repro_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def refuse(kind, reason):
        raise AssertionError(f"{kind} took a non-kernel route: {reason}")
    contract.on_fallback = refuse
    plan, make = loop.plan_from_scores, loop.make_distributed_train_step
    init, fit = launcher.init_model, launcher.finetune_distributed
    configs = launcher.get_config
    rank = int(os.environ.get("RANK", 0))
    # one process group for every run: each run's mesh finds it made
    group = mesh_mod.make_data_mesh(int(os.environ.get("WORLD_SIZE", 1)),
                                    "cpu" if "cpu" in argv else None)
    unshare = share_pinned(mesh_mod)
    make_mesh = mesh_mod.make_mesh
    first_tables, z3_params = [], None
    # where a run's seconds go besides its steps: host-clock seconds of
    # the broadcasts, the model's init, the mesh and the pinned buffers'
    # growth (inside the broadcasts' and the steps' seconds)
    spent = {}
    broadcast, pinned_get = mesh_mod.DataMesh.broadcast_, \
        mesh_mod._Pinned.get

    def timed(what, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[what] = spent.get(what, 0.0) + time.perf_counter() - t
            return out
        return call

    def pinned_growth(buf, n, dtype):
        before, t = buf.buf, time.perf_counter()
        out = pinned_get(buf, n, dtype)
        if buf.buf is not before:
            spent["pinned"] = spent.get("pinned", 0.0) + \
                time.perf_counter() - t
        return out
    mesh_mod.DataMesh.broadcast_ = timed("broadcast", broadcast)
    mesh_mod._Pinned.get = pinned_growth
    for spec in runs.split(","):
        mode, opt_name, *flags = spec.split(":")
        streamed = "streamed" in flags
        run_leg = "launcher" if "launcher" in flags else leg
        steps = [f.split("=")[1] for f in flags if f.startswith("steps=")]
        refresh = [f.split("=")[1] for f in flags
                   if f.startswith("refresh=")]
        depth = [int(f.split("=")[1]) for f in flags
                 if f.startswith("depth=")]
        name = "_".join([mode, opt_name] + [f for f in flags if "=" not in f])
        tables, sums, moments, between, between_alloc = [], [], [], [], []
        made, meshes = [], []

        def planned(cfg, d2, *a, **k):
            if run_leg == "mix":
                sched = Schedule(concentrated_table(
                    np, cfg.n_layers, d2.head_groups, d2.n_microbatches,
                    seed=len(tables)), cfg.n_layers, d2.head_groups)
            elif first_tables:
                table = np.frombuffer(first_tables[len(tables)].encode(),
                                      np.uint8) - ord("0")
                sched = Schedule(table.astype(np.int8).reshape(
                    cfg.n_layers * d2.head_groups, -1), cfg.n_layers,
                    d2.head_groups)
            else:
                sched = plan(cfg, d2, *a, **k)
            tables.append("".join(map(str, sched.table.ravel())))
            return sched

        def checked(*a, **k):
            step = make(*a, **k)

            def run(model, state, batch, gates):
                out = step(model, state, batch, gates)
                torch.cuda.synchronize()
                between.append(torch.cuda.memory_stats()[
                    "requested_bytes.all.current"])
                between_alloc.append(torch.cuda.memory_allocated())
                moments.append(sum(t.numel() * t.element_size()
                                   for v in state.values()
                                   if isinstance(v, dict)
                                   for t in v.values()))
                if mode != "zero3":
                    sums.append(int(torch.stack([
                        p.detach().view(torch.int32).sum(dtype=torch.int64)
                        for p in model.parameters()]).sum()))
                return out
            return run

        def capture_init(*a, **k):
            made.append(timed("init", init)(*a, **k))
            return made[-1]

        def capture_mesh(*a, **k):
            meshes.append(timed("mesh", make_mesh)(*a, **k))
            return meshes[-1]

        def streamed_fit(*a, parallel, **k):
            return fit(*a, parallel=dataclasses.replace(
                parallel, streamed=streamed), **k)

        loop.plan_from_scores, loop.make_distributed_train_step = planned, \
            checked
        mesh_mod.make_mesh, launcher.init_model = capture_mesh, \
            capture_init
        launcher.finetune_distributed = streamed_fit
        launcher.get_config = configs if not depth else (
            lambda arch, n=depth[0]: configs(arch).replace(n_layers=n))
        d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        spent.clear()
        t_run = time.perf_counter()
        log = launcher.main(argv + ["--sync-mode", mode, "--optimizer",
                                    opt_name]
                            + (["--steps", steps[0]] if steps else [])
                            + (["--refresh-every", refresh[0]]
                               if refresh else []))
        t_run = time.perf_counter() - t_run
        t_checks = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        launches = {"fwd": d2a.flash_fwd.launches,
                    "bwd": d2a.flash_bwd.launches}
        if not first_tables and run_leg == "launcher":
            first_tables.extend(tables)
        model = made[-1]
        with torch.no_grad():
            weighted = 0
            for p in model.parameters():
                v = p.detach().reshape(-1).view(torch.int32).long()
                w = torch.arange(v.numel(), device=v.device) % 65521 + 1
                weighted += int((v * w).sum())
                del v, w
        same_as_zero3 = None
        if mode == "zero3" and not streamed:
            z3_params = {n: p.detach().cpu()
                         for n, p in model.named_parameters()}
        elif mode == "zero3" and z3_params is not None:
            same_as_zero3 = all(torch.equal(p.detach().cpu(), z3_params[n])
                                for n, p in model.named_parameters())
        del model, made[:]
        refreshes = log.extras["refreshes"]
        seconds = {"run": t_run, "steps": sum(log.step_times),
                   "reshard": meshes[-1].counter.kind_seconds.get(
                       "reshard", 0.0),
                   **{k: v for k, v in spent.items() if k != "init"},
                   "init": spent.get("init", 0.0),
                   "checks": time.perf_counter() - t_checks}
        line = {
            "rank": rank, "run": name, "mode": mode, "opt": opt_name,
            "streamed": streamed, "n_layers": depth[0] if depth else None,
            "losses": log.losses, "step_ms": [1e3 * t for t in log.step_times],
            "sync_bytes": log.extras["sync_bytes"],
            "by_kind": log.extras["sync_bytes_by_kind"],
            "ms_by_kind": log.extras["sync_ms_by_kind"],
            "sync_ms": log.extras["sync_ms"],
            "refresh_steps": [r["step"] for r in refreshes],
            "ar_bytes": [r["sync"]["ar_bytes"] for r in refreshes],
            "rs_bytes": [r["sync"]["rs_bytes"] for r in refreshes],
            "ag_bytes": [r["sync"]["ag_bytes"] for r in refreshes],
            "total_bytes": refreshes[0]["sync"]["total_bytes"],
            "fraction": [r["sync"]["fraction"] for r in refreshes],
            "n_skipped": [r["sync"]["n_skipped"] for r in refreshes],
            "n_sliced": [r["sync"]["n_sliced"] for r in refreshes],
            "n_zero": [r["sync"]["n_zero"] for r in refreshes],
            "zero_state": [r.get("zero_state") for r in refreshes],
            "zero3": [r.get("zero3_params") for r in refreshes],
            "residency": [r.get("residency") for r in refreshes],
            "device_of": [r["device_of"] for r in refreshes],
            "sums": sums, "weighted": weighted, "moments": moments,
            "between": between, "between_alloc": between_alloc,
            "peak": peak, "launches": launches,
            "reshard": meshes[-1].counter.bytes.get("reshard", 0),
            "same_as_zero3": same_as_zero3, "seconds": seconds,
            "tables": tables}
        os.write(1, ("DPREC " + json.dumps(line) + "\n").encode())
        del log
    loop.plan_from_scores, loop.make_distributed_train_step = plan, make
    mesh_mod.make_mesh, launcher.init_model = make_mesh, init
    launcher.finetune_distributed, launcher.get_config = fit, configs
    mesh_mod.DataMesh.broadcast_, mesh_mod._Pinned.get = broadcast, \
        pinned_get
    unshare()
    group.close()
    return 0


def dp_run(cmd, n_ranks, timeout=DP_TIMEOUT, tag="DPREC "):
    """Run a phase-26/27 (or 28) command. Returns ({run: {rank: record}},
    seconds) from the lines that start with ``tag``. torch.distributed.
    elastic starts each rank in a session of its own, so the run's
    processes are found by their mark (``RUN_ENV``): all of them are
    stopped at the time limit, and any still running when the run ends
    are stopped and named."""
    t0 = time.perf_counter()
    mark = f"{os.environ.get(RUN_ENV, os.getpid())}/{time.time_ns()}"
    what = " ".join(cmd[-4:])[:120]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, RUN_ENV: mark})
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_marked(mark, f"past the {timeout} s limit of {what}")
        out, _ = proc.communicate()
        raise AssertionError(f"{cmd} passed its {timeout} s limit:\n"
                             f"{out[-4000:]}") from None
    finally:
        stop_marked(mark, f"left running by {what}")
    seconds = time.perf_counter() - t0
    recs = {}
    for ln in out.splitlines():
        if ln.startswith(tag):
            rec = json.loads(ln[len(tag):])
            recs.setdefault(rec["run"], {})[rec["rank"]] = rec
    if proc.returncode != 0 or not recs or any(
            sorted(r) != list(range(n_ranks)) for r in recs.values()):
        raise AssertionError(f"{cmd} exited {proc.returncode} with records "
                             f"{ {k: sorted(v) for k, v in recs.items()} }:"
                             f"\n{out[-6000:]}")
    return recs, seconds


def dp_argv(mesh, leg, runs):
    """The rank's leg and runs, and the launcher's flags of phases
    26-27."""
    d2 = GM_D2FT
    return ["--dp-rank", leg, runs, "--arch", "gemma3-1b", "--full",
            "--batch", str(GM_BATCH), "--seq", str(GM_SEQ), "--steps",
            str(DP_STEPS), "--lr", str(GM_LR), "--n-microbatches",
            str(d2["n_microbatches"]), "--n-pf", str(d2["n_pf"]), "--n-po",
            str(d2["n_po"]), "--d2ft", "--kernel", "--distributed",
            "--mesh", f"data={mesh}", "--refresh-every", str(DP_REFRESH)]


def dp_plan_bytes(rec, key):
    """The active plan's ``key`` bytes at each step of the run."""
    return [rec[key][max(k for k, s in enumerate(rec["refresh_steps"])
                         if s <= i)] for i in range(len(rec["losses"]))]


def dp_check_bytes(rec, what):
    """Each step's sync bytes, by collective, equal the active plan's
    ar_bytes, rs_bytes and ag_bytes."""
    kinds = (("all_reduce", "ar_bytes"), ("reduce_scatter", "rs_bytes"),
             ("all_gather", "ag_bytes"))
    want = [{kind: int(b) for kind, key in kinds
             for b in [dp_plan_bytes(rec, key)[i]] if b}
            for i in range(len(rec["losses"]))]
    if rec["by_kind"] != want or \
            rec["sync_bytes"] != [sum(w.values()) for w in want]:
        raise AssertionError(f"{what} rank {rec['rank']}: sync bytes "
                             f"{rec['by_kind']} != the plan's {want}")
    return [sum(w.values()) for w in want]


def dp_reference(torch, np, cfg, tables):
    """``loop.finetune(use_kernel=True)`` on phase 26's batches, its
    schedules replayed from the run's tables (one a refresh), the AdamW
    state carried across the refreshes. Returns the losses."""
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.schedule import Schedule
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train import loop

    G = cfg.n_heads
    d2 = D2FTConfig(head_groups=G, **GM_D2FT)
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    batches = list(lm_batches(0, cfg.vocab_size, GM_BATCH, GM_SEQ,
                              DP_STEPS))
    opt, state, losses = adamw(GM_LR), None, []
    plan = loop.plan_from_scores
    try:
        for k, text in enumerate(tables):
            table = np.frombuffer(text.encode(), np.uint8) - ord("0")
            sched = Schedule(table.astype(np.int8).reshape(
                cfg.n_layers * G, -1), cfg.n_layers, G)
            loop.plan_from_scores = lambda *a, sched=sched, **kw: sched
            carried = opt if state is None else \
                opt._replace(init=lambda p, state=state: state)
            seg = batches[k * DP_REFRESH:(k + 1) * DP_REFRESH]
            _, state, log = loop.finetune(model, cfg, d2, carried, seg,
                                          steps=len(seg), use_kernel=True)
            losses += log.losses
    finally:
        loop.plan_from_scores = plan
    del model, state
    torch.cuda.empty_cache()
    return losses


def data_parallel(torch, np, tag, phases=(26, 27)):
    """Phases 26 and 27 (``phases``: either or both). One process runs a
    one-rank NCCL mesh through the masked sync (phase 26 (a)), then ZeRO-1
    and ZeRO-3 on the same schedules (27 (a)). One torch.distributed.run
    of two gloo ranks runs the masked sync with AdamW on the launcher's
    schedule (its first plan, ``DP_LAUNCHER_STEPS``) and on the
    concentrated mix (26 (b)), then on the mix the masked sync with SGD,
    ZeRO-1 with AdamW and with SGD, ZeRO-3 and streamed ZeRO-3 (27 (b)).
    Phase 27 alone still runs the masked runs on the mix and in (a), as
    the baselines its losses are held to. Returns {"launches": (a)'s
    masked run's B2 launches, "a": that run's record}, which phase 28
    replays and is held to."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-1b")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    n_layers = cfg.n_layers
    want_launches = {"fwd": n_layers * DP_STEPS, "bwd": n_layers * DP_STEPS}
    zero = 27 in phases

    # (a) one rank over NCCL
    runs_a = "masked:adamw" + (",zero:adamw,zero3:adamw" if zero else "")
    recs, secs = dp_run([sys.executable, str(ROOT / "chip_smoke.py")]
                        + dp_argv(1, "launcher", runs_a), 1)
    a = recs["masked_adamw"][0]
    for name, rec in recs.items():
        dp_check_bytes(rec[0], f"(a) {name}")
        if rec[0]["launches"] != want_launches:
            raise AssertionError(f"(a) {name} B2 launches "
                                 f"{rec[0]['launches']} != {want_launches}")
    if 26 in phases:
        ref = dp_reference(torch, np, cfg, a["tables"])
        diff = check_losses(np, SimpleNamespace(losses=a["losses"]),
                            SimpleNamespace(losses=ref))
        print(f"[data parallel] (a) gemma3-1b full size through "
              f"repro_torch.launch.train --distributed --mesh data=1 "
              f"--kernel (one rank, NCCL), batch {GM_BATCH} x seq {GM_SEQ}, "
              f"n_pf {GM_D2FT['n_pf']} n_po {GM_D2FT['n_po']} of "
              f"{GM_D2FT['n_microbatches']}, G {cfg.n_heads}, AdamW lr "
              f"{GM_LR}, {DP_STEPS} steps, re-planned at steps "
              f"{a['refresh_steps']}: losses "
              f"{[round(x, 6) for x in a['losses']]} vs "
              f"finetune(use_kernel=True) on the same batches and schedules "
              f"{[round(x, 6) for x in ref]}, max diff {diff:.3e}; B2 "
              f"launches {a['launches']} (= {n_layers} x {DP_STEPS}); sync "
              f"bytes a step {a['sync_bytes']} = ar_bytes (fraction "
              f"{a['fraction']} of {a['total_bytes']:.0f}); p50 step ms "
              f"{float(np.median(a['step_ms'])):.3f}, sync ms "
              f"{[round(x, 3) for x in a['sync_ms']]}; peak "
              f"{a['peak'] / 2**30:.2f} GiB; {secs:.1f} s in its process "
              f"{tag}", flush=True)
    if zero:
        for name in ("zero_adamw", "zero3_adamw"):
            r = recs[name][0]
            zero_run_checks(np, r, a, f"(a) {name}")
            print(f"[zero] (a) {name}: --sync-mode {r['mode']} on one NCCL "
                  f"rank, the same batches and schedules as the masked run "
                  f"(replayed): losses {[round(x, 6) for x in r['losses']]}, "
                  f"max diff against the masked run's "
                  f"{dp_max_diff(np, r, a):.3e} (limit 1e-6); B2 launches "
                  f"{r['launches']}; "
                  + zero_run_line(np, r, dp_other_bytes(np, a)) + f" {tag}",
                  flush=True)
        print(f"[zero] (a) one process, {secs:.1f} s for its three runs "
              f"{tag}", flush=True)

    # (b) two ranks sharing the card over gloo, one torch.distributed.run;
    # every run on the mix crosses the re-plan at step 1 (zero_relayout;
    # under ZeRO-1 SGD the gather elided where ever_live allows)
    runs = ([f"masked:adamw:launcher:steps={DP_LAUNCHER_STEPS}"]
            if 26 in phases else []) + [
        f"{run}:steps={DP_MIX_STEPS}:refresh={DP_MIX_REFRESH}"
        for run in ["masked:adamw"] + (
            ["zero:adamw", "zero3:adamw", "zero3:adamw:streamed",
             f"masked:sgd:depth={DP_SGD_DEPTH}",
             f"zero:sgd:depth={DP_SGD_DEPTH}"] if zero else [])]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", str(ROOT / "chip_smoke.py")] + \
        dp_argv(2, "mix", ",".join(runs))
    recs, secs = dp_run(cmd, 2)
    for name, by_rank in recs.items():
        for r in by_rank.values():
            dp_check_bytes(r, f"(b) {name}")
            n = len(r["losses"]) * (r["n_layers"] or n_layers)
            if r["launches"] != {"fwd": n, "bwd": n}:
                raise AssertionError(f"(b) {name} rank {r['rank']}: B2 "
                                     f"launches {r['launches']}")
            if not np.isfinite(r["losses"]).all():
                raise AssertionError(f"(b) {name}: losses {r['losses']}")
        r0, r1 = by_rank[0], by_rank[1]
        if r0["sums"] != r1["sums"] or r0["weighted"] != r1["weighted"]:
            raise AssertionError(f"(b) {name}: parameter checksums differ "
                                 f"across ranks: {r0['sums']} "
                                 f"{r0['weighted']} vs {r1['sums']} "
                                 f"{r1['weighted']}")
        if r0["losses"] != r1["losses"]:
            raise AssertionError(f"(b) {name}: the ranks' mean losses "
                                 f"differ: {r0['losses']} {r1['losses']}")
    for name, by_rank in recs.items():
        print(f"[data parallel] (b) {name}: seconds besides the steps, a "
              f"rank: " + "; ".join(
                  f"rank {k} " + dp_seconds_text(r["seconds"])
                  for k, r in sorted(by_rank.items())), flush=True)
    if 26 in phases:
        dp26_b_lines(np, "launcher", recs["masked_adamw_launcher"], a, tag)
        dp26_b_lines(np, "mix", recs["masked_adamw"], a, tag)
    if zero:
        zero_mix_checks(np, recs, tag)
    print(f"[data parallel] (b) one torch.distributed.run of two ranks, "
          f"{secs:.1f} s for its {len(runs)} runs {tag}", flush=True)
    print(f"[data parallel] phases {'-'.join(map(str, phases))} took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": a["launches"], "a": a}


def dp_seconds_text(sec):
    """A run's host-clock seconds: the launcher's call, its steps, and
    besides them the broadcasts, the model's init, the mesh, the
    re-layouts and the rest; then the checks after the run."""
    parts = ("broadcast", "init", "mesh", "reshard")
    rest = sec["run"] - sec["steps"] - sum(sec.get(k, 0.0) for k in parts)
    return (f"{sec['run']:.2f} s in launcher.main, steps "
            f"{sec['steps']:.2f}, " + ", ".join(
                f"{k} {sec.get(k, 0.0):.2f}" for k in parts)
            + f", other {rest:.2f} (pinned buffers' growth, in the "
            f"broadcasts and steps: {sec.get('pinned', 0.0):.2f}); checks "
            f"after {sec['checks']:.2f}")


def dp26_b_lines(np, leg, recs, a, tag):
    """Phase 26 (b)'s two lines of a leg's masked AdamW run."""
    r0, r1 = recs[0], recs[1]
    n = len(r0["losses"])
    if leg == "mix" and not max(r0["fraction"]) < 1.0:
        raise AssertionError(f"(b) mix: sync fraction {r0['fraction']}")
    same = r0["tables"] == a["tables"][:len(r0["tables"])]
    vs_a = float(np.max(np.abs(np.asarray(r0["losses"]) -
                               np.asarray(a["losses"][:n]))))
    p50 = [float(np.median(r["step_ms"])) for r in (r0, r1)]
    sync = [float(np.median(r["sync_ms"])) for r in (r0, r1)]
    print(f"[data parallel] (b) {leg} schedule"
          + (" (the launcher's knapsack)" if leg == "launcher" else
             f" (the paper's concentrated mix {DP_MIX})")
          + f": two ranks on one card over gloo (torch.distributed.run "
          f"--nproc_per_node 2, --mesh data=2), 2 x {GM_SEQ} a rank, "
          f"AdamW, {n} steps; sync fraction {r0['fraction']} "
          f"({r0['n_skipped']} leaves skipped, {r0['n_sliced']} "
          f"group-sliced); bytes a step: counter {r0['sync_bytes']} = "
          f"ar_bytes on both ranks, of {r0['total_bytes']:.0f}; "
          f"losses {[round(x, 6) for x in r0['losses']]}"
          + (f" (vs (a): max diff {vs_a:.3e}, same schedules)" if same
             else " (schedules differ from (a)'s)")
          + f"; parameter checksums bitwise equal on both ranks after "
          f"every step {r0['sums']}; B2 launches per rank "
          f"{r0['launches']}; device_of {r0['device_of']} {tag}",
          flush=True)
    print(f"[data parallel] (b) {leg}: sync host-clock ms a step (gloo "
          f"staging the bucket through pinned host memory on one card, "
          f"not an interconnect number) rank 0 "
          f"{[round(x, 3) for x in r0['sync_ms']]}, rank 1 "
          f"{[round(x, 3) for x in r1['sync_ms']]}: p50 {sync[0]:.3f} / "
          f"{sync[1]:.3f} against the step's p50 {p50[0]:.3f} / "
          f"{p50[1]:.3f} ms ({sync[0] / p50[0]:.1%} of rank 0's step); "
          f"peak memory rank 0 {r0['peak']} bytes "
          f"({r0['peak'] / 2**30:.2f} GiB), rank 1 {r1['peak']} bytes "
          f"({r1['peak'] / 2**30:.2f} GiB) {tag}", flush=True)


def dp_max_diff(np, r, base):
    return float(np.max(np.abs(np.asarray(r["losses"]) -
                               np.asarray(base["losses"]))))


def zero_run_checks(np, r, base, what):
    """A ZeRO run against the masked run on the same schedules: losses
    within 1e-6, the moments' bytes after every step equal to the plan's
    ``zero_state_byte_report``, and under ZeRO-3 the bytes the live
    tensors requested between steps (``memory_allocated`` less the
    allocator's rounding of each block, which depends on the order the
    blocks were split in), less what the masked run's hold besides its
    parameters and moments (the process's workspaces:
    ``dp_other_bytes``), within 1 % of the shards, the fallback leaves
    and the sharded moments."""
    if r["tables"] != base["tables"]:
        raise AssertionError(f"{what}: schedules differ from the masked "
                             "run's")
    diff = dp_max_diff(np, r, base)
    if not diff <= 1e-6:
        raise AssertionError(f"{what}: losses {r['losses']} vs masked "
                             f"{base['losses']}: max diff {diff}")
    want = dp_plan_bytes({**r, "x": [z["per_device_bytes"]
                                     for z in r["zero_state"]]}, "x")
    if r["moments"] != [int(w) for w in want]:
        raise AssertionError(f"{what}: moment bytes {r['moments']} != "
                             f"zero_state_byte_report's {want}")
    if r["mode"] == "zero3":
        other = dp_other_bytes(np, base)
        for i, got in enumerate(r["between"]):
            k = max(j for j, s in enumerate(r["refresh_steps"]) if s <= i)
            z3 = r["zero3"][k]
            model = z3["shard_bytes"] + z3["fallback_bytes"] + want[i]
            if abs(got - other - model) > 0.01 * model:
                raise AssertionError(f"{what}: {got} bytes requested "
                                     f"between steps, {other} of them "
                                     f"besides the state, the model "
                                     f"{model}")


def dp_other_bytes(np, masked):
    """What a masked run's live tensors request between steps besides its
    parameters and moments (cuBLAS workspaces and the like), the median
    over its steps."""
    return int(np.median([b - masked["total_bytes"] - m for b, m in
                          zip(masked["between"], masked["moments"])]))


def zero_run_line(np, r, other):
    """A ZeRO run's numbers, on one line; ``other``: the masked run's
    bytes besides its state (``dp_other_bytes``)."""
    kinds = sorted({k for d in r["ms_by_kind"] for k in d})
    ms = {k: round(float(np.median([d.get(k, 0.0) for d in r["ms_by_kind"]])),
                   3) for k in kinds}
    z = r["zero_state"][-1]
    text = (f"bytes a step by collective {r['by_kind']} = the plan's "
            f"(ar / rs / ag {r['ar_bytes']} / {r['rs_bytes']} / "
            f"{r['ag_bytes']}); p50 step ms "
            f"{float(np.median(r['step_ms'])):.3f}, the sync's host-clock "
            f"ms a step {[round(x, 3) for x in r['sync_ms']]} (p50 by "
            f"collective, the calls alone: {ms}); optimizer state "
            f"{r['moments'][-1]} bytes = zero_state_byte_report's "
            f"per_device_bytes (fraction {z['fraction']:.4f} of "
            f"{z['replicated_bytes']:.0f}); requested between steps "
            f"{r['between']} (memory_allocated {r['between_alloc']})")
    if r["mode"] == "zero3":
        z3 = r["zero3"][-1]
        text += (f" = shards {z3['shard_bytes']:.0f} + fallback "
                 f"{z3['fallback_bytes']:.0f} + moments {r['moments'][-1]} "
                 f"+ the masked run's {other} bytes besides its state, "
                 f"within 1 %; {z3['n_gather_elided']} forward-dead "
                 f"gathers elided, residency fraction {z3['fraction']:.4f}, "
                 f"peak unit {z3['peak_unit']}")
    if r["residency"][0] is not None:
        text += (f"; check_zero3_residency peak agreement "
                 f"{[x['peak_agreement'] for x in r['residency']]}")
    return text + (f"; re-layout bytes {r['reshard']}; peak "
                   f"{r['peak']} bytes ({r['peak'] / 2**30:.2f} GiB)")


def zero_mix_checks(np, recs, tag):
    """Phase 27 (b): every ZeRO run of the mix process against the masked
    run with its optimizer, on both ranks; the gather elision where the
    optimizer allows it; streamed ZeRO-3 bitwise equal to ZeRO-3."""
    for name in ("zero_adamw", "zero_sgd", "zero3_adamw",
                 "zero3_adamw_streamed"):
        by_rank = recs[name]
        base = recs["masked_sgd" if name == "zero_sgd" else "masked_adamw"]
        for rank in (0, 1):
            zero_run_checks(np, by_rank[rank], base[rank],
                            f"(b) {name} rank {rank}")
        r0 = by_rank[0]
        if r0["mode"] == "zero3" and not min(
                z["n_gather_elided"] for z in r0["zero3"]) > 0:
            raise AssertionError(f"(b) {name}: no gather elided")
        elided = any(g < t for g, t in zip(r0["ag_bytes"],
                                           [r0["total_bytes"]] * 2))
        if name == "zero_sgd" and not elided:
            raise AssertionError(f"(b) zero_sgd: ag_bytes {r0['ag_bytes']}")
        if name == "zero_adamw" and elided:
            raise AssertionError(f"(b) zero_adamw (weight decay 0.01, not "
                                 f"elidable): ag_bytes {r0['ag_bytes']}")
        if name == "zero3_adamw_streamed":
            z3 = recs["zero3_adamw"]
            for rank in (0, 1):
                if by_rank[rank]["losses"] != z3[rank]["losses"] or \
                        not by_rank[rank]["same_as_zero3"]:
                    raise AssertionError(f"(b) streamed ZeRO-3 rank {rank} "
                                         "differs from ZeRO-3")
            if any(x is None for x in r0["residency"]):
                raise AssertionError("(b) streamed: no residency check")
        for rank in (0, 1):
            r = by_rank[rank]
            print(f"[zero] (b) {name} rank {rank}: two gloo ranks on one "
                  f"card, the concentrated mix"
                  + (f" on {r['n_layers']} of 26 layers" if r["n_layers"]
                     else "") + f", 2 x {GM_SEQ} a rank: "
                  f"losses {[round(x, 6) for x in r['losses']]}, max diff "
                  f"against the masked {r['opt']} run's "
                  f"{dp_max_diff(np, r, base[rank]):.3e} (limit 1e-6); "
                  f"canonical parameters bitwise equal on both ranks "
                  f"(weighted checksum {r['weighted']})"
                  + (", and to ZeRO-3's" if r["same_as_zero3"] else "")
                  + "; " + zero_run_line(np, r, dp_other_bytes(
                      np, base[rank])) + f" {tag}", flush=True)
    for name in ("masked_adamw", "masked_sgd"):
        m = recs[name][0]
        print(f"[zero] (b) {name} (the baseline) rank 0: losses "
              f"{[round(x, 6) for x in m['losses']]}, bytes a step "
              f"{m['sync_bytes']}, p50 step ms "
              f"{float(np.median(m['step_ms'])):.3f}, sync ms p50 "
              f"{float(np.median(m['sync_ms'])):.3f}, requested between "
              f"steps {m['between']} (parameters {m['total_bytes']:.0f}, "
              f"moments {m['moments'][-1]}), peak {m['peak']} bytes "
              f"{tag}", flush=True)


def decode_table(np, text, cfg, G):
    """A schedule table from its digit string (a run record's)."""
    table = np.frombuffer(text.encode(), np.uint8) - ord("0")
    return table.astype(np.int8).reshape(cfg.n_layers * G, -1)


def mx_argv(leg):
    """The launcher's flags of phase 28's run ``leg``: "a" and "am"
    (``MX_MIX_STEPS`` steps, one plan) on gemma3-1b, "b" on stablelm-3b."""
    if leg in ("a", "am"):
        d2 = GM_D2FT
        steps = MX_STEPS if leg == "a" else MX_MIX_STEPS
        return ["--arch", "gemma3-1b", "--full", "--batch", str(GM_BATCH),
                "--seq", str(GM_SEQ), "--steps", str(steps), "--lr",
                str(GM_LR), "--n-microbatches", str(d2["n_microbatches"]),
                "--n-pf", str(d2["n_pf"]), "--n-po", str(d2["n_po"]),
                "--d2ft", "--distributed", "--mesh", "stage=2",
                "--refresh-every", str(DP_REFRESH)]
    d2 = NA_D2FT
    return ["--arch", "stablelm-3b", "--full", "--batch", str(NA_BATCH),
            "--seq", str(NA_SEQ), "--steps", str(NA_STEPS), "--lr",
            str(NA_LR), "--n-microbatches", str(d2["n_microbatches"]),
            "--n-pf", str(d2["n_pf"]), "--n-po", str(d2["n_po"]), "--d2ft",
            "--distributed", "--mesh", "tensor=2", "--optimizer", "sgd"]


def mx_rank(torch, np, replay, legs="a,am,b", ckdir=""):
    """One rank of phases 28 and 29: ``repro_torch.launch.train.main`` on
    the card for each of ``legs`` ("a,am,b" and phase 29's ``EL_LEGS``,
    whose checkpoints go under ``ckdir``: ``el_leg``), on one process
    group. Phase 28: (a), (a) on the mix ("am") and (b).
    ``replay``: (a)'s schedule tables ("+"-joined digit strings), which
    rank 0's planner returns in turn; "am"'s planner returns phase 27's
    concentrated mix (``concentrated_table``, seed 0), whose live cost
    varies by layer; (b) plans its own. (b)'s config is cut to
    ``MX_DEPTH`` layers and its ``--optimizer sgd`` is the momentum-free
    ``plain_sgd``. After every step: a checksum of the parameters; after
    (b), each leaf's update norm (``update_norms``). Prints one line a
    run, ``MXREC {json}``: the losses, step ms, bytes and host-clock ms by
    collective, the refresh records' reports, the checksums, the
    gradient tree's and the tensor-sharded leaves' bytes, peak memory and
    the tables rank 0 planned."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import Schedule
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launcher
    from repro_torch.sharding import sync
    from repro_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ.get("RANK", 0))
    group = mesh_mod.make_data_mesh(int(os.environ.get("WORLD_SIZE", 1)))
    unshare = share_pinned(mesh_mod)
    plan, make = loop.plan_from_scores, loop.make_distributed_train_step
    init, configs, sgd = launcher.init_model, launcher.get_config, \
        launcher.sgd
    replay = replay.split("+")
    keep = {}
    for leg in legs.split(","):
        if leg in EL_LEGS.split(",") + ["dm", "em"]:
            line = el_leg(torch, leg, rank, ckdir, keep) \
                if leg in EL_LEGS.split(",") else \
                measure_leg(torch, leg, rank)
            os.write(1, ("MXREC " + json.dumps(line) + "\n").encode())
            continue
        tables, sums, made = [], [], []

        def planned(cfg, d2, *a, **k):
            if leg == "a":
                sched = Schedule(decode_table(np, replay[len(tables)], cfg,
                                              d2.head_groups),
                                 cfg.n_layers, d2.head_groups)
            elif leg == "am":
                sched = Schedule(concentrated_table(
                    np, cfg.n_layers, d2.head_groups, d2.n_microbatches),
                    cfg.n_layers, d2.head_groups)
            else:
                sched = plan(cfg, d2, *a, **k)
            tables.append("".join(map(str, sched.table.ravel())))
            return sched

        def checked(*a, **k):
            step = make(*a, **k)

            def run(model, state, batch, gates):
                out = step(model, state, batch, gates)
                torch.cuda.synchronize()
                sums.append(int(torch.stack([
                    p.detach().view(torch.int32).sum(dtype=torch.int64)
                    for p in model.parameters()]).sum()))
                return out
            return run

        def capture_init(*a, **k):
            made.append(init(*a, **k))
            return made[-1]

        def cut(arch):
            cfg = configs(arch)
            return cfg.replace(n_layers=MX_DEPTH) if leg == "b" else cfg

        loop.plan_from_scores, loop.make_distributed_train_step = planned, \
            checked
        launcher.init_model, launcher.get_config = capture_init, cut
        launcher.sgd = lambda lr: plain_sgd(torch, lr)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            log = launcher.main(mx_argv(leg))
        finally:
            loop.plan_from_scores, loop.make_distributed_train_step = \
                plan, make
            launcher.init_model, launcher.get_config, launcher.sgd = \
                init, configs, sgd
        peak = torch.cuda.max_memory_allocated()
        model = made[-1]
        named = dict(model.named_parameters())
        updates = None
        if leg == "b":
            # the launcher's initial weights, made again from its seed
            start = init(torch.Generator(
                device=next(model.parameters()).device).manual_seed(0),
                cut("stablelm-3b"))
            updates = update_norms(torch, named,
                                   dict(start.named_parameters()))
            del start
        with torch.no_grad():
            weighted = 0
            for p in named.values():
                v = p.detach().reshape(-1).view(torch.int32).long()
                w = torch.arange(v.numel(), device=v.device) % 65521 + 1
                weighted += int((v * w).sum())
                del v, w
        refreshes = log.extras["refreshes"]
        line = {
            "rank": rank, "run": leg, "losses": log.losses,
            "step_ms": [1e3 * t for t in log.step_times],
            "by_kind": log.extras["sync_bytes_by_kind"],
            "ms_by_kind": log.extras["sync_ms_by_kind"],
            "refresh_steps": [r["step"] for r in refreshes],
            "ar_bytes": [r["sync"]["ar_bytes"] for r in refreshes],
            "stages": [r.get("stages") for r in refreshes],
            "tree_bytes": sum(p.numel() * p.element_size()
                              for p in named.values()),
            "tp_bytes": sum(p.numel() * p.element_size()
                            for n, p in named.items()
                            if sync.tensor_sharded(n)),
            "sums": sums, "weighted": weighted, "peak": peak,
            "updates": updates, "tables": tables}
        os.write(1, ("MXREC " + json.dumps(line) + "\n").encode())
        del model, made[:], named, log
    unshare()
    group.close()
    return 0


def mx_run(torch, np, replay, legs="a,am,b", ckdir="", n_ranks=2):
    """Phase 28's, 29's and 30's ranks: one torch.distributed.run of
    ``n_ranks`` running ``legs``, killed with its session at its time
    limit. Returns ({run: {rank: record}}, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n_ranks), str(ROOT / "chip_smoke.py"),
           "--mx-rank", "+".join(replay), legs, ckdir]
    names = legs.split(",")
    limit = (MX_TIMEOUT if "a" in names else 0) + \
        (EL_TIMEOUT if "ea" in names else 0) + \
        (DM_TIMEOUT if "dm" in names else 0) + \
        (EM_TIMEOUT if "em" in names else 0)
    return dp_run(cmd, n_ranks, timeout=limit, tag="MXREC ")


def measure_leg(torch, leg, rank):
    """One rank of phase 30: "dm" runs ``diststep.measure_distributed_step``
    on the two ranks (the kernel path only: a fallback raises), counting
    B2's launches in every step of every variant (the steps the function
    builds, in its order: eight variants, then the pipeline); "em" runs
    ``diststep.measure_elastic`` on the four. Returns the rank's line: the
    record, the launches, the seconds and the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.launch import diststep
    from repro_torch.train import loop

    def refuse(kind, reason):
        raise AssertionError(f"{kind} took a non-kernel route: {reason}")
    contract.on_fallback = refuse
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if leg == "em":
        rec = diststep.measure_elastic(EM_RANKS)
        return {"rank": rank, "run": leg, "record": rec,
                "seconds": time.perf_counter() - t0,
                "peak": torch.cuda.max_memory_allocated()}
    make = loop.make_distributed_train_step
    launches = []

    def counting(*a, **k):
        step = make(*a, **k)
        steps = []
        launches.append(steps)

        def run(*args):
            f0, b0 = d2a.flash_fwd.launches, d2a.flash_bwd.launches
            out = step(*args)
            torch.cuda.synchronize()
            steps.append([d2a.flash_fwd.launches - f0,
                          d2a.flash_bwd.launches - b0])
            return out
        return run

    loop.make_distributed_train_step = counting
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    try:
        rec = diststep.measure_distributed_step(
            2, cfg=get_config("gemma3-1b").replace(n_layers=DM_DEPTH),
            batch=DM_BATCH, seq=DM_SEQ, n_mb=DM_MB, use_kernel=True,
            time_steps=DM_TIME_STEPS)
    finally:
        loop.make_distributed_train_step = make
    return {"rank": rank, "run": leg, "record": rec, "launches": launches,
            "seconds": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated()}


def diststep_checks(np, tag, by_rank):
    """Phase 30 (a)'s checks on both ranks' ``dm`` lines; prints the
    ``DISTSTEP`` line and a line a variant."""
    from repro_torch.launch.diststep import SYNC_KINDS, VARIANTS
    keys = dict(zip(SYNC_KINDS, ("ar_bytes", "rs_bytes", "ag_bytes")))
    ops = dict(zip(SYNC_KINDS, ("all-reduce", "reduce-scatter",
                                "all-gather")))
    rec0 = by_rank[0]["record"]
    print("DISTSTEP " + json.dumps(rec0), flush=True)
    for rank, line in sorted(by_rank.items()):
        rec = line["record"]
        if list(rec["variants"]) != list(VARIANTS):
            raise AssertionError(f"(a) rank {rank}: variants "
                                 f"{list(rec['variants'])}")
        if len(line["launches"]) != len(VARIANTS) + 1:
            raise AssertionError(f"(a) rank {rank}: {len(line['launches'])}"
                                 f" steps built, not {len(VARIANTS) + 1}")
        for i, (name, v) in enumerate(rec["variants"].items()):
            what = f"(a) rank {rank} {name}"
            plan = v["sync_plan"]
            for kind, key in keys.items():
                got = v["recorded"].get(kind, {}).get("bytes", 0)
                if got != int(plan[key]):
                    raise AssertionError(f"{what}: {kind} bytes {got} != "
                                         f"the plan's {key} {plan[key]}")
                wire = v["sync_collectives"].get(ops[kind], 0.0)
                if not math.isclose(wire, plan["wire"][kind], rel_tol=1e-9,
                                    abs_tol=1e-6):
                    raise AssertionError(f"{what}: {kind} wire {wire} != "
                                         f"the plan's {plan['wire'][kind]}")
            other = set(v["recorded"]) - set(SYNC_KINDS)
            if not other <= {"metrics", "guard"}:
                raise AssertionError(f"{what}: other kinds {other}")
            n_ag = v["collectives_n"].get("all-gather", 0)
            if (v["sync_mode"] == "zero3" and not n_ag) or \
                    (v["sync_mode"] == "masked" and n_ag):
                raise AssertionError(f"{what}: {n_ag} all-gathers")
            if v["streamed"] and "residency_check" not in v:
                raise AssertionError(f"{what}: no residency check")
            fwd, bwd = line["launches"][i][0]
            if not (fwd > 0 and bwd > 0):
                raise AssertionError(f"{what}: B2 launches {fwd} / {bwd} "
                                     "in its measured step")
        if any(f or b for f, b in line["launches"][-1]):
            raise AssertionError(f"(a) rank {rank}: B2 launched in the "
                                 "pipeline variant")
        if not np.isfinite([v["loss"]
                            for v in rec["variants"].values()]).all():
            raise AssertionError(f"(a) rank {rank}: a loss is not finite")
    for i, (name, v) in enumerate(rec0["variants"].items()):
        rest = {k: e["bytes"] for k, e in v["recorded"].items()
                if k not in SYNC_KINDS}
        print(f"[diststep] (a) {name}: {v['sync_mode']}"
              f"{' streamed' if v['streamed'] else ''} on {v['schedule']} "
              f"{v['op_counts']}: sync bytes "
              f"{ {k: v['recorded'][k]['bytes'] for k in SYNC_KINDS if k in v['recorded']} }"
              f" = the plan's (fraction {v['sync_plan']['fraction']:.4f}), "
              f"calls {v['collectives_n']}, wire a rank "
              f"{v['wire_bytes']:.0f} = the plan's; other kinds {rest}; "
              f"loss {v['loss']:.6f}; B2 launches (fwd, bwd) a step "
              f"{by_rank[0]['launches'][i]}; "
              f"{v['wall_us_per_step'] / 1e3:.3f} ms a timed step {tag}",
              flush=True)
    p = rec0["pipeline"]
    z, z3, ov = rec0["zero_sync"], rec0["zero3"], rec0["overlap"]
    print(f"[diststep] (a) gemma3-1b, {DM_DEPTH} of 26 layers, batch "
          f"{DM_BATCH} x {DM_SEQ}, {DM_MB} micro-batches, two gloo ranks on "
          f"one card (staged: not interconnect numbers): all_reduce_fraction "
          f"{rec0['all_reduce_fraction']:.4f} (the plans' ar_bytes ratio; "
          f"sync_model_fraction {rec0['sync_model_fraction']:.4f}; the tied "
          f"262,144 x 1,152 embedding, synced by every variant, is 302 M of "
          f"the 463 M parameters, so the fractions sit above the paper's "
          f"~0.5); ZeRO-1 wire fraction {z['paper_mix_wire_fraction']:.4f} "
          f"(masked {z['paper_mix_masked_wire_fraction']:.4f}; spread "
          f"{z['uniform_wire_fraction']:.4f} / "
          f"{z['uniform_masked_wire_fraction']:.4f}, "
          f"{z['uniform_masked_n_skipped']} leaves skipped), moments "
          f"{z['opt_memory_fraction']:.4f} a rank; ZeRO-3 wire "
          f"{z3['paper_mix_wire_fraction']:.4f}, residency "
          f"{z3['residency_fraction']:.4f}, {z3['n_gather_elided']} gathers "
          f"elided ({z3['elided_bytes']:.0f} bytes); streamed: measured "
          f"residency {ov['streamed_residency_fraction']:.4f} (model "
          f"agreement {ov['peak_agreement']:.6f}), exposed gather fraction "
          f"{ov['exposed_collective_fraction']:.4f} (model, compute ratio "
          f"{ov['compute_ratio']}), wire ratio to unstreamed "
          f"{ov['wire_ratio_vs_unstreamed']:.6f}; pipeline (data 1, stage 2)"
          f" boundaries {p['boundaries']} makespan_ratio "
          f"{p['makespan_ratio']:.4f} bubble {p['bubble_fraction']:.4f} "
          f"(layer-count {p['layer_count_bubble_fraction']:.4f}), "
          f"{p['wall_us_per_step'] / 1e3:.3f} ms a timed step; "
          f"{by_rank[0]['seconds']:.1f} s, peak "
          f"{max(r['peak'] for r in by_rank.values()) / 2**30:.2f} GiB a "
          f"rank {tag}", flush=True)


def elastic_measure_checks(tag, by_rank):
    """Phase 30 (b)'s checks on the four ranks' ``em`` lines: JAX's code's
    outcomes at four ranks; prints the ``ELASTICM`` line."""
    rec0 = by_rank[0]["record"]
    print("ELASTICM " + json.dumps(rec0), flush=True)
    for rank, line in sorted(by_rank.items()):
        rec, what = line["record"], f"(b) rank {rank}"
        d, g, lo, st = (rec["dropout"], rec["nan_guard"], rec["lofi"],
                        rec["straggler"])
        if d["n_devices_after"] != 2 or (rank < 2 and not (
                d["ckpt_step"] == 2 and d["recovery_steps"] == 1
                and d["resume_parity_diff"] <= EL_RESUME_TOL
                and d["resume_opt_diff"] <= EL_RESUME_TOL)):
            raise AssertionError(f"{what}: dropout {d}")
        if g["skip_steps"] != [2] or g["steps_skipped"] != 1:
            raise AssertionError(f"{what}: guard {g}")
        if not (lo["n_fallbacks"] == 1 and lo["fallback_step"] == 2
                and lo["n_merges"] >= 1 and lo["final_mode_local"] == 1
                and lo["loss_drop"] > 0):
            raise AssertionError(f"{what}: lo-fi {lo}")
        if not (st["n_capacity_refreshes"] >= 1
                and st["mitigation_ratio"] < 1.0 and math.isclose(
                    st["mitigation_ratio"],
                    st["makespan"] / st["unmitigated_makespan"],
                    abs_tol=2e-6)):
            raise AssertionError(f"{what}: straggler {st}")
    d, g, lo, st = (rec0["dropout"], rec0["nan_guard"], rec0["lofi"],
                    rec0["straggler"])
    print(f"[diststep] (b) measure_elastic({EM_RANKS}), four gloo ranks on "
          f"one card, its own config (4 layers, d 64, batch 32 x 16, 16 "
          f"micro-batches): straggler unit times {st['unit_times']}, "
          f"mitigation ratio {st['mitigation_ratio']} ({st['makespan']} / "
          f"{st['unmitigated_makespan']}); dropout: {d['n_devices_after']} "
          f"ranks resume ckpt_{d['ckpt_step']}, {d['recovery_steps']} step "
          f"replayed, max diff to a fresh resume {d['resume_parity_diff']} "
          f"(state {d['resume_opt_diff']}); guard skips at "
          f"{g['skip_steps']}, final-loss gap fraction "
          f"{g['gap_fraction']}; lo-fi from step {lo['fallback_step']}, "
          f"{lo['n_merges']} merges, loss drop {lo['loss_drop']}; wall s "
          f"{[rec0[k]['wall_s'] for k in ('straggler', 'dropout', 'nan_guard', 'lofi')]}"
          f"; {by_rank[0]['seconds']:.1f} s in the function {tag}",
          flush=True)


def measurement(torch, np, tag, recs=None):
    """Phase 30: (a)'s checks on ``recs`` (phase 28's run, with its "dm"
    leg; None: a run of "dm" alone), then (b) in a torch.distributed.run
    of four ranks."""
    t0 = time.perf_counter()
    if recs is None:
        recs, _ = mx_run(torch, np, [], "dm")
    diststep_checks(np, tag, recs["dm"])
    em, secs = mx_run(torch, np, [], "em", n_ranks=EM_RANKS)
    elastic_measure_checks(tag, em["em"])
    print(f"[diststep] phase 30 took {time.perf_counter() - t0:.1f} s after "
          f"(a)'s run ({recs['dm'][0]['seconds']:.1f} s in phase 28's "
          f"ranks); (b) {secs:.1f} s in its torch.distributed.run of "
          f"{EM_RANKS} ranks", flush=True)


def param_sum(torch, tensors):
    """A checksum of float32 tensors: their bits as int32, summed."""
    return int(torch.stack([t.detach().view(torch.int32).sum(
        dtype=torch.int64) for t in tensors]).sum())


def el_argv(leg, ckdir):
    """The launcher's flags of phase 29's leg: "ea" (a) on two ranks with
    (a)'s plan, "er" the resume of (a)'s step-3 checkpoint on rank 0 alone
    (a mesh of one in the world of two), "eb" (b) on two ranks."""
    d2 = GM_D2FT
    steps = EL_STEPS if leg == "eb" else EL_STEPS_A
    argv = ["--arch", "gemma3-1b", "--full", "--batch", str(GM_BATCH),
            "--seq", str(GM_SEQ), "--steps", str(steps), "--lr",
            str(GM_LR), "--n-microbatches", str(d2["n_microbatches"]),
            "--n-pf", str(d2["n_pf"]), "--n-po", str(d2["n_po"]), "--d2ft",
            "--kernel", "--distributed", "--elastic", "--refresh-every",
            str(DP_REFRESH)]
    if leg == "ea":
        return argv + ["--mesh", "data=2", "--faults",
                       os.path.join(ckdir, "plan_a.json"), "--ckpt-every",
                       str(EL_CKPT_EVERY), "--ckpt-dir",
                       os.path.join(ckdir, "a")]
    if leg == "er":
        return argv + ["--mesh", "data=1", "--resume-from",
                       os.path.join(ckdir, "a", f"ckpt_{EL_CKPT_EVERY}.npz"),
                       "--ckpt-every", "0", "--ckpt-dir",
                       os.path.join(ckdir, "r")]
    return argv + ["--mesh", "data=2", "--faults",
                   os.path.join(ckdir, "plan_b.json"), "--merge-every",
                   str(EL_MERGE_EVERY), "--ckpt-every", "0", "--ckpt-dir",
                   os.path.join(ckdir, "b")]


def el_leg(torch, leg, rank, ckdir, keep):
    """One rank's run of phase 29's ``leg`` (``el_argv``) on the card,
    gemma3-1b cut to ``EL_DEPTH`` layers, the kernel path only. After
    every step: a checksum of the parameters and B2's launches so far;
    after every lo-fi merge: a checksum of the merged parameters and the
    bytes the merge sent. ``keep`` carries rank 0's final (a) parameters
    (on the host) to "er", which records its largest difference from
    them. Rank 0 deletes each checkpoint once no later run reads it.
    Returns the run's record (a rank outside the run's mesh: ``sat_out``).
    """
    import shutil
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.launch import train as launcher
    from repro_torch.sharding import sync
    from repro_torch.train import elastic

    def refuse(kind, reason):
        raise AssertionError(f"{kind} took a non-kernel route: {reason}")
    contract.on_fallback = refuse
    make, merge = elastic.make_distributed_train_step, sync.lofi_merge_
    configs, init = launcher.get_config, launcher.init_model
    sums, at, merges, made = [], [], [], []

    def launched():
        return d2a.flash_fwd.launches + d2a.flash_bwd.launches

    def checked(*a, **k):
        step = make(*a, **k)

        def run(model, *rest):
            out = step(model, *rest)
            torch.cuda.synchronize()
            sums.append(param_sum(torch, model.parameters()))
            at.append(launched())
            return out
        return run

    def recorded(named, plan, mesh, kind="all_reduce"):
        sent = mesh.counter.bytes.get(kind, 0)
        merge(named, plan, mesh, kind)
        torch.cuda.synchronize()
        merges.append({"sum": param_sum(torch, named.values()),
                       "bytes": mesh.counter.bytes[kind] - sent})
        return named

    def capture_init(*a, **k):
        made.append(init(*a, **k))
        return made[-1]

    elastic.make_distributed_train_step, sync.lofi_merge_ = checked, recorded
    launcher.get_config = lambda arch: configs(arch).replace(
        n_layers=EL_DEPTH)
    launcher.init_model = capture_init
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        log = launcher.main(el_argv(leg, ckdir))
    finally:
        elastic.make_distributed_train_step, sync.lofi_merge_ = make, merge
        launcher.get_config, launcher.init_model = configs, init
    secs = time.perf_counter() - t0
    if log is None:
        return {"rank": rank, "run": leg, "sat_out": True}
    ev = log.extras["elastic"]
    named = dict(made[-1].named_parameters())
    line = {
        "rank": rank, "run": leg, "seconds": secs, "losses": log.losses,
        "step_ms": [1e3 * t for t in log.step_times],
        "by_kind": log.extras["sync_bytes_by_kind"],
        "ms_by_kind": log.extras["sync_ms_by_kind"],
        "events": ev["events"], "final_mode": ev["final_mode"],
        "dropped": ev["dropped"], "n_devices": ev["n_devices"],
        "ckpts": [{k: c[k] for k in ("step", "seconds", "bytes")}
                  for c in ev["ckpts"]],
        "restores": [{k: c[k] for k in ("step", "seconds")}
                     for c in ev["restores"]],
        "refreshes": [{k: r[k] for k in ("step", "elastic", "n_devices",
                                          "sync_mode")}
                      for r in log.extras["refreshes"]],
        "sums": sums, "at": at, "launches_end": launched(),
        "merges": merges, "peak": torch.cuda.max_memory_allocated(),
        "tree_bytes": sum(p.numel() * p.element_size()
                          for p in named.values())}
    if leg == "ea" and not ev["dropped"]:
        keep["a"] = {n: p.detach().cpu() for n, p in named.items()}
    if leg == "er":
        line["max_diff"] = max(
            float((p.detach().cpu() - keep["a"][n]).abs().max())
            for n, p in named.items())
    if rank == 0:
        if leg == "ea":
            for c in ev["ckpts"]:
                if c["step"] != EL_CKPT_EVERY:
                    os.remove(c["path"])
        else:
            for d in (("a", "r") if leg == "er" else ("b",)):
                shutil.rmtree(os.path.join(ckdir, d), ignore_errors=True)
    del made[:], named, log
    torch.cuda.empty_cache()
    return line


def update_norms(torch, params, start):
    """Each leaf's float64 norm of what the run moved it by."""
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(p - start[n],
                                                  dtype=torch.float64))
                for n, p in params.items()}


def mx_reference(torch, np, cfg, table):
    """(b)'s one-rank masked ``loop.finetune`` (``use_kernel=False``) of the
    same cut model, seed and batches, the run's table replayed, with the
    momentum-free SGD. Returns the losses and each leaf's update norm."""
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.schedule import Schedule
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.train import loop

    G = cfg.n_heads
    d2 = D2FTConfig(head_groups=G, **NA_D2FT)
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    sched = Schedule(decode_table(np, table, cfg, G), cfg.n_layers, G)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    plan = loop.plan_from_scores
    loop.plan_from_scores = lambda *a, **k: sched
    try:
        _, _, log = loop.finetune(
            model, cfg, d2, plain_sgd(torch, NA_LR),
            lm_batches(0, cfg.vocab_size, NA_BATCH, NA_SEQ, NA_STEPS),
            steps=NA_STEPS, use_kernel=False)
    finally:
        loop.plan_from_scores = plan
    updates = update_norms(torch, dict(model.named_parameters()), start)
    del model, start
    torch.cuda.empty_cache()
    return log.losses, updates


def mx_check_updates(mine, ref, what):
    """Every leaf's update norm within ``MX_UPDATE_TOL`` of the reference's
    (relative; a leaf the reference left still must stay still). Returns
    the largest relative difference."""
    if set(mine) != set(ref):
        raise AssertionError(f"{what}: leaves {sorted(set(mine) ^ set(ref))}"
                             f" in one run only")
    worst = 0.0
    for n, b in ref.items():
        d = abs(mine[n] - b)
        if d > MX_UPDATE_TOL * b:
            raise AssertionError(f"{what}: {n} moved by {mine[n]!r}, the "
                                 f"one-rank run's by {b!r}")
        worst = max(worst, d / b if b else 0.0)
    return worst


def mx_ms(np, r):
    """A run's p50 host-clock ms by collective kind (the calls alone)."""
    kinds = sorted({k for d in r["ms_by_kind"] for k in d})
    return {k: round(float(np.median([d.get(k, 0.0)
                                      for d in r["ms_by_kind"]])), 3)
            for k in kinds}


def mx_check_ranks(np, recs, what):
    """Both ranks' losses equal and finite, and their parameter checksums
    bitwise equal after every step and at the end."""
    r0, r1 = recs[0], recs[1]
    if r0["losses"] != r1["losses"] or not np.isfinite(r0["losses"]).all():
        raise AssertionError(f"{what}: losses {r0['losses']} vs "
                             f"{r1['losses']}")
    if r0["sums"] != r1["sums"] or r0["weighted"] != r1["weighted"] or \
            len(r0["sums"]) != len(r0["losses"]):
        raise AssertionError(f"{what}: parameter checksums differ across "
                             f"ranks: {r0['sums']} {r0['weighted']} vs "
                             f"{r1['sums']} {r1['weighted']}")


def mx_check_kinds(rec, want, what):
    """Each step's bytes by collective equal ``want`` (one dict a step)."""
    if rec["by_kind"] != want:
        raise AssertionError(f"{what} rank {rec['rank']}: bytes by "
                             f"collective {rec['by_kind']} != {want}")


def multi_axis(torch, np, tag, a, ckdir=""):
    """Phase 28: (a) and (b) in one torch.distributed.run of two gloo
    ranks; ``a``: phase 26 (a)'s one-rank record (its losses and the
    schedules it planned), which (a) replays and is held to. With
    ``ckdir`` (``el_dir``) the same ranks then run phase 29's legs, whose
    records it returns."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    recs, secs = mx_run(torch, np, a["tables"],
                        "a,am,b" + ("," + EL_LEGS + ",dm" if ckdir else ""),
                        ckdir)
    t_ref = time.perf_counter()

    # (a) gemma3-1b, stage=2
    ra = recs["a"]
    mx_check_ranks(np, ra, "(a)")
    r0 = ra[0]
    if r0["tables"] != a["tables"]:
        raise AssertionError("(a): the replayed schedules differ from "
                             "phase 26 (a)'s")
    diff = check_losses(np, SimpleNamespace(losses=r0["losses"]),
                        SimpleNamespace(losses=a["losses"][:MX_STEPS]))
    M, S, D = GM_D2FT["n_microbatches"], 2, get_config("gemma3-1b").d_model
    act = (GM_BATCH // M) * GM_SEQ * D * 4
    p2p = 0
    for rank, r in ra.items():
        plan_ar = dp_plan_bytes(r, "ar_bytes")
        want = [{"stage": r["tree_bytes"] + 12, "all_reduce": int(ar),
                 "p2p": M * act} for ar in plan_ar]
        mx_check_kinds(r, want, "(a)")
        p2p += r["by_kind"][0]["p2p"]
    if p2p != 2 * M * (S - 1) * act:
        raise AssertionError(f"(a): p2p bytes a step {p2p} != "
                             f"{2 * M * (S - 1) * act}")
    print(f"[multi-axis] (a) gemma3-1b full size (26 layers) through "
          f"repro_torch.launch.train --distributed --mesh stage=2, two gloo "
          f"ranks on one card (pipeline sends and collectives staged "
          f"through pinned host memory: not interconnect numbers), batch "
          f"{GM_BATCH} x {GM_SEQ}, M {M} micro-batches of "
          f"{GM_BATCH // M}, n_pf {GM_D2FT['n_pf']} n_po {GM_D2FT['n_po']}"
          f", G 4, AdamW lr {GM_LR}, {MX_STEPS} steps re-planned at steps "
          f"{r0['refresh_steps']} on phase 26 (a)'s schedules (replayed): "
          f"losses {[round(x, 6) for x in r0['losses']]} vs phase 26 (a)'s "
          f"one rank {[round(x, 6) for x in a['losses'][:MX_STEPS]]}, "
          f"max diff "
          f"{diff:.3e}; parameter checksums bitwise equal on both ranks "
          f"after every step {r0['sums']}; bytes a step by collective: "
          f"rank 0 {r0['by_kind'][0]}, rank 1 {ra[1]['by_kind'][0]} "
          f"(stage = the gradient tree's {r0['tree_bytes']} + 12, p2p "
          f"{p2p} summed over the ranks = 2 x {M} x {S - 1} x "
          f"{GM_BATCH // M} x {GM_SEQ} x {D} x 4, all_reduce = the data "
          f"axis's ar_bytes) {tag}", flush=True)
    for k, rep in enumerate(r0["stages"]):
        print(f"[multi-axis] (a) stages at step {r0['refresh_steps'][k]}: "
              f"boundaries {rep['boundaries']} loads {rep['loads']} "
              f"makespan_ratio {rep['makespan_ratio']:.4f} (vs layer-count "
              f"{rep['layer_count_boundaries']}) bubble "
              f"{rep['bubble_fraction']:.4f}", flush=True)
    mx_timing_lines(np, "(a)", ra, tag)
    mx_mix(torch, np, recs["am"], tag)

    # (b) stablelm-3b, 8 of 32 layers, tensor=2
    rb = recs["b"]
    mx_check_ranks(np, rb, "(b)")
    cfg = get_config("stablelm-3b").replace(n_layers=MX_DEPTH)
    ref, ref_updates = mx_reference(torch, np, cfg, rb[0]["tables"][0])
    diff_b = check_losses(np, SimpleNamespace(losses=rb[0]["losses"]),
                          SimpleNamespace(losses=ref))
    upd_b = max(mx_check_updates(r["updates"], ref_updates, f"(b) rank {k}")
                for k, r in rb.items())
    act_b = NA_BATCH * NA_SEQ * cfg.d_model * 4
    for rank, r in rb.items():
        want = [{"tp_grad": r["tp_bytes"], "tp_act": 4 * MX_DEPTH * act_b,
                 "all_reduce": int(ar)}
                for ar in dp_plan_bytes(r, "ar_bytes")]
        mx_check_kinds(r, want, "(b)")
    layer_tp = 4 * cfg.d_model ** 2 + 3 * cfg.d_model * cfg.d_ff
    if rb[0]["tp_bytes"] != MX_DEPTH * layer_tp * 4:
        raise AssertionError(f"(b): tensor-sharded bytes "
                             f"{rb[0]['tp_bytes']} != {MX_DEPTH} x "
                             f"{layer_tp * 4}")
    b0 = rb[0]
    print(f"[multi-axis] (b) stablelm-3b full width, {MX_DEPTH} of 32 "
          f"layers, through repro_torch.launch.train --distributed --mesh "
          f"tensor=2, two gloo ranks on one card (staged: not interconnect "
          f"numbers), batch {NA_BATCH} x {NA_SEQ}, G {cfg.n_heads}, n_pf "
          f"{NA_D2FT['n_pf']} n_po {NA_D2FT['n_po']} of "
          f"{NA_D2FT['n_microbatches']}, momentum-free SGD lr {NA_LR}, "
          f"{NA_STEPS} steps: losses {[round(x, 6) for x in b0['losses']]} "
          f"vs the one-rank masked finetune of the same model, batches and "
          f"schedule {[round(x, 6) for x in ref]}, max diff {diff_b:.3e}; "
          f"each leaf's update norm (float64, of the {len(ref_updates)} "
          f"leaves, {math.sqrt(sum(v * v for v in ref_updates.values())):.6e}"
          f" in all) within {upd_b:.3e} of the one-rank run's, relative "
          f"(limit {MX_UPDATE_TOL}); "
          f"parameter checksums bitwise equal on both ranks after every "
          f"step {b0['sums']}; bytes a step by collective {b0['by_kind'][0]}"
          f" (tp_grad = {MX_DEPTH} x {layer_tp * 4}, tp_act = {MX_DEPTH} x "
          f"4 x {act_b}, all_reduce = the data axis's ar_bytes); reference "
          f"{time.perf_counter() - t_ref:.1f} s {tag}", flush=True)
    mx_timing_lines(np, "(b)", rb, tag)
    el_secs = max((r["seconds"] for leg in EL_LEGS.split(",")
                   for r in recs.get(leg, {}).values() if "seconds" in r),
                  default=0.0)
    print(f"[multi-axis] phase 28 took {time.perf_counter() - t_phase:.1f} s "
          f"({secs:.1f} s in its torch.distributed.run of two ranks"
          + (f", phase 29's runs included: their longest {el_secs:.1f} s"
             if ckdir else "") + ")", flush=True)
    return recs


class el_dir:
    """Phase 29's checkpoint directory: a fresh temporary directory with
    (a)'s and (b)'s fault plans (``FaultPlan.to_json``), removed with
    everything in it on exit, whether the phase passed or failed. Refuses
    to start with less than ``EL_DISK`` bytes free there."""

    def __enter__(self):
        import shutil
        import tempfile
        from repro_torch.launch.faults import FaultPlan
        self.path = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
        free = shutil.disk_usage(self.path).free
        if free < EL_DISK:
            shutil.rmtree(self.path)
            raise AssertionError(
                f"phase 29 needs {EL_DISK / 1e9:.0f} GB free for its "
                f"checkpoints (two of 5.56 GB at once) under "
                f"{os.path.dirname(self.path)}: {free / 1e9:.1f} GB free")
        for name, plan in (("plan_a", EL_PLAN_A), ("plan_b", EL_PLAN_B)):
            with open(os.path.join(self.path, f"{name}.json"), "w") as f:
                f.write(FaultPlan(**plan).to_json())
        return self.path

    def __exit__(self, *exc):
        import shutil
        shutil.rmtree(self.path, ignore_errors=True)
        return False


def elastic_checks(torch, np, tag, recs):
    """Phase 29's checks on the records of its three runs (``el_leg``)."""
    a0, a1 = recs["ea"][0], recs["ea"][1]
    # (a) step 1: a guard skip on both ranks, the parameters untouched
    for r in (a0, a1):
        skips = [e for e in r["events"] if e["type"] == "guard_skip"]
        if [e["step"] for e in skips] != [1] or \
                skips[0]["bad_devices"] != 1.0:
            raise AssertionError(f"(a) rank {r['rank']}: guard skips "
                                 f"{skips}")
        if r["sums"][1] != r["sums"][0]:
            raise AssertionError(f"(a) rank {r['rank']}: the parameters "
                                 f"moved at the skipped step: {r['sums']}")
    if a0["sums"][:4] != a1["sums"][:4] or \
            a0["losses"][:4] != a1["losses"][:4]:
        raise AssertionError(f"(a): the ranks differ before the dropout: "
                             f"{a0['sums']} {a1['sums']}")
    # the refresh at step 2 engages capacities for the straggler
    mit = next(x for x in a0["refreshes"] if x["step"] == 2)["elastic"]
    if mit["unit_times"] != [1.0, 1.75] or mit["capacities"] is None or \
            not mit["makespan"] <= mit["unmitigated_makespan"]:
        raise AssertionError(f"(a): the step-2 refresh's mitigation {mit}")
    # the dropout at step 4: rank 0 restores ckpt_3 alone; rank 1 stops
    rec = [e for e in a0["events"] if e["type"] == "dropout_recovery"]
    if len(rec) != 1 or rec[0]["ckpt_step"] != EL_CKPT_EVERY or \
            rec[0]["recovery_steps"] != 1 or rec[0]["n_devices"] != 1 or \
            a0["final_mode"] != "masked" or a0["dropped"]:
        raise AssertionError(f"(a) rank 0: events {a0['events']}")
    if [e["type"] for e in a1["events"]] != ["guard_skip", "dropped"] or \
            not a1["dropped"] or len(a1["losses"]) != 4 or \
            a1["launches_end"] != a1["at"][-1]:
        raise AssertionError(f"(a) rank 1: events {a1['events']}, "
                             f"{len(a1['losses'])} steps, B2 launches "
                             f"{a1['at']} then {a1['launches_end']}")
    for r in (a0, a1):
        want = [2 * EL_DEPTH * (k + 1) for k in range(len(r["at"]))]
        if r["at"] != want or not np.isfinite(r["losses"]).all():
            raise AssertionError(f"(a) rank {r['rank']}: B2 launches "
                                 f"{r['at']} != {want}, losses "
                                 f"{r['losses']}")
    # a fresh resume of ckpt_3 on rank 0 alone ends where (a) did
    r0 = recs["er"][0]
    if not recs["er"][1].get("sat_out") or \
            not r0["max_diff"] <= EL_RESUME_TOL:
        raise AssertionError(f"the resume: max diff {r0.get('max_diff')}")
    # (b) two dropped syncs, the lo-fi fallback, merges equal on the ranks
    b0, b1 = recs["eb"][0], recs["eb"][1]
    kinds = [e["type"] for e in b0["events"]]
    merges = [e for e in b0["events"] if e["type"] == "merge"]
    if kinds[:3] != ["sync_drop", "sync_drop", "lofi_fallback"] or \
            not merges or b0["final_mode"] != "local" or \
            b0["events"] != b1["events"] or \
            not len(b0["merges"]) == len(merges) == len(b1["merges"]):
        raise AssertionError(f"(b): events {b0['events']} / "
                             f"{b1['events']}")
    for m0, m1, e in zip(b0["merges"], b1["merges"], merges):
        if m0["sum"] != m1["sum"] or \
                not m0["bytes"] == m1["bytes"] == e["merged_bytes"]:
            raise AssertionError(f"(b): merge at step {e['step']}: "
                                 f"checksums {m0} {m1}, plan bytes "
                                 f"{e['merged_bytes']}")

    def ckpt_line(r):
        return (f"saves {[(c['step'], round(c['seconds'], 3)) for c in r['ckpts']]}"
                f" s of {r['ckpts'][0]['bytes']} bytes, loads "
                f"{[(c['step'], round(c['seconds'], 3)) for c in r['restores']]} s")
    skip = [e for e in a0["events"] if e["type"] == "guard_skip"][0]
    print(f"[elastic] (a) gemma3-1b full width, {EL_DEPTH} of 26 layers "
          f"({a0['tree_bytes']} bytes of parameters), through "
          f"repro_torch.launch.train --d2ft --kernel --distributed --elastic"
          f" --mesh data=2 --faults {EL_PLAN_A}, two gloo ranks on one "
          f"card, batch {GM_BATCH} x {GM_SEQ}, n_pf {GM_D2FT['n_pf']} n_po "
          f"{GM_D2FT['n_po']} of {GM_D2FT['n_microbatches']}, G 4, AdamW lr "
          f"{GM_LR}, {EL_STEPS_A} steps re-planned every {DP_REFRESH}, "
          f"checkpoints every {EL_CKPT_EVERY}: step 1 a guard skip on both "
          f"ranks (bad_devices {skip['bad_devices']}, bad_blocks "
          f"{skip['bad_blocks']}), checksum after it {a0['sums'][1]} = after"
          f" step 0; the step-2 refresh: unit times {mit['unit_times']}, "
          f"capacities {mit['capacities']}, makespan {mit['makespan']} vs "
          f"unmitigated {mit['unmitigated_makespan']} (ratio "
          f"{mit['mitigation_ratio']}); the dropout at step 4: rank 0 "
          f"restored ckpt_{EL_CKPT_EVERY} alone ({rec[0]['recovery_steps']}"
          f" step to replay), rank 1 ran {len(a1['losses'])} steps and "
          f"launched {a1['launches_end']} B2 kernels, none after; rank 0's "
          f"B2 launches {a0['launches_end']}; losses "
          f"{[round(x, 6) for x in a0['losses']]}; rank 0 {ckpt_line(a0)} "
          f"{tag}", flush=True)
    print(f"[elastic] the resume of ckpt_{EL_CKPT_EVERY} on rank 0 alone "
          f"(--resume-from, --ckpt-every 0): losses "
          f"{[round(x, 6) for x in r0['losses']]} vs (a)'s after the "
          f"recovery {[round(x, 6) for x in a0['losses'][-len(r0['losses']):]]}"
          f"; final parameters' max diff from (a)'s {r0['max_diff']:.3e} "
          f"(limit {EL_RESUME_TOL}); {ckpt_line(r0)} {tag}", flush=True)
    print(f"[elastic] (b) the plan {EL_PLAN_B}, --merge-every "
          f"{EL_MERGE_EVERY}, two gloo ranks: events {kinds}, final mode "
          f"{b0['final_mode']}; after each merge the ranks' parameter "
          f"checksums {[m['sum'] for m in b0['merges']]} equal, each merge "
          f"sent its mask plan's bytes {[m['bytes'] for m in b0['merges']]} "
          f"(live fractions {[e['live_fraction'] for e in merges]}); losses "
          f"rank 0 {[round(x, 6) for x in b0['losses']]}, rank 1 "
          f"{[round(x, 6) for x in b1['losses']]} {tag}", flush=True)
    for leg, name in (("ea", "(a)"), ("er", "resume"), ("eb", "(b)")):
        for rank, r in sorted(recs[leg].items()):
            if r.get("sat_out"):
                continue
            print(f"[elastic] {name} rank {rank}: {r['seconds']:.1f} s; step "
                  f"ms {[round(x, 3) for x in r['step_ms']]} (p50 "
                  f"{float(np.median(r['step_ms'])):.3f}); p50 ms by "
                  f"collective (host clock, the calls alone) {mx_ms(np, r)}"
                  f"; bytes a step by collective {r['by_kind'][-1]}; peak "
                  f"{r['peak']} bytes ({r['peak'] / 2**30:.2f} GiB) {tag}",
                  flush=True)


def mx_mix(torch, np, recs, tag):
    """Phase 28 (a) on the concentrated mix: the live-cost boundaries
    must differ from the layer-count split; the losses are held to a
    one-rank ``finetune`` on the same table and batches
    (``dp_reference``), the bytes to (a)'s counts."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-1b")
    mx_check_ranks(np, recs, "(a) mix")
    r0 = recs[0]
    want = "".join(map(str, concentrated_table(
        np, cfg.n_layers, cfg.n_heads,
        GM_D2FT["n_microbatches"]).ravel()))
    if r0["tables"] != [want]:
        raise AssertionError("(a) mix: the planned table is not the "
                             "concentrated mix")
    rep = r0["stages"][0]
    if rep["boundaries"] == rep["layer_count_boundaries"] or \
            not rep["makespan_ratio"] < 1.0:
        raise AssertionError(f"(a) mix: live-cost stages {rep} equal the "
                             f"layer-count split")
    t0 = time.perf_counter()
    ref = dp_reference(torch, np, cfg, r0["tables"])
    diff = check_losses(np, SimpleNamespace(losses=r0["losses"]),
                        SimpleNamespace(losses=ref))
    M, S = GM_D2FT["n_microbatches"], 2
    act = (GM_BATCH // M) * GM_SEQ * cfg.d_model * 4
    for rank, r in recs.items():
        mx_check_kinds(r, [{"stage": r["tree_bytes"] + 12,
                            "all_reduce": int(ar), "p2p": M * act}
                           for ar in dp_plan_bytes(r, "ar_bytes")],
                       "(a) mix")
    print(f"[multi-axis] (a) mix: the same run on phase 27's concentrated "
          f"mix (seed 0), {MX_MIX_STEPS} steps, one plan: stages "
          f"boundaries {rep['boundaries']} loads {rep['loads']} "
          f"makespan_ratio {rep['makespan_ratio']:.4f} (vs layer-count "
          f"{rep['layer_count_boundaries']}) bubble "
          f"{rep['bubble_fraction']:.4f}; losses "
          f"{[round(x, 6) for x in r0['losses']]} vs one-rank "
          f"finetune(use_kernel=True) on the same table and batches "
          f"{[round(x, 6) for x in ref]}, max diff {diff:.3e}; parameter "
          f"checksums bitwise equal on both ranks {r0['sums']}; bytes a "
          f"step by collective rank 0 {r0['by_kind'][0]}, rank 1 "
          f"{recs[1]['by_kind'][0]}; reference "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    mx_timing_lines(np, "(a) mix", recs, tag)


def mx_timing_lines(np, leg, recs, tag):
    for rank, r in sorted(recs.items()):
        print(f"[multi-axis] {leg} rank {rank}: step ms "
              f"{[round(x, 3) for x in r['step_ms']]} (p50 "
              f"{float(np.median(r['step_ms'])):.3f}); p50 ms by collective "
              f"(host clock, the calls alone) {mx_ms(np, r)}; peak "
              f"{r['peak']} bytes ({r['peak'] / 2**30:.2f} GiB) {tag}",
              flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank(torch, np, sys.argv[2], sys.argv[3], sys.argv[4:])
    if sys.argv[1:2] == ["--mx-rank"]:
        return mx_rank(torch, np, *sys.argv[2:5])
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import paged_decode_attention
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.paged_decode import (n_splits, paged_decode_ref,
                                                  paged_flash_decode,
                                                  split_len)
    from repro_torch.serving.engine import (PagedServingEngine, Request,
                                            make_engine)
    from repro_torch.serving.pages import pages_needed

    # 1. device -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
          f"-> {build.build_dir()}", flush=True)
    print(build.ptxas_report(), flush=True)

    if sys.argv[1:] in (["--only", "25"], ["--only", "26"],
                        ["--only", "27"], ["--only", "28"],
                        ["--only", "29"], ["--only", "30"]):
        # phase 25, 26, 27, 28, 29 or 30 alone, after the device and the
        # build: a partial run, which prints no result
        from repro_torch.kernels import contract

        def refuse(kind, reason):
            raise AssertionError(f"{kind} took a non-kernel route: {reason}")
        contract.on_fallback = refuse
        only = sys.argv[2]
        if only == "25":
            new_archs(torch, np, f"[{card}]")
        elif only == "28":
            # phase 26 (a)'s one-rank run, the schedules and losses phase
            # 28 (a) replays and is held to
            recs, _ = dp_run([sys.executable, str(ROOT / "chip_smoke.py")]
                             + dp_argv(1, "launcher", "masked:adamw"), 1)
            multi_axis(torch, np, f"[{card}]", recs["masked_adamw"][0])
        elif only == "29":
            t29 = time.perf_counter()
            with el_dir() as ckdir:
                recs, secs = mx_run(torch, np, [], EL_LEGS, ckdir)
                elastic_checks(torch, np, f"[{card}]", recs)
            print(f"[elastic] phase 29 took {time.perf_counter() - t29:.1f} "
                  f"s ({secs:.1f} s in its torch.distributed.run of two "
                  "ranks)", flush=True)
        elif only == "30":
            measurement(torch, np, f"[{card}]")
        else:
            data_parallel(torch, np, f"[{card}]", phases=(int(only),))
        print(f"chip_smoke: phase {only} alone passed (a partial run: no "
              "result)")
        return 0

    t_lap = [time.perf_counter()]

    def lap(phase):
        """Prints the seconds since the last lap: the phases before
        ``phase``."""
        now = time.perf_counter()
        print(f"[timing] {now - t_lap[0]:.1f} s up to phase {phase}",
              flush=True)
        t_lap[0] = now

    # 3. kernel vs plain --------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_pmax = 130
    max_err = 0.0
    # lengths at and around page boundaries; at a 64-position run's end
    # and one past it; tables null-padded over whole runs (10 and 5 of
    # 130 pages' 33 runs); gated heads and a slot with every head gated
    for lengths, gated in (
            ([15, 16, 17, 700], ((1, 0), (1, 1), (1, 2), (1, 3), (2, 2))),
            ([511, 512, 1500, 2063], ((0, 1), (3, 0), (3, 1), (3, 2),
                                      (3, 3))),
            ([63, 64, 127, 128], ((2, 1),)),
            ([10, 700, 5, 2070], ((1, 3),))):
        for window in (0, 512, 40):
            args = paged_inputs(torch, gen, lengths, n_pages=600,
                                n_pmax=n_pmax, gated=gated)
            out = paged_decode_attention(*args[:5], g_f=args[5],
                                         window=window)
            again = paged_decode_attention(*args[:5], g_f=args[5],
                                           window=window)
            torch.cuda.synchronize()
            ref = paged_decode_ref(*args, window=window)
            err = float((out - ref).abs().max())
            dead = args[5] == 0
            if err > KERNEL_TOL or not torch.isfinite(out).all() or \
                    float(out[dead].abs().max()) != 0.0 or \
                    not torch.equal(out, again):
                raise AssertionError(
                    f"kernel vs plain: lengths {lengths} window {window}: "
                    f"max abs err {err} (tol {KERNEL_TOL}), dead heads "
                    f"{float(out[dead].abs().max())}, bitwise equal on a "
                    f"second call {torch.equal(out, again)}")
            max_err = max(max_err, err)
    print(f"[kernel vs plain] paged_decode f32 B=4 H=4 n_kv=1 hd=256 "
          f"ps={PAGE_SIZE} n_pmax={n_pmax} ({n_splits(n_pmax, PAGE_SIZE)} "
          f"runs of {split_len(PAGE_SIZE)}), windows 0/512/40, lengths at "
          f"page and run boundaries, tables null-padded over whole runs, "
          f"gated heads: max abs err {max_err:.3e} <= {KERNEL_TOL}, "
          f"bitwise equal across two calls", flush=True)
    decode_shapes_vs_plain(torch, gen)

    lap(4)
    # 4. serve ------------------------------------------------------------
    cfg = get_config("gemma3-1b")
    max_seq = max(s + m for s, m in zip(PROMPT_LENS, MAX_NEW))
    n_pages = MAX_SLOTS * pages_needed(max_seq, PAGE_SIZE) + 1
    kw = dict(page_size=PAGE_SIZE, n_pages=n_pages, max_slots=MAX_SLOTS,
              max_seq_len=max_seq)
    rng = np.random.RandomState(0)
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=s)
                    .astype(np.int32), max_new_tokens=m)
            for i, (s, m) in enumerate(zip(PROMPT_LENS, MAX_NEW))]
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, device="cuda", use_kernel=True, **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with torch.inference_mode():                   # the repo's output check
        logits, _ = eng._prefill(torch.from_numpy(
            reqs[0].prompt.astype(np.int64)).cuda()[None])
    if tuple(logits.shape) != (1, PROMPT_LENS[0], cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             "not finite or misshapen")
    PagedServingEngine(eng.model, cfg, use_kernel=True, **kw).run(
        [Request(uid=0, prompt=reqs[0].prompt, max_new_tokens=4)])  # warm-up

    prefill_s, step_s = [], []

    def timed(fn, sink):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t)
            return out
        return call

    eng._prefill = timed(eng._prefill, prefill_s)
    eng._step = timed(eng._step, step_s)
    torch.cuda.reset_peak_memory_stats()
    paged_flash_decode.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = paged_flash_decode.launches
    peak = torch.cuda.max_memory_allocated()

    n_attn = len(cfg.layer_kinds)
    if launches != n_attn * eng.n_steps or launches == 0:
        raise AssertionError(f"kernel launches {launches} != {n_attn} x "
                             f"{eng.n_steps} decode steps")
    for r in reqs:
        got = out.get(r.uid)
        if got is None or len(got) != r.prompt_len + r.max_new_tokens or \
                not np.array_equal(got[:r.prompt_len], r.prompt) or \
                got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.uid} did not finish cleanly")
    if eng.pm.n_free != eng.pm.capacity or eng.n_live or eng.waiting:
        raise AssertionError(f"pages leaked: {eng.stats()}")
    plain = PagedServingEngine(eng.model, cfg, use_kernel=False, **kw)
    plain_step_s = []
    plain._step = timed(plain._step, plain_step_s)
    plain_out = plain.run(reqs)
    if paged_flash_decode.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    diff = [r.uid for r in reqs if not np.array_equal(out[r.uid],
                                                      plain_out[r.uid])]
    if diff:
        raise AssertionError(f"kernel-path tokens differ from the plain "
                             f"gather path for requests {diff}")
    n_gen = sum(MAX_NEW)
    p50_step = 1e3 * float(np.median(step_s))
    tag = f"[{card}]"
    print(f"[serve] gemma3-1b full width (26 layers, d 1152, vocab 262144, "
          f"f32, seed 0), {len(reqs)} requests / {MAX_SLOTS} slots, "
          f"ps {PAGE_SIZE}, {n_pages} pages: {eng.n_steps} decode steps, "
          f"kernel launches {launches} = {n_attn} x {eng.n_steps}, all "
          f"finished, pool drained, tokens == plain path; init "
          f"{init_s:.1f} s", flush=True)
    print(f"[serve] generated tokens/s {n_gen / run_s:.2f} ({n_gen} tokens "
          f"in {run_s:.3f} s incl. prefill) {tag}")
    print(f"[serve] p50 decode step ms {p50_step:.3f} (min "
          f"{1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}, "
          f"{len(step_s)} steps; plain gather path p50 "
          f"{1e3 * float(np.median(plain_step_s)):.3f}) {tag}")
    print("[serve] prefill ms per request " + ", ".join(
        f"S={s}: {1e3 * t:.2f}" for s, t in zip(PROMPT_LENS, prefill_s))
        + f" {tag}")
    print(f"[serve] max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB) {tag}", flush=True)

    # 4b. where a decode step's time goes --------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof_eng = PagedServingEngine(eng.model, cfg, use_kernel=True, **kw)
    for r in reqs[-MAX_SLOTS:]:                    # the four longest prompts
        prof_eng.submit(r)
    prof_eng.step()                                # admits all four
    torch.cuda.synchronize()
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            prof_eng.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    attn_us = sum(t for t, _, k in dev if "paged_decode" in k)
    print(f"[profile] {n_prof} decode steps, 4 live slots (lengths from "
          f"{[r.prompt_len for r in reqs[-MAX_SLOTS:]]}): device busy "
          f"{busy_us / 1e3 / n_prof:.3f} ms per step, wall "
          f"{1e3 * prof_wall / n_prof:.3f} ms per step under the profiler, "
          f"idle share {1 - busy_us / 1e6 / prof_wall:.1%}; paged_decode "
          f"kernel {attn_us / 1e3 / n_prof:.3f} ms per step "
          f"({attn_us / busy_us:.1%} of busy) {tag}")
    print("[profile] top device time per step: " + "; ".join(
        f"{k[:60]} x{c // n_prof}: {t / 1e3 / n_prof:.3f} ms"
        for t, c, k in dev[:6]), flush=True)
    checks = page_check_host_time(
        torch, lambda: PagedServingEngine(eng.model, cfg, use_kernel=True,
                                          **kw),
        reqs[-MAX_SLOTS:], n_prof)
    counts = {(r[1], r[2]) for m in checks.values() for r in m}
    calls = checks["step"][0][2]
    if counts != {(1, calls), (1 + calls, calls)}:
        raise AssertionError(f"range checks and entry calls per step: "
                             f"{checks}")

    def both(mode):
        return ", ".join(f"{ms:.3f} ms of a {wall:.3f} ms step"
                         for ms, _, _, wall in checks[mode])
    print(f"[profile] page-id range check and the paged entry outside its "
          f"kernel launcher, host time per decode step over {n_prof} steps "
          f"(no profiler; in turns): with the engine's one check of its "
          f"host table a step ({calls:g} entry calls a step) {both('step')}"
          f"; with a check of the device table at every layer, as the "
          f"checked entry makes ({1 + calls:g} checks a step, each a device "
          f"sync) {both('per_layer')} {tag}", flush=True)

    lap(5)
    # 5. kernel timing ----------------------------------------------------
    final = sorted(s + m - 1 for s, m in zip(PROMPT_LENS, MAX_NEW))[-4:]
    npm = pages_needed(max_seq, PAGE_SIZE)
    args = paged_inputs(torch, gen, final, n_pages=n_pages, n_pmax=npm)
    B, H, hd = args[0].shape
    L = npm * PAGE_SIZE

    def library(window):
        q, kp, vp, table, ln, _ = args
        idx = table.long()
        keys = kp[idx].reshape(B, L, 1, hd).transpose(1, 2)
        vals = vp[idx].reshape(B, L, 1, hd).transpose(1, 2)
        pos = torch.arange(L, device="cuda")[None, :]
        t = ln.long()[:, None]
        mask = pos <= t
        if window:
            mask &= pos > t - window
        return F.scaled_dot_product_attention(
            q[:, :, None, :], keys, vals, attn_mask=mask[:, None, None, :],
            enable_gqa=True)[:, :, 0]

    records = {}
    # the kernels alone: output and workspace allocated outside the window
    ws = torch.empty(pd.workspace_floats(B, H, hd, npm, PAGE_SIZE),
                     device="cuda")
    dec_out = torch.empty_like(args[0])
    grid = (1, B, n_splits(npm, PAGE_SIZE))
    for window in (0, cfg.window):
        ref = paged_decode_ref(*args, window=window)
        lib_err = float((library(window) - ref).abs().max())
        k_ms = time_ms(torch, lambda: paged_flash_decode(
            *args, window=window))
        alone = time_ms(torch, lambda: pd._decode_call(
            *args, dec_out, ws, window=window))
        p_ms = time_ms(torch, lambda: paged_decode_ref(*args, window=window))
        l_ms = time_ms(torch, lambda: library(window))
        b_ms, by = bound(final, window, H=H, n_kv=1, hd=hd, n_pmax=npm)
        records[window] = (k_ms, p_ms, l_ms, b_ms, by)
        print(f"[kernel timing] paged_decode window={window} lengths "
              f"{final}, split grid (n_kv, B, n_split) = {grid} of "
              f"{split_len(PAGE_SIZE)}-position runs, then the merge: "
              f"launcher call {k_ms:.4f} ms (kernels alone, output and "
              f"workspace allocated outside the window, {alone:.4f} ms), "
              f"plain {p_ms:.4f} ms, library (gather+sdpa) {l_ms:.4f} ms "
              f"(max abs diff {lib_err:.1e}), bound {b_ms:.5f} ms by {by}, "
              f"{b_ms / k_ms:.1%} of bound ({b_ms / alone:.1%} alone) "
              f"{tag}", flush=True)
    print_resources("paged_decode", "kernel timing")
    del ws, dec_out
    decode_shapes_timing(torch, gen, final, npm, tag)

    paged = records[0]
    del eng, plain, prof_eng, args
    torch.cuda.empty_cache()

    lap(6)
    # 6. attention kernels vs plain ----------------------------------------
    errs = attention_vs_plain(torch, gen)

    lap(7)
    # 7. fine-tune --------------------------------------------------------
    train = finetune(torch, np, tag)

    lap(8)
    # 8. attention kernel timing ------------------------------------------
    timing = attention_timing(torch, gen, tag)
    torch.cuda.empty_cache()

    # a route that takes no kernel despite use_kernel=True must not pass
    from repro_torch.kernels import contract

    def refuse_fallback(kind, reason):
        raise AssertionError(f"{kind} took a non-kernel route: {reason}")
    contract.on_fallback = refuse_fallback

    lap(9)
    # 9. SSD kernels vs plain ---------------------------------------------
    ssd_errs = ssd_vs_plain(torch)
    torch.cuda.empty_cache()

    lap(10)
    # 10. LLM fine-tune through the launcher ------------------------------
    lm = lm_finetune(torch, np, tag)

    lap(11)
    # 11. SSD kernel timing -----------------------------------------------
    ssd_t = ssd_timing(torch, lm, tag)
    torch.cuda.empty_cache()

    lap(12)
    # 12. hd-256 attention kernels vs plain --------------------------------
    gm_errs = gemma_attention_vs_plain(torch, gen)
    torch.cuda.empty_cache()

    lap(13)
    # 13. gemma3-1b LLM fine-tune through the launcher ---------------------
    gm = launcher_finetune(torch, np, tag, "gemma3-1b", "gemma fine-tune",
                           GM_BATCH, GM_SEQ, GM_STEPS, GM_LR, GM_D2FT, (0, 5))

    lap(14)
    # 14. D2FT-LoRA fine-tune on gemma3-1b ---------------------------------
    lo = gemma_lora(torch, np, tag)

    lap(15)
    # 15. LoRA and hd-256 attention kernel timing --------------------------
    gm_t = gemma_timing(torch, gm, lo, tag)
    torch.cuda.empty_cache()

    lap(16)
    # 16. RG-LRU kernels vs plain -----------------------------------------
    rg_errs, rg_operands = rglru_vs_plain(torch)

    lap(17)
    # 17. recurrentgemma-2b fine-tune through the launcher ----------------
    rg = rg_finetune(torch, np, tag)

    lap(18)
    # 18. RG-LRU kernel timing --------------------------------------------
    rg_t = rglru_timing(torch, rg_operands, rg, tag)
    del rg_operands
    torch.cuda.empty_cache()

    lap(19)
    # 19. MoE kernels vs plain --------------------------------------------
    moe_errs = moe_vs_plain(torch)

    lap(20)
    # 20. D2FT-LoRA on olmoe-1b-7b at full width and depth -----------------
    ol = olmoe_lora(torch, np, tag)

    lap(21)
    # 21. the launcher's loop on olmoe-1b-7b, full width, 8 of 16 layers ---
    mo = olmoe_finetune(torch, np, tag)

    lap(22)
    # 22. MoE kernel timing -----------------------------------------------
    mo_t, _ = moe_timing(torch, mo, tag)
    torch.cuda.empty_cache()

    lap(23)
    # 23. the packed D2FT path on gemma3-1b; the two examples -------------
    packed_finetune(torch, np, tag)
    packed_examples(torch, np, tag)
    torch.cuda.empty_cache()

    lap(24)
    # 24. serving the recurrent and MoE families; the serve example -------
    serve_families(torch, np, tag)
    torch.cuda.empty_cache()

    lap(25)
    # 25. the rest of the model surface: six archs fine-tuned and served --
    new_archs(torch, np, tag)
    torch.cuda.empty_cache()

    lap(26)
    # 26-27. data-parallel D2FT on gemma3-1b, masked and ZeRO: one rank,
    # then two ---------------------------------------------------------
    dp = data_parallel(torch, np, tag)
    torch.cuda.empty_cache()

    lap(28)
    # 28-29. multi-axis D2FT: gemma3-1b on a stage axis of two, stablelm-3b
    # on a tensor axis of two; then, in the same ranks, the elastic layer
    # on gemma3-1b ----------------------------------------------------------
    with el_dir() as ckdir:
        mx = multi_axis(torch, np, tag, dp["a"], ckdir)
        elastic_checks(torch, np, tag, mx)
    lap(30)
    # 30. the distributed measurement layer: (a) ran in phase 28's ranks;
    # measure_elastic on four ----------------------------------------------
    measurement(torch, np, tag, mx)
    lap("31 (the kernel records)")

    k_ms, p_ms, l_ms, b_ms, by = paged
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:54",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": l_ms}]
    for kind, line in (("fwd", 133), ("bwd", 273)):
        k_ms, p_ms, l_ms, b_ms, by = timing[kind]
        kernels.append({
            "name": f"d2ft_attention_{kind}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/d2ft_attention_{kind}.cu",
            "replaces": f"src/repro/kernels/d2ft_attention.py:{line}",
            "launches": train["launches"][kind], "max_abs_err": errs[kind],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": l_ms})
    for kind, line in (("fwd", 80), ("bwd", 182)):
        k_ms, p_ms, b_ms, by = ssd_t[kind]
        kernels.append({
            "name": f"d2ft_ssd_{kind}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/d2ft_ssd_{kind}.cu",
            "replaces": f"src/repro/kernels/d2ft_ssd.py:{line}",
            "launches": lm["launches"][kind], "max_abs_err": ssd_errs[kind],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None})
    k_ms, p_ms, l_ms, b_ms, by = gm_t["lora"]
    kernels.append({
        "name": "lora_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:25",
        "launches": lo["launches"]["lora"], "max_abs_err": lo["err"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": l_ms})
    for kind, line in (("fwd", 133), ("bwd", 273)):
        k_ms, p_ms, l_ms, b_ms, by = gm_t[kind]
        kernels.append({
            "name": f"d2ft_attention_{kind}_hd256", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/d2ft_attention_{kind}.cu",
            "replaces": f"src/repro/kernels/d2ft_attention.py:{line}",
            "launches": gm["launches"][kind], "max_abs_err": gm_errs[kind],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": l_ms})
    for kind, line in (("fwd", 74), ("bwd", 155)):
        k_ms, p_ms, b_ms, by = rg_t[kind]
        kernels.append({
            "name": f"d2ft_rglru_{kind}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/d2ft_rglru_{kind}.cu",
            "replaces": f"src/repro/kernels/d2ft_rglru.py:{line}",
            "launches": rg["launches"][kind], "max_abs_err": rg_errs[kind],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None})
    # the backward as the launcher's full fine-tune asks for it (every dW)
    # and as D2FT-LoRA's step does (dW_up alone)
    for kind, line, runs in (("fwd", 90, mo), ("bwd", 137, mo),
                             ("bwd_dw_up", 137, ol)):
        k_ms, p_ms, l_ms, b_ms, by = mo_t[kind]
        kernels.append({
            "name": f"d2ft_moe_{kind}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/d2ft_moe_{kind[:3]}.cu",
            "replaces": f"src/repro/kernels/d2ft_moe.py:{line}",
            "launches": runs["launches"][kind[:3]],
            "max_abs_err": moe_errs[kind], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": l_ms})
    if len(kernels) != 13:
        raise AssertionError(f"{len(kernels)} kernel records, not 13")
    n_left = stop_marked(os.environ.get(RUN_ENV, str(os.getpid())),
                         "left running before the result")
    print(f"[processes] {n_left} of the script's processes were left "
          "running at its end (each stopped)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--dp-rank"], ["--mx-rank"]):
        sys.exit(main())                 # a rank: its run stops what it left
    os.environ[RUN_ENV] = str(os.getpid())
    try:
        rc = main()
    finally:
        # nothing this script started outlives it (a process that escaped
        # its sub-run's stop, e.g. one left by a phase that failed)
        stop_marked(os.environ[RUN_ENV], "left running at exit")
    sys.exit(rc)
