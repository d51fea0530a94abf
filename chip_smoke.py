"""Drive the PyTorch/H100 port once on one CUDA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-times   # attention kernel times and SASS counts, one JSON line

Phases (any failure raises and the script exits non-zero):

  1. build the CUDA kernels from gpt2_vision_language_tpu_torch/csrc (their
     registers, spills and SASS instruction counts printed; for the fp32
     kernels, the self-attention pair, the general pair, the split lse
     forward and its merge, and the dt-layout pair and P1's merge, also
     the warps resident per SM and their SASS opcodes: no HMMA or
     HGMMA in any, no atomics in any backward, no spills; the self pair's
     SASS counts beside those it had before its blocks were shared,
     F32_PAIR_SASS_OWN, and every kernel's beside SASS_BEFORE_DT_F32);
  2. flash-attention forward kernel vs its plain version, bf16, at the
     scoring shape (B=8, T=1024, H=12, hs=64, causal, q/k/v strided views of
     the fused QKV output), at a ragged T=1000, at the HellaSwag shape of
     phase 26 (B=32: 8 examples x 4 endings, T=1024) and at B=1, T=8192
     (K1_MAX_T, the plain version four heads at a time); o held elementwise and row by
     row (each row of 64 within 2^-6 of its norm), and a control that must
     fail the row check: the last 128 rows at T=8192 against the plain
     version without their first key tile (the elementwise check's reading
     printed beside it);
  2b. the fp32 flash-attention forward kernel vs its plain version in fp32
     (no TF32 on either side), strided q/k/v views of a fused fp32 QKV, at
     the HellaSwag shape (B=32, T=1024, H=12, causal), at B=8, T=1000 with
     and without the mask, at B=1, T=8192 (the plain version four heads
     at a time) and at B=2, T=1024, H=25 (the 1558M head count): o
     elementwise and lse within 1e-5, each row of o within 2e-5 of its norm
     (``f32_fwd_row_err``); twice on one input bit for bit; two controls at
     T=8192 that must fail the row check (``fwd_controls``: the last 128 rows
     without their first key tile; the kernel's last query tile of 128 rows
     without the diagonal's last key tile of 64); timed beside K1-fwd on the
     same inputs in bf16 and
     F.scaled_dot_product_attention on the fp32 operands (a library probe, as
     in phase 12);
  2c. the fp32 flash-attention backward kernel (csrc/flash_bwd_f32.cu) vs its
     plain version in fp32 on the fp32 forward kernel's o and lse, strided
     q/k/v views of a fused fp32 QKV, at B=8, T=1024, H=12 causal and without
     the mask, B=1, T=8192 (the plain side two heads at a time), B=8, T=1000
     and B=2, T=1024, H=25 (the 1558M head count), on the fp32 forward
     kernel's o and lse: dq, dk and dv within 1e-5 of max|ref| and each row within 2e-5 of its
     norm plus the mean row norm (``f32_row_err``: a causal dq's first row
     is 0 in exact arithmetic), twice on one input bit for bit; both sides
     against the same backward in fp64, printed; two controls that must fail the row rule (dq without the last
     key tile each query sees, dk/dv without the last 64 query rows); timed
     plain, kernel, kernel, plain beside SDPA's backward on the same fp32
     operands;
  3. fused LM-head + CE forward kernel vs its plain version, nll and lse
     within 1e-4, at (N, D, V) = (8192, 768, 50304), (1000, 768, 50304),
     (1000, 768, 50257) (a V no tile width divides) and (1000, 1600, 50304)
     (the 1558M width), targets in the last vocab tile, the kernel twice on
     one input bit for bit; two controls that must fail the check
     (``ce_reference_drop``: 64 vocab columns of one tile left out, at
     N=8192; the ragged tile's padding counted as logits 0, at V=50257), the
     old 2e-3 check's reading printed beside;
  3b. the CE logits-gradient kernel (K4b, csrc/ce_bwd.cu) vs its plain
     version's fp32 P, element by element within 2^-8 + 2^-16 of each value, at
     (N, D, V) = (2048, 768, 50304) (a chunk of the trainer's micro-batch),
     (1000, 768, 50264) (ragged N, a last vocab tile of 88 columns) and
     (1024, 1600, 50304) (the 1558M width), targets in the last tile, rows
     of zero cotangent all zero, the kernel twice on one input bit for bit;
     a control that must fail the check (``ce_bwd_reference_no_onehot``: P
     without the one-hot subtraction); timed beside the plain version with
     bf16 logits, the logits GEMM alone and the dx and dw products;
  4. the scoring forward: GPT-2 124M with seeded random weights, fp32
     params, bf16 policy, train.step.make_eval_step over 2 micro-batches of
     B=8, T=1024; the launch counters must show 12 flash and 1 CE launch per
     micro-batch, and the loss must agree with the plain-path run; one
     micro-batch's device time by kernel class (torch.profiler);
  5. generation: cli.sample, cached-vs-uncached logits under the fp32
     policy, cli.bench_decode at B=50, and ops.layers.matmul_f32 on batched
     bf16 operands of the decode shape against the fp32 product;
  6. flash-attention backward kernel vs its plain version at the training
     shape (B=8, T=1024, H=12, hs=64, causal, strided q/k/v), at T=1000 and
     at B=1, T=8192 (K1_MAX_T, the plain version two heads at a time); dq,
     dk and dv against 3e-2 of max|ref| and row by row (each query row of
     dq, each key row of dk and dv within 2^-6 of its norm plus 1e-3), the
     kernel twice on one input bit for bit; two controls at T=8192 that must
     fail the row check (the plain dk/dv without the queries from
     K1_DKV_DROP_AFTER after each key tile, the plain dq without the keys
     more than K1_DQ_DROP_BEFORE before each query tile; the check against
     max|ref| passes both, its reading printed beside); one attention
     layer's forward + backward through autograd;
  7. AdamW kernel vs its plain version over every parameter of GPT-2 124M,
     its kernel's device time also by torch.profiler (kernels only);
  8. the train step: GPT-2 124M, fp32 params, bf16 policy,
     train.step.make_train_step with the AdamW kernel, 4 x (B=8, T=1024) per
     step, 3 steps; 12 flash forward and 12 flash backward launches per
     micro-batch and 1 AdamW launch per step; then one step at the peak LR
     on each path from one state (loss, grad norm and grads against the
     plain paths; the update against the plain AdamW on the same grads,
     with controls that must fail); K4 and K4b once a micro-batch (ce_chunks
     1); one micro-batch's forward + backward with the CE kernels timed
     beside the plain CE, and under FP32_POLICY no CE kernel launched;
  9. the trainer entry point: cli.pretrain --synthetic for 3 steps of
     64 x 1024 tokens (CSV rows, checkpoints), then --steps 4 resumes at
     step 3 and runs one step;
  9b. the trainer's ProfilerHook (obs/csvlog.py): cli.pretrain --synthetic
     for 3 steps of 8 x 1024 tokens with PROFILE_DIR set and the hook's
     window (1, 1), so the trace opens after step 1 and closes after step 2:
     one Chrome trace, whose kernels include the port's flash_fwd, flash_bwd
     and adamw, with the port's own spans (obs/spans.py) of step 2 beside them;
 10. the general (Tq != Tk, streamed K/V) flash kernels vs their plain
     versions, forward (o, lse) and backward (D, dq, dk/dv), at (B, Tq, Tk)
     = (2, 4096, 4096), (2, 1000, 1000), (2, 64, 2048) causal and not,
     (4, 1, 1500), (2, 777, 1234) causal, (3, 200, 200) without a mask, all
     H=12, and at the long-context shape B=1, T=16384, H=12 against the plain
     versions run two heads at a time; o is held elementwise and row by row
     (each row of 64 within 2^-6 of its norm), dq, dk and dv against 3e-2 of
     max|ref| and row by row (each row within 2^-6 of its norm plus 1e-3),
     the dq and the dk/dv kernels twice on one input bit for bit; four
     controls must fail: the forward's o against the plain version with the
     other mask (T=4096), the last 128 rows against the plain version without
     their last key tile (T=16384), the plain dk/dv without the query rows
     from 4096 after each key tile on and the plain dq without the keys more
     than DQ_DROP_BEFORE before each query tile (T=16384, the row check; the
     check against max|ref| passes the dq control);
 11. the general kernels against the self-attention kernels on the same
     inputs at B=8, T=1024 and B=2, T=4096 (within 1e-2; times and whether
     they are bit-identical only printed);
 12. library-call probes, timed only and never a route of the port:
     F.scaled_dot_product_attention forward and backward (one kernel forms
     dq, dk and dv) at B=8, T=1024, B=1, T=8192 and B=1, T=16384, causal,
     and on the ring's chunk pair, torch.optim.AdamW(fused=True) over the
     148 leaves (also its kernels alone, by torch.profiler);
 13. the long-context train step: GPT-2 124M with block_size 16384,
     make_train_step at B=1, T=16384, 2 micro-batches a step, 3 steps; 12
     general forward, 12 D, 12 dq and 12 dk/dv launches per micro-batch, none
     of the self-attention kernels, 1 AdamW launch a step; then at 2 layers
     and T=8320 one step on the kernel path and on the plain paths from one
     state (loss, grad norm, grads, the update, with controls);
 14. the long-context trainer: cli.pretrain --synthetic --seq-len 16384
     --micro-batch 1 --total-batch 32768 --steps 3 with a synthetic
     HellaSwag file in $HELLASWAG_DIR (validation on the general forward and
     the CE kernel, 'hella' rows, checkpoints), then --steps 4 resumes;
 15. the lse-forward and one-pass backward kernels vs their plain versions,
     q/k/v strided views of a longer tensor as the ring passes them, at
     (B, Tq, Tk) = (1, 4096, 4096) causal and not (the ring's two calls),
     (2, 1000, 1000), (2, 64, 2048) causal and not, (4, 1, 1500), (2, 777,
     1234) causal, (3, 200, 200) without a mask; o held elementwise and row
     by row as in phase 10, with a control that must fail the row check (the
     last 128 rows of the unmasked 4096 pair against the plain version without
     their last key tile); the backward with a random lse cotangent, dq, dk
     and dv also row by row as in phase 10, and a control without the
     cotangent that must disagree; the backward twice on one input (dq is
     summed by reductions in global memory in no fixed order); the general
     kernels timed beside them;
 16. ring attention as an op: 4 chunks at B=1, T=16384, H=12, forward and
     backward through autograd, against the general kernels on the whole
     sequence, 10 + 10 + 10 launches (lse forward, D, one-pass backward) and
     none of any other flash kernel; at T=2048 against the einsum-chunk ring
     and plain attention, with a control (the lse cotangent dropped) that
     must fail;
 17. the ring train step: GPT-2 124M, block_size 16384, make_train_step with
     attn_impl="ring" over a ring of 4, 2 x (B=1, T=16384) a step, 2 steps,
     120 + 120 + 120 launches per micro-batch and none of the other flash
     kernels; then one step from one state on the ring path and on the
     attn_impl="flash" path (loss, grad norm, grads), with a control (merge
     weights dropped) that must fail;
 18. the ring trainer: cli.pretrain --synthetic --seq-len 16384 --micro-batch
     1 --total-batch 32768 --attn-impl ring --tp 4 --steps 2 (validation
     through the ring on the lse forward and the CE kernel, checkpoints), then
     --steps 3 resumes; --tp 4 without --attn-impl ring on one process (Megatron
     TP, which runs over tp processes) must raise;
 10b. (run after 18) the general kernels on fp32 operands
     (csrc/flash_general_fwd_f32.cu: K2b's function; the fp32 D;
     csrc/flash_general_bwd_f32.cu: K3a's and K3b's in one launch) vs their
     plain versions in fp32 at (B, Tq, Tk) = (1, 16384, 16384) causal, (2,
     130, 385) causal and not, (4, 1, 193), (2, 64, 256) and (1, 3000, 4133)
     causal, and (2, 1024, 1024) unmasked, whose 24 heads the backward runs
     in rounds of 16 on the H100's 264 resident blocks, the last round half
     full, H=12 (GENERAL_F32_SHAPES): o and lse within F32_TOL, o row by
     row within F32_ROW_TOL, D, and dq, dk, dv on the kernel's D within
     F32_TOL of max|ref| and row by row (phase 2c's rule); the forward
     kernels twice bit for bit, the backward five times (F32_BWD_RUNS); two
     controls that must fail both row rules: the causal mask aligned at the
     top left at Tq != Tk, and the last key tile dropped at the ragged
     Tk=4133 (``general_hide``); timed at T=16384 beside SDPA on the same
     fp32 operands;
 15b. the lse kernels on fp32 operands (K2a's function on
     csrc/flash_lse_fwd_f32.cu, each query tile's key range split into the
     parts ops/flash_attention.lse_f32_parts picks and merged in part order;
     K3c's on csrc/flash_general_bwd_f32.cu) on the ring's chunk pairs (B=1,
     Tq=Tk=4096, H=12, chunk views, unmasked and causal) and a pair whose
     parts are uneven (Tq=1000, Tk=4133 causal, LSE_F32_SHAPES), with a
     random lse cotangent (dcap = D - dlse), under phase 10b's rules, both
     kernels five times bit for bit (F32_BWD_RUNS), two controls that must
     fail: the backward without the cotangent, and the forward against the
     split's plain version with each split query tile's last part left out
     of its merge (``lse_dropped_part``); the ring pairs timed beside SDPA;
 13b. the long-context train step under FP32_POLICY: GPT-2 124M, block_size
     16384, 2 x (B=1, T=16384) a step, attn_impl auto, 2 steps: 24 launches
     each of the fp32 general forward, the fp32 D and the fp32 general
     backward a step, none of the bf16 kernels (so no plain attention);
     tokens/s and peak memory; at 2 layers and T=8320 one step on the kernel
     path against the plain paths from one state (loss within 1e-4, grad norm
     and grads within 1e-4 relative, the update against the plain AdamW);
 17b. the ring train step under FP32_POLICY, a ring of 4: 240 launches each
     of K2a's and K3c's fp32 kernels and the fp32 D a step, none of any
     other flash kernel; tokens/s, peak memory; one step from one state
     against phase 13b's whole-sequence fp32 step on the same batch (loss,
     grad norm and grads within 1e-4), with a control (merge weights
     dropped) that must fail;
 18b. train.pretrain.run_pretrain(cfg, device="cuda", policy=FP32_POLICY,
     max_steps_override=2) with cfg from cli.pretrain --synthetic --seq-len
     16384 --micro-batch 1 --total-batch 32768 --attn-impl flash, then
     --attn-impl ring --tp 4: launch counts, CSV rows, finite losses;
 19. the dt-layout kernels of the A/B tool vs their plain versions, H=12,
     hs=64, causal: the forward (o elementwise and row by row, lse) on the
     tool's own bf16 inputs (B=8, T=1024), at B=3, T=1088 (sequences that end
     in half a 128-row tile), at B=2, Tq=512, Tk=1024 (the mask without
     offset) and at B=1, T=8192 (the plain version four heads at a time),
     with a control there that must fail the row check (the last 128 rows
     without their first key tile), and at B=8, T=1024 against the shipping
     forward's output transposed; the backward at the same four shapes on
     the forward's o and lse, dq, dk and dv against 3e-2 of max|ref| and row
     by row (each position's 64 channels within 2^-6 of its norm plus 1e-3;
     the plain side two heads at a time at T=8192), twice on one input bit
     for bit, a control (wrong dcap) that must fail, and two controls at
     T=8192 that must fail the row check (``dt_dkv_reference`` without the
     queries from K1_DKV_DROP_AFTER after each key tile, ``dt_dq_reference``
     without the keys more than K1_DQ_DROP_BEFORE before each query tile),
     the check against max|ref| printed beside;
 19b. the dt-layout kernels on fp32 operands (csrc/flash_dt_fwd_f32.cu,
     P1 on a one-dimensional grid split over its key range where the grid is
     short, and flash_dt_bwd_f32.cu, P2 on the one-pass block's DT case) vs
     their plain versions in fp32 (no TF32), H=12, hs=64, at P1's four
     shapes of phase 19, causal, B=2, T=1024 unmasked, whose backward
     runs whole (b, h) in rounds, and B=2 causal at Tq=1024, Tk=512 and
     Tq=2048, Tk=1024, whose query tiles past Tk see every key
     (DT_F32_SHAPES), each with the parts P1
     takes (tools/ab_dt_flash.py dt_f32_parts) printed and P1's merge
     launched with every forward where it takes several, with none where
     it takes one (``launches_f32_merge``): o and lse
     within 1e-5 and each row of o within 2e-5 of its norm (phase 2b's
     rules); on the kernel's o, lse and dcap, dq, dk and dv within 1e-5 of
     max|ref| and each row within 2e-5 of its norm plus the mean row norm
     (phase 2c's); the forward and the backward five times
     (F32_BWD_RUNS) on one input bit for bit; controls that must fail those
     row rules: at every shape that P1 splits, its merge without each split
     query tile's last part (``dt_dropped_part``); at T=8192 phase 19's
     three (the last 128 rows without their first key tile,
     ``dt_dkv_reference``, ``dt_dq_reference``), and at Tq=512, Tk=1024 the causal mask
     right-aligned (``dt_f32_masked``: the general kernels' rule, o and the
     gradients); timed plain, kernel, kernel, plain at the tool's B=8,
     T=1024 beside SDPA's forward and whole backward on the fp32 operands;
 20. the A/B tool through its main in both dtypes (--dtype fp32, the TPU
     tool's check dtype and limits, 2e-5 and 1e-5; --dtype bf16, 2e-2 and
     3e-2): --check, --check-bwd, the forward bench and --bwd (device ms per
     layer of the shipping path, of the dt kernels, and of the copies into
     and out of the dt layout), then --check and --check-bwd at their
     default dtype, fp32; the launch count of each of the four dt kernels
     exact;
 21. the self-attention kernels against the plain path at the fine-tune shape
     (B=128, T=65), o, dq, dk and dv also row by row, forward and forward +
     backward:
     below the 512-token routing threshold, timed only, the routing is the
     JAX package's;
 22. fine-tune ops on the card under the bf16 policy against the same
     functions on the CPU in fp32 (pooling, each bridge, the gated
     cross-attention block, the caption / cross-attention loss with the CE
     kernel and with the plain CE); one optimizer step of each fine-tune at
     full depth: frozen leaves bit-identical and without .grad, trainable
     leaves moved, the AdamW kernel's leaf table holding exactly the
     trainable leaves, and the same step on the plain update from one state;
 23. the fine-tune entry points at full width: cli.finetune_linear,
     finetune_qformer and finetune_xattn --synthetic --steps 3 (B=128, T=32
     after a 33- or 32-token prefix, 128 / 128 / 1 micro-batches a step,
     validation on the CE kernel, CIDEr over the 64 synthetic val images,
     checkpoints), evaluate_captions called directly, frozen leaves
     bit-identical to the seeded init; then --steps 4 resumes the
     cross-attention run;
 24. the top-p samplers at (50, 50304) on logits of the 124M lm_head over
     seeded hidden states: top_p_keep_mask at ways=2 and 8 bit-equal, equal
     to the sorted kept set except on rows whose boundary mass lies within
     1e-5 of p (counted), a dyadic tie row equal to the sorted set with a
     control (the tie rule dropped) that must differ; one call of each
     sampler timed, wall and device;
 25. decode: cli.bench_decode at B=50 with --topp-ways 2 (phase 5's run) and
     8, and at --batch 1 with --uncached-baseline; captions/s beside the card;
 26. cli.eval_quality at GPT-2 124M full width and depth from seeded weights,
     on files written here: HellaSwag (16 examples, contexts of 520-900
     tokens, every batch padded to 1024) from a reference .pt and an HF
     directory at --policy bf16 (2 x 12 K1-fwd launches each, equal counts;
     K1-fwd at this shape is held against its plain version in phase 2);
     from the reference .pt at the default --policy fp32: 2 x 12 launches of
     the fp32 forward kernel (held in phase 2b), none of K1-fwd, and against
     the same run on the plain path (the router's threshold lifted) the
     per-ending losses within 1e-4 and the predictions equal wherever the
     two lowest endings are more than 2e-4 apart; the router
     (ops/attention.sdpa) on fp32 q at T=1024 runs the fp32 kernel without
     a gradient, and the fp32 forward and backward kernels with one (dq
     within 1e-5 of the plain path's); CIDEr and
     METEOR from a linear and a Q-Former GPT_Caption .pt at bf16, the served
     Q-Former's query_tokens fp32;
 27. the CLIP encoder at full width: ViT-L/14 (width 1024, 24 layers, 16
     heads, 257 tokens) from seeded random weights at B=64, uint8 images of
     four sizes made on the card, put through preprocess there, then
     features under the bf16 policy (no kernel launched: CLIP's attention is
     plain in both packages); preprocess and features under the fp32 policy
     on the card against the CPU at B=2; images/s, peak memory, device time
     by kernel class and the bound; then, printed only, K1-fwd non-causal at
     (B=64, T=257, H=16) against the encoder's plain attention on the same
     operands;
 28. the two entry points at full width: cli.extract_clip_features
     --variant vit-l-14 on a synthetic COCO layout of 96 JPEGs of four sizes
     (--batch 32 --rows-per-shard 40: shards of 40, 40 and 16 rows), its rows
     read back through data/coco.CocoClipTokensDataset equal to features of
     the same crops cast to float16; cli.caption on 4 of them at vit-l-14
     with a random linear and a random Q-Former bridge (24 new tokens), and
     at vit-b-16 with phase 23's linear fine-tune checkpoint as --gpt-ckpt
     and --bridge-ckpt. Where PIL does not import, a line says so and the
     CLIs' device steps (everything after the JPEG decode) run on numpy uint8
     crops;
 29. the train step under FP32_POLICY: GPT-2 124M, 2 x (B=8, T=1024), the
     kernel path (12 fp32 forward and 12 fp32 backward launches per
     micro-batch, no bf16 K1 launch, one AdamW launch) against the plain path
     from one state: loss within 1e-4, grad norm within 1e-4 relative, grads
     within 1e-4 relative L2; tokens/s of both;
 30. K1-fwd and K1-bwd (bf16) at the head counts of 350M, 774M and 1558M (H=16,
     20, 25; B=4, T=1024) against their plain versions under phases 2 and 6's
     rules (o, dq, dk and dv also row by row), timed;
 31. GPT-2 1558M at full width and depth: (a) the state's bytes under each
     memory recipe (utils/trees, on the meta device); (b) the peak device
     memory of one micro-batch step (B=8, T=1024; B=4 too without a recipe)
     under each stack of BIG_STACKS, and of 774M without a recipe and with
     full remat: the least stack that fits, which FIT_1CHIP's rows are written
     from, the table's 1558M stack required to fit; (c) cli.pretrain --model
     1558M --fit-1chip --synthetic for 3 steps of 2 micro-batches (tokens/s,
     peak memory; K1-bwd 48 launches a micro-batch, K1-fwd 96 where the stack
     recomputes the forward, else 48); (d) at 2 layers of the 1558M width, the
     layerwise backward and each remat mode against the standard step (loss
     1e-2, grad norm 2%, grads 2e-2), and two updates with 8-bit moments, bf16
     moments and bf16 params on the card against the same on the CPU (3e-2);
     (e) 2 trainer steps with --opt-state-dtype int8, then a resume with
     bfloat16 that ends with bf16 moments.

Phases 32-36, the parallel styles: processes that share cuda:0 over gloo
(gpt2_vision_language_tpu_torch/tools/dist_worker.py, one JSON job list a
launch), each step held by rank 0 against the one-process step it runs
first from the same seeded state on the same rows, at the schedule's peak
LR (``PAR_LIMITS``: loss 1e-2, grad norm 2%, grads 2e-2 relative L2, the
clip norm within 1e-4 of its own gathered grads' norm, the update within
1e-3 of the plain AdamW replayed on its gathered grads; the ring's loss
5e-3), and each rank's launch counts exact (the command lines of 32b and 33b
run side by side, as 37b and the dry run of 40 do, to keep the script
within its time):
 32. DP over 2 ranks, GPT-2 124M, bf16: 2 micro-batches of (B=8, T=1024) a
     rank, phase 8's 32 rows (12 + 12 K1 a micro-batch, 1 K5 a rank); a
     control that skips the grad all-reduce must fail; then python -m
     torch.distributed.run --nproc_per_node 2 -m ...cli.pretrain --synthetic
     --devices 2 --device cuda:0 --val-every 0 --steps 1 at 2 layers
     (``CUT_LAYERS``), and --steps 2 resumes;
 33. Megatron TP=2 (6 heads a rank), then TP=2 with sequence parallelism,
     2 layers of 124M, 4 x (B=8, T=1024); K1 at H=6, 8 + 8 a rank; one
     validation micro-batch through K4 on the gathered wte (2 K1-fwd, 1 K4,
     its loss within 1e-2);
 34. TP=4 at the 1558M width (n_embd 1600, 25 heads: 7, 6, 6, 6 a rank), 2
     layers, 2 x (B=2, T=1024); a control whose clip norm counts the
     replicated leaves 4 times must fail;
 35. the ring over 4 processes in the JAX trainer's placement, 124M, 2 x
     (B=1, T=16384): each rank its Megatron shards of the params and
     moments (3 heads; the bytes of each rank equal ``megatron_bytes``, the
     whole model on every rank must fail that check), each attention's heads
     swapped for a T/4 chunk of every head by an all-to-all around the ring
     (K/V hops and swaps through pinned host memory, 240 a rank): rank r
     launches K2a, D and K3c 24 (r + 1) times, 240 each in all, as the
     one-process ring; at 2 layers and T=4096 (a chunk of 1024 a rank): 35b
     with sequence parallelism, 35c with the layerwise backward (K2a
     8 (r + 1), D and K3c 4 (r + 1)), 35d with sequence parallelism at the
     1558M width (7, 6, 6, 6 heads), 35e under FP32_POLICY (the fp32 K2a and
     K3c, the latter's cooperative grid with four processes on the card;
     limits 1e-4); two controls must fail: the all-to-all's backward as the
     identity on the rank's own block, and the ring's merge without its
     weights;
 36. DP fine-tunes (linear, Q-Former with its dropout) over 2 ranks of 64
     rows, the preset's 128 in all, 2 micro-batches, 12 layers.

Prints the card's name and power limit, one JSON line with each kernel's
launches (from the trainer runs of phases 9, 14 and 18, the tool's run of
phase 20 (both dtypes) and, for the fp32 forward kernel, phase 26's fp32
HellaSwag run,
for the fp32 backward kernel phase 29's fp32 train step, for the fp32
general and lse kernels the fp32 trainer runs of phase 18b;
the fine-tune runs of phase 23 and the HellaSwag runs of phase 26 beside
them, and each rank's of phases 32-35), error, times, bound and library-call
time, one {"parallel": ...} line (each run's readings, seconds and peak GiB
per rank, tokens/s of phases 32 and 35), the whole run's seconds,
and last {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device.

With --flash-times it only builds the kernels, counts each one's SASS
instructions and times K1-fwd (with the host side of its launch), K1-bwd,
P1, K2a, K2b, K3a, K3b and K3c at the shapes of the kernels line, P2 at
B=8, T=1024 and B=1, T=8192, the fp32 pair (forward at B=32, T=1024 and
B=1, T=8192, backward at B=8, T=1024 and B=1, T=8192, SDPA on the same fp32
operands beside them), the fp32 general and lse kernels (K2b's function,
the fp32 D and the fp32 general backward at B=1, T=16384; K2a's (the split
kernel) and K3c's on the ring's chunk pair; SDPA and each one's bound beside
them;
``f32_general_times``), P1 and P2 on fp32 operands at B=8, T=1024 and B=1,
T=8192 beside the fp32 K1 pair and SDPA on the same values, P1 fp32 also
at phase 19b's shapes and the A/B tool's --check shape, and where the
checkout splits it, the parts it takes, its times with 1-8 parts forced and
its launch and merge counts (``dt_f32_times``), K4 at N=8192 and
4096 and the logits GEMM alone (``flash_times``), and fails if a kernel's
SASS instruction count moved from SASS_BEFORE_DT_F32. Copied into the root of another checkout and
run there, it times that checkout's kernels, so two trees compare on one
card in the order parent, change, change, parent.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# cycles of the kernel that holds the card while a timed loop is enqueued:
# about 50 ms at the H100's clock, longer than the host takes to enqueue any
# loop timed here
HOLD_CYCLES = 100_000_000


def cuda_ms(fn, iters):
    """Mean device milliseconds of fn() over iters launches (after one
    warm-up), from CUDA events. The loop is enqueued behind a kernel that
    holds the card, so the launches run back to back and the host's time per
    launch, which for a 0.06-0.08 ms kernel can be as long as the kernel
    (53-90 us through flash_attention on an H100 host), is not in the
    reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved(kernel_fn, plain_fn, iters_kernel, iters_plain):
    """plain, kernel, kernel, plain; returns (kernel ms, plain ms), each the
    mean of its two runs."""
    p1 = cuda_ms(plain_fn, iters_plain)
    k1 = cuda_ms(kernel_fn, iters_kernel)
    k2 = cuda_ms(kernel_fn, iters_kernel)
    p2 = cuda_ms(plain_fn, iters_plain)
    print(f"  timings ms: plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, "
          f"plain {p2:.4f}", flush=True)
    return (k1 + k2) / 2, (p1 + p2) / 2


def profiled_kernel_ms(torch, fn, iters=5):
    """(device ms of the kernels one call of fn() launches, {kernel class:
    ms}, the three longest kernels as (name, ms, launches)), each the mean
    over `iters` calls under torch.profiler, kernels only: copies and
    memsets are left out, so a call's wait for a pageable copy is not in it,
    and so are ranges on the device's timeline that name no kernel (the
    optimizer's "Optimizer.step#AdamW.step" spans its kernels and would count
    them twice). Classes as ``cli.profile_step`` names them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpt2_vision_language_tpu_torch.cli.profile_step import classify

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_class, kernels = {}, []
    for ev in prof.key_averages():
        us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        cls = classify(ev.key)
        if (ev.device_type != DeviceType.CUDA or us <= 0 or cls == "memcpy/memset"
                or getattr(ev, "is_user_annotation", False) or ev.key.startswith("Optimizer.")):
            continue
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / iters
        kernels.append((ev.key[:80], us / 1e3 / iters, ev.count / iters))
    total = sum(by_class.values())
    require(total > 0, "torch.profiler recorded no device time")
    return (total, dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            sorted(kernels, key=lambda k: -k[1])[:3])


def fwd_by_heads(torch, fa, q, k, v, causal, heads=4):
    """The plain forward, `heads` heads at a time (its (B, H, T, T) fp32
    scores do not fit at once at T=8192, H=12): (o, lse)."""
    parts = [fa.flash_attention_reference(q[:, :, i:i + heads], k[:, :, i:i + heads],
                                          v[:, :, i:i + heads], causal=causal)
             for i in range(0, q.shape[2], heads)]
    return torch.cat([p[0] for p in parts], dim=2), torch.cat([p[1] for p in parts], dim=1)


def phase_flash(torch, fa, dev):
    print("[2] flash-attention forward vs plain (bf16)", flush=True)
    lse_tol = 1e-3  # fp32 softmax stats
    g = torch.Generator(dev).manual_seed(0)
    errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0}
    timing = None
    # the scoring shape, a ragged T, the HellaSwag forward's (phase 26: 8
    # examples x 4 endings padded to 1024), and K1_MAX_T, where the late rows'
    # |o| is smallest (the plain version four heads at a time)
    for b, t in ((8, 1024), (8, 1000), (32, 1024), (1, fa.K1_MAX_T)):
        h, hs = 12, 64
        qkv = torch.randn(b, t, 3 * h * hs, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ro, rlse = fwd_by_heads(torch, fa, q, k, v, True)
        torch.cuda.synchronize()
        eo, excess = out_excess(o, ro)
        erow, row_over = row_excess(o, ro)
        el = (lse - rlse).abs().max().item()
        print(f"  B={b} T={t} H={h} hs={hs}: out max|err| {eo:.3e} (tol 2e-2 or one bf16 ulp), "
              f"max row |err| / |ref| {erow:.3e} (tol 2^-6), lse max|err| {el:.3e} "
              f"(tol {lse_tol})", flush=True)
        require(excess <= 0 and row_over <= 0 and el <= lse_tol, f"flash T={t} disagrees")
        errs["o"], errs["lse"] = max(errs["o"], eo), max(errs["lse"], el)
        errs["o_row"] = max(errs["o_row"], erow)
        if t == fa.K1_MAX_T:
            # control: the last 128 rows as a kernel whose sweep starts one key
            # tile late would give them (keys 128 on); the row check must fail
            # it where the late rows' |o| is smallest. The elementwise check,
            # whose 2e-2 floor is above a typical late |o| (0.012), passes it
            # on one head and catches it on twelve only narrowly (by 4.6e-3
            # to 6.5e-3 on an H100): its reading is printed beside
            r = slice(t - 128, t)
            late = fa.flash_attention_reference(q[:, r], k[:, 128:], v[:, 128:], causal=True)[0]
            _, control = row_excess(o[:, r], late)
            _, loose = out_excess(o[:, r], late)
            print(f"  control: the last 128 rows without their first key tile pass the row "
                  f"tolerance by {control:.3e} (must be > 0), the elementwise one by "
                  f"{loose:.3e}", flush=True)
            require(control > 0, "K1-fwd's o passed the row check against o without the first "
                    "key tile: the check cannot see a late start of the key sweep")
            errs["o_control"], errs["o_control_elementwise"] = control, loose
        if (b, t) == (8, 1024):
            timing = interleaved(
                lambda: fa.flash_attention(q, k, v, causal=True),
                lambda: fa.flash_attention_reference(q, k, v, causal=True),
                50, 5,
            )
        del q, k, v, qkv, o, ro
    return errs, timing


# phase 2b's tolerances, the fp32 kernel against the plain fp32 version, which
# sum in fp32 in other orders: o elementwise and lse, absolute; each row of o
# relative to its norm. A late row at T=8192 sums 8192 terms about 40 times
# larger than their sum: a numpy model of the kernel's order read 1.2e-6 to
# 1.8e-6 of the row's norm against fp64, and the plain version has its own
F32_TOL, F32_ROW_TOL = 1e-5, 2e-5
# the fp32 forward kernel's query rows a block and keys a tile
# (csrc/flash_fwd_f32.cu): its causal diagonal spans F32_FWD_BQ / F32_FWD_BK
# key tiles, which the diagonal control of phase 2b stands for
F32_FWD_BQ, F32_FWD_BK = 128, 64


def f32_fwd_row_err(o, ref):
    """Phase 2b's row rule: max over the rows of hs values of |o - ref| /
    |ref| (held to F32_ROW_TOL)."""
    return ((o - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def masked_fwd_reference(torch, q, k, v, rows, hide, heads=4):
    """o of the plain forward, softmax(q k^T / sqrt(hs)) v in the operands'
    dtype, for the query rows ``rows`` (a slice) over every key, with the
    (rows, Tk) bool mask ``hide`` over the keys a row does not see, ``heads``
    heads at a time: the fp64 evaluation (on fp64 operands) and the controls
    of phase 2b."""
    hs = q.shape[-1]
    outs = []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows, c], k[:, :, c]) * hs**-0.5
        p = torch.softmax(s.masked_fill(hide, float("-inf")), dim=-1)
        del s
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v[:, :, c]))
    return torch.cat(outs, dim=2)


def fwd_controls(torch, q, k, v, bq=F32_FWD_BQ, bk=F32_FWD_BK):
    """{name: (rows, o the plain forward gives them with a fault)} at a causal
    T: "late", the last 128 rows without their first key tile (a key sweep
    that starts one tile late); "diagonal", the rows of the last query tile of
    ``bq`` rows without the diagonal's last key tile of ``bk`` keys (a sweep
    that stops one tile short where the diagonal spans bq / bk tiles). A
    kernel's o must fail the row rule against both."""
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    late, diag = slice(t - 128, t), slice((t - 1) // bq * bq, t)
    hide_late = (pos[None, :] > pos[late, None]) | (pos[None, :] < 128)
    hide_diag = (pos[None, :] > pos[diag, None]) | (pos[None, :] >= (t - 1) // bk * bk)
    return {"late": (late, masked_fwd_reference(torch, q, k, v, late, hide_late)),
            "diagonal": (diag, masked_fwd_reference(torch, q, k, v, diag, hide_diag))}


def phase_flash_f32(torch, fa, dev):
    print("[2b] flash-attention forward on fp32 operands vs plain (fp32, no TF32)", flush=True)
    import torch.nn.functional as F

    g = torch.Generator(dev).manual_seed(27)
    errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0}
    timing = {}
    # the HellaSwag forward's shape at fp32 (phase 26), a ragged T with and
    # without the mask, K1_MAX_T, the 1558M head count
    for b, t, h, causal in ((32, 1024, 12, True), (8, 1000, 12, True), (8, 1000, 12, False),
                            (1, fa.K1_MAX_T, 12, True), (2, 1024, 25, True)):
        hs = 64
        qkv = torch.randn(b, t, 3 * h * hs, device=dev, generator=g)
        q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        o2, lse2 = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ro, rlse = fwd_by_heads(torch, fa, q, k, v, causal)
        torch.cuda.synchronize()
        eo = (o - ro).abs().max().item()
        erow = f32_fwd_row_err(o, ro)
        el = (lse - rlse).abs().max().item()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        print(f"  B={b} T={t} H={h} hs={hs} {'causal' if causal else 'no mask'}: out max|err| "
              f"{eo:.3e} (tol {F32_TOL}), max row "
              f"|err| / |ref| {erow:.3e} (tol {F32_ROW_TOL}), lse max|err| {el:.3e} (tol "
              f"{F32_TOL}); o {o.dtype}; bit-equal twice: {same}", flush=True)
        require(o.dtype == torch.float32 and max(eo, el) <= F32_TOL and erow <= F32_ROW_TOL,
                f"the fp32 flash forward disagrees at B={b} T={t} H={h}")
        require(same, f"the fp32 flash forward is not bit-equal on one input at T={t}")
        errs["o"], errs["lse"] = max(errs["o"], eo), max(errs["lse"], el)
        errs["o_row"] = max(errs["o_row"], erow)
        if t == fa.K1_MAX_T:
            # controls: the last 128 rows without their first key tile, as a
            # kernel whose key sweep starts one tile late would give them; the
            # last query tile without the diagonal's last key tile, as one
            # whose sweep stops a tile short would
            ctrl = fwd_controls(torch, q, k, v)
            rows, late = ctrl["late"]
            control = f32_fwd_row_err(o[:, rows], late)
            loose = (o[:, rows] - late).abs().max().item()
            rows, diag = ctrl["diagonal"]
            control_diag = f32_fwd_row_err(o[:, rows], diag)
            print(f"  control: the last 128 rows without their first key tile read max row "
                  f"|err| / |ref| {control:.3e} (must be > {F32_ROW_TOL}), max|err| "
                  f"{loose:.3e}; the last query tile ({F32_FWD_BQ} rows) without the "
                  f"diagonal's last key tile ({F32_FWD_BK} keys) {control_diag:.3e} (must be "
                  f"> {F32_ROW_TOL})", flush=True)
            require(control > F32_ROW_TOL, "the fp32 kernel's o passed the row check against "
                    "o without the first key tile")
            require(control_diag > F32_ROW_TOL, "the fp32 kernel's o passed the row check "
                    "against o without the diagonal's last key tile")
            errs["o_control_row"], errs["o_control_elementwise"] = control, loose
            errs["o_control_diagonal_row"] = control_diag
            del ctrl, late, diag
        if (b, t) == (32, 1024):
            timing["f32"] = interleaved(
                lambda: fa.flash_attention(q, k, v, causal=True),
                lambda: fa.flash_attention_reference(q, k, v, causal=True), 20, 3)
            qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
            timing["bf16_ms"] = cuda_ms(lambda: fa.flash_attention(qb, kb, vb, causal=True), 20)
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            timing["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 20)
            bound = attention_bound("fwd", b, t, t, h, hs, True, elem_bytes=4,
                                    peak=PEAK_FP32_FLOPS)
            print(f"  B=32 T=1024: fp32 kernel {timing['f32'][0]:.4f} ms (bound "
                  f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / timing['f32'][0]:.1%}), plain "
                  f"{timing['f32'][1]:.4f} ms, K1-fwd on the same inputs in bf16 "
                  f"{timing['bf16_ms']:.4f} ms, SDPA on the fp32 operands "
                  f"{timing['sdpa_ms']:.4f} ms", flush=True)
            del qb, kb, vb
        del q, k, v, qkv, o, o2, ro
    return errs, timing


def masked_bwd_reference(torch, q, k, v, do, lse, dd, hide, heads=2):
    """(dq, dk, dv) of the plain backward in fp32 on the forward's lse and D
    with the (Tq, Tk) bool mask ``hide`` over the keys a query does not see,
    ``heads`` heads at a time: the plain version that phase 2c's controls
    bend (a pair that ``hide`` drops adds nothing to dq, dk or dv)."""
    hs = q.shape[-1]
    dqs, dks, dvs = [], [], []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        q32, k32, v32, do32 = (a[:, :, c].float() for a in (q, k, v, do))
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * hs**-0.5
        p = torch.exp(s.masked_fill(hide, float("-inf")) - lse[:, c, :, None])
        del s
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do32))
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", do32, v32) - dd[:, c, :, None])
        del p
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, k32) * hs**-0.5)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, q32) * hs**-0.5)
        del ds
    return [torch.cat(x, dim=2) for x in (dqs, dks, dvs)]


def f64_bwd(torch, q, k, v, o, lse, do, heads=2):
    """The plain backward of causal attention in fp64 on the given (fp32)
    inputs, the forward's o and lse included, ``heads`` heads at a time: what
    both fp32 sides of phase 2c would give without rounding."""
    tq, hs = q.shape[1], q.shape[-1]
    hide = torch.ones(tq, tq, dtype=torch.bool, device=q.device).triu(1)
    dqs, dks, dvs = [], [], []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        q64, k64, v64, do64, o64 = (a[:, :, c].double() for a in (q, k, v, do, o))
        s = (torch.einsum("bqhd,bkhd->bhqk", q64, k64) * hs**-0.5).masked_fill(hide, float("-inf"))
        p = torch.exp(s - lse[:, c, :, None].double())
        del s
        dd = (do64 * o64).sum(-1).transpose(1, 2)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do64))
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", do64, v64) - dd[..., None])
        del p
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, k64) * hs**-0.5)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, q64) * hs**-0.5)
        del ds
    return [torch.cat(x, dim=2) for x in (dqs, dks, dvs)]


def f32_row_err(x, ref, causal_dq=False, floor=None):
    """max over the rows of hs values of |x - ref| / (|ref| + floor), for
    each query row of dq and each key row of dk and dv; ``floor`` defaults to
    the mean row norm of ref. Phase 2b's rule (the forward's rows, floor 0)
    cannot hold a backward's rows alone: a dq row is a sum of dS_ij k_j whose
    dS sum to 0 over the row, so its norm can be far below its terms', and
    any fp32 evaluation of it carries their rounding (on an H100 one dq row
    at B=8, T=1024 read 3.6e-5 of its norm against the plain version, whose
    own row read 5.2e-5 against fp64 where the kernel's read 1.6e-5; the dk
    and dv rows 5.6e-7). With ``causal_dq`` the first query row, which sees one
    key and is 0 in exact arithmetic, is left to the elementwise rule."""
    if causal_dq:
        x, ref = x[:, 1:], ref[:, 1:]
    norms = ref.norm(dim=-1)
    if floor is None:
        floor = norms.mean()
    return ((x - ref).norm(dim=-1) / (norms + floor)).max().item()


def phase_flash_bwd_f32(torch, fa, dev):
    print("[2c] flash-attention backward on fp32 operands vs plain (fp32, no TF32)", flush=True)
    g = torch.Generator(dev).manual_seed(29)
    errs = {"max_rel": 0.0, "row": 0.0}
    timing = {}
    # the training shape of an fp32 step, K1_MAX_T (the plain side two heads
    # at a time), a ragged T, the 1558M head count, and no mask
    for b, t, h, causal in ((8, 1024, 12, True), (1, fa.K1_MAX_T, 12, True),
                            (8, 1000, 12, True), (2, 1024, 25, True), (8, 1024, 12, False)):
        hs = 64
        qkv = torch.randn(b, t, 3 * h * hs, device=dev, generator=g)
        q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
        do = torch.randn(b, t, h, hs, device=dev, generator=g)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        n0 = fa.flash_bwd_f32_cuda.launches
        got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
        again = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        require(fa.flash_bwd_f32_cuda.launches == n0 + 2, "the fp32 backward kernel did not run")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        want = bwd_by_heads(torch, fa, q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        rels, rows = f32_bwd_errs(got, want, causal)
        bare = [f32_row_err(x, r, causal_dq=causal and i == 0, floor=0.0)
                for i, (x, r) in enumerate(zip(got, want))]
        print(f"  B={b} T={t} H={h} {'causal' if causal else 'no mask'}: dq, dk, dv max|err| / "
              f"max|ref| " + ", ".join(f"{e:.3e}" for e in rels) + f" (tol {F32_TOL}), max row "
              f"|err| / (|ref| + mean row norm) " + ", ".join(f"{r:.3e}" for r in rows)
              + f" (tol {F32_ROW_TOL}; / |ref| alone " + ", ".join(f"{r:.3e}" for r in bare)
              + f"); {got[0].dtype}; bit-equal twice: {same}", flush=True)
        require(all(x.dtype == torch.float32 for x in got), "the fp32 backward is not fp32")
        require(same, f"two runs of the fp32 backward differ at T={t}")
        require(max(rels) <= F32_TOL and max(rows) <= F32_ROW_TOL,
                f"the fp32 flash backward disagrees at B={b} T={t} H={h}")
        errs["max_rel"], errs["row"] = max(errs["max_rel"], *rels), max(errs["row"], *rows)
        if (b, t, h, causal) == (8, 1024, 12, True):
            # both sides against fp64 (forward and backward recomputed in fp64
            # from the same fp32 inputs), printed: which side the difference is
            truth = f64_bwd(torch, q, k, v, o, lse, do)
            errs["vs_fp64_row"] = {
                side: [f32_row_err(x.double(), r, causal_dq=i == 0, floor=0.0)
                       for i, (x, r) in enumerate(zip(xs, truth))]
                for side, xs in (("kernel", got), ("plain", want))}
            print(f"  against the same backward in fp64 on the same inputs, max row |err| / "
                  f"|ref| of dq, dk, dv: kernel "
                  + ", ".join(f"{e:.3e}" for e in errs["vs_fp64_row"]["kernel"]) + "; plain "
                  + ", ".join(f"{e:.3e}" for e in errs["vs_fp64_row"]["plain"]), flush=True)
            del truth
            # controls: dq without the last key tile each query sees (its
            # diagonal tile), and dk/dv without the late query rows (the last
            # 64); the row rule must fail both
            dd = fa.rowdot_reference(do, o)
            qpos = torch.arange(t, device=dev)[:, None]
            kpos = torch.arange(t, device=dev)[None, :]
            causal_hide = kpos > qpos
            cq = masked_bwd_reference(torch, q, k, v, do, lse, dd,
                                      causal_hide | (kpos >= qpos // 64 * 64))[0]
            ckv = masked_bwd_reference(torch, q, k, v, do, lse, dd,
                                       causal_hide | (qpos >= t - 64))[1:]
            controls = {"dq_without_last_key_tile": f32_row_err(cq, want[0], causal_dq=True),
                        "dkv_without_late_queries": max(f32_row_err(x, r)
                                                        for x, r in zip(ckv, want[1:]))}
            del cq, ckv
            print(f"  controls (max row |err| / (|ref| + mean row norm), must be > {F32_ROW_TOL}): "
                  + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in controls.items()), flush=True)
            require(all(v_ > F32_ROW_TOL for v_ in controls.values()),
                    "a control passed the fp32 backward's row check")
            errs["controls"] = controls
            timing["f32"] = interleaved(
                lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
                lambda: fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal=True),
                10, 2)
            # the library's backward on the same fp32 operands: autograd.grad of
            # q, k and v through SDPA (no TF32: main() turned it off)
            import torch.nn.functional as F

            leaves = [a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            dot = do.transpose(1, 2)
            timing["sdpa_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, dot,
                                                                    retain_graph=True), 10)
            bound = attention_bound("bwd", b, t, t, h, hs, True, elem_bytes=4,
                                    peak=PEAK_FP32_FLOPS)
            print(f"  B=8 T=1024 H=12: fp32 backward {timing['f32'][0]:.4f} ms (bound "
                  f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / timing['f32'][0]:.1%}), plain "
                  f"{timing['f32'][1]:.4f} ms, SDPA's backward on the fp32 operands "
                  f"{timing['sdpa_ms']:.4f} ms", flush=True)
            del leaves, out
        del q, k, v, qkv, do, o, lse, got, want
    return errs, timing


# phase 3's shapes (N, D, V): the validation micro-batch of 124M, a ragged
# N, a V that no tile width divides (targets in its ragged last tile), and
# the 1558M preset's width (25 chunks of 64)
CE_SHAPES = ((8192, 768, 50304), (1000, 768, 50304), (1000, 768, 50257), (1000, 1600, 50304))
CE_TOL, CE_OLD_TOL = 1e-4, 2e-3  # nll and lse, absolute; the check before it was 2e-3


def ce_reference_drop(torch, x, w, targets, drop_cols=None, pad_zeros=0, n_chunks=8):
    """``ops.fused_ce.ce_forward_reference``'s (nll, lse) with one of two
    faults a CE kernel could make, the controls of phase 3's check:
    ``drop_cols`` (a slice of vocab columns) leaves those logits out of the
    logsumexp, as a kernel that loses a wgmma N-range or half a tile would;
    ``pad_zeros`` counts that many more logits of value 0, the rows of w past
    V that a TMA box zero-fills in a ragged last tile, left unmasked. The
    gold logit is the true one either way. With neither, the plain version's
    arithmetic, bit for bit."""
    from gpt2_vision_language_tpu_torch.ops.layers import matmul_f32

    nll, lse = [], []
    for xc, tc in zip(x.chunk(n_chunks), targets.chunk(n_chunks)):
        logits = matmul_f32(xc, w.t()).float()
        gold = logits.gather(1, tc.long()[:, None])[:, 0]
        if drop_cols is not None:
            logits[:, drop_cols] = float("-inf")
        if pad_zeros:
            logits = torch.cat([logits, logits.new_zeros(logits.shape[0], pad_zeros)], dim=1)
        lz = torch.logsumexp(logits, dim=-1)
        nll.append(lz - gold)
        lse.append(lz)
    return torch.cat(nll), torch.cat(lse)


def ce_control(torch, name, got, ref):
    """(max, min over the rows) of a control's |nll| and |lse| error against
    the plain version, printed beside both tolerances; the new check must
    fail it."""
    err = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
    hi, lo = err.max().item(), err.min().item()
    print(f"  control: {name}: max|err| {hi:.3e}, least over the rows {lo:.3e}; passes the "
          f"{CE_TOL:.0e} check by {CE_TOL - hi:.3e} (must be < 0), the old {CE_OLD_TOL:.0e} "
          f"one by {CE_OLD_TOL - hi:.3e}", flush=True)
    require(hi > CE_TOL, f"the CE check passed a control ({name}): it cannot see that fault")
    return hi


def phase_ce(torch, fc, dev):
    print("[3] fused LM-head + CE forward vs plain", flush=True)
    from gpt2_vision_language_tpu_torch import _build

    tile = _build.load().gpt2vl_ce_fwd_tile_cols()
    g = torch.Generator(dev).manual_seed(1)
    errs, timing, weights = {"nll": 0.0, "lse": 0.0}, None, {}
    for n, d, v in CE_SHAPES:
        if d not in weights:
            weights[d] = (torch.randn(50304, d, device=dev, generator=g) * 0.02).to(torch.bfloat16)
        w = weights[d][:v]  # the leading rows: contiguous
        x = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
        t = torch.randint(0, v, (n,), device=dev, generator=g, dtype=torch.int32)
        t[:47] = torch.arange(v - 47, v, device=dev, dtype=torch.int32)  # the last tile
        nll, lse = fc.ce_forward(x, w, t)
        again = fc.ce_forward(x, w, t)
        ref = fc.ce_forward_reference(x, w, t, n_chunks=8)
        torch.cuda.synchronize()
        same = torch.equal(nll, again[0]) and torch.equal(lse, again[1])
        en = (nll - ref[0]).abs().max().item()
        el = (lse - ref[1]).abs().max().item()
        print(f"  N={n} D={d} V={v}: nll max|err| {en:.3e}, lse max|err| {el:.3e} "
              f"(tol {CE_TOL}); twice on one input bit-equal {same}", flush=True)
        require(same, f"two runs of the CE kernel differ at N={n} D={d} V={v}")
        require(en <= CE_TOL and el <= CE_TOL, f"fused CE N={n} D={d} V={v} disagrees")
        errs["nll"], errs["lse"] = max(errs["nll"], en), max(errs["lse"], el)
        if n == 8192:
            # control (i): 64 columns of one vocab tile left out
            c0 = 100 * tile
            errs["control_drop64"] = ce_control(
                torch, f"the plain version without vocab columns {c0}..{c0 + 63}",
                ce_reference_drop(torch, x, w, t, drop_cols=slice(c0, c0 + 64)), ref)
            timing = interleaved(
                lambda: fc.ce_forward(x, w, t),
                lambda: fc.ce_forward_reference(x, w, t, n_chunks=8),
                10, 3,
            )
            bf16_route = cuda_ms(
                lambda: fc.fused_linear_ce(x, w, t, n_chunks=8, impl="xla"), 3
            )
            print(f"  the plain route of fused_linear_ce (bf16 logits, impl='xla'): "
                  f"{bf16_route:.4f} ms", flush=True)
            # a yardstick only: no PyTorch call computes the kernel's function
            errs["logits_gemm_ms"] = cuda_ms(lambda: torch.mm(x, w.t()), 10)
            print(f"  the logits GEMM alone (torch.mm, bf16 logits): "
                  f"{errs['logits_gemm_ms']:.4f} ms", flush=True)
        if v == 50257:
            # control (ii): the ragged tile's zero-filled columns counted
            pad = -v % tile
            errs["control_pad"] = ce_control(
                torch, f"the plain version with the last tile's {pad} padding columns counted "
                f"as logits 0 (tile {tile})",
                ce_reference_drop(torch, x, w, t, pad_zeros=pad), ref)
        del x, t, nll, lse, again, ref
    errs["max"] = max(errs["nll"], errs["lse"])
    return errs, timing


# phase 3b's shapes (N, D, V): a chunk of the trainer's 124M micro-batch (16 x
# 1024 rows in 8 chunks), a ragged N with a V whose last 256-wide tile holds 88
# columns, and a chunk of 1558M's micro-batch (8 x 1024 rows in 8 chunks)
CE_BWD_SHAPES = ((2048, 768, 50304), (1000, 768, 50264), (1024, 1600, 50304))
# K4b's P against the plain version's fp32 P before its cast, element by
# element: bf16's unit roundoff (2^-8, the cast), and 2^-16 for the fp32
# logits' other sum order and ex2.approx
CE_BWD_TOL = 2.0 ** -8 + 2.0 ** -16


def ce_bwd_rel_err(torch, p, ref):
    """max over the elements of |p - ref| / |ref|, p the kernel's bf16 P and
    ref the plain version's fp32 P; where ref is 0, p must be 0 too."""
    d = (p.float() - ref).abs()
    r = ref.abs()
    rel = torch.where(r > 0, d / r.clamp_min(1e-30), d * float("inf"))
    return torch.nan_to_num(rel, nan=0.0).max().item()


def ce_bwd_reference_no_onehot(torch, x, w, lse, g):
    """The control of phase 3b: the plain version's fp32 P without the
    one-hot subtraction at each row's target, as a kernel that lost it
    would give."""
    from gpt2_vision_language_tpu_torch.ops.layers import matmul_f32

    return torch.exp(matmul_f32(x, w.t()) - lse[:, None]) * g[:, None]


def phase_ce_bwd(torch, fc, dev):
    print("[3b] CE logits gradient (K4b) vs plain", flush=True)
    from gpt2_vision_language_tpu_torch.ops.layers import matmul_f32

    g_ = torch.Generator(dev).manual_seed(3)
    errs, timing, weights = {"max_rel": 0.0}, None, {}
    for n, d, v in CE_BWD_SHAPES:
        if d not in weights:
            weights[d] = (torch.randn(50304, d, device=dev, generator=g_) * 0.02).to(torch.bfloat16)
        w = weights[d][:v]  # the leading rows: contiguous
        x = torch.randn(n, d, device=dev, generator=g_).to(torch.bfloat16)
        t = torch.randint(0, v, (n,), device=dev, generator=g_, dtype=torch.int32)
        t[:47] = torch.arange(v - 47, v, device=dev, dtype=torch.int32)  # the last tile
        g = torch.rand(n, device=dev, generator=g_) / n
        g[::7] = 0.0  # the masked rows of fused_ce_loss
        _, lse = fc.ce_forward(x, w, t)
        p = fc.ce_backward(x, w, t, lse, g)
        again = fc.ce_backward(x, w, t, lse, g)
        ref = fc.ce_backward_reference(x.float(), w.float(), t, lse, g)
        torch.cuda.synchronize()
        same = torch.equal(p, again)
        e = ce_bwd_rel_err(torch, p, ref)
        zero_rows = not p[::7].any()
        print(f"  N={n} D={d} V={v}: P max over the elements of |err| / |ref| {e:.3e} (tol "
              f"{CE_BWD_TOL:.3e}); rows of g = 0 all zero {zero_rows}; twice on one input "
              f"bit-equal {same}", flush=True)
        require(same, f"two runs of K4b differ at N={n} D={d} V={v}")
        require(e <= CE_BWD_TOL and zero_rows, f"K4b N={n} D={d} V={v} disagrees")
        errs["max_rel"] = max(errs["max_rel"], e)
        if n == 2048:
            # control: P without the one-hot subtraction
            ctrl = ce_bwd_reference_no_onehot(torch, x.float(), w.float(), lse, g)
            ce = ce_bwd_rel_err(torch, ctrl.to(torch.bfloat16), ref)
            print(f"  control: the plain version without the one-hot subtraction: {ce:.3e} "
                  f"(passes the check by {CE_BWD_TOL - ce:.3e}, must be < 0)", flush=True)
            require(ce > CE_BWD_TOL, "the K4b check passed the control without the one-hot")
            errs["control_no_onehot"] = ce
            del ctrl
            timing = interleaved(
                lambda: fc.ce_backward(x, w, t, lse, g),
                lambda: fc.ce_backward_reference(x, w, t, lse, g, logits_dtype=torch.bfloat16),
                10, 3,
            )
            errs["logits_gemm_ms"] = cuda_ms(lambda: torch.mm(x, w.t()), 10)
            errs["dx_ms"] = cuda_ms(lambda: matmul_f32(p, w), 10)
            errs["dw_ms"] = cuda_ms(lambda: matmul_f32(p.t(), x), 10)
            print(f"  N=2048: K4b {timing[0]:.4f} ms, plain P (bf16 logits, the plain route's) "
                  f"{timing[1]:.4f} ms; beside it the logits GEMM alone (torch.mm, bf16 logits) "
                  f"{errs['logits_gemm_ms']:.4f} ms, dx = P w {errs['dx_ms']:.4f} ms, "
                  f"dw = P^T x {errs['dw_ms']:.4f} ms", flush=True)
        del x, t, g, p, again, ref
    return errs, timing


def rel_err(a, ref):
    """max |a - ref| / max |ref|, in fp32."""
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def phase_matmul_f32(torch, layers, dev):
    print("[5] matmul_f32 on batched bf16 operands (decode shape)", flush=True)
    tol = 1e-5  # products of bf16 values are exact in fp32; sum order only
    g = torch.Generator(dev).manual_seed(5)
    a = torch.randn(50, 12, 1, 64, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(50, 12, 64, 60, device=dev, generator=g).to(torch.bfloat16)
    got = layers.matmul_f32(a, b)
    err = rel_err(got, torch.matmul(a.float(), b.float()))
    print(f"  (50, 12, 1, 64) @ (50, 12, 64, 60): dtype {got.dtype}, max|err| / max|ref| "
          f"{err:.3e} (tol {tol})", flush=True)
    require(got.dtype == torch.float32 and err <= tol, "batched matmul_f32 is not fp32-exact")
    return err


# phase 6's controls at B=1, T=8192 (K1_MAX_T), H=12: the plain dk/dv
# without the queries from K1_DKV_DROP_AFTER after the first key of each
# 128-key tile on (the keys of the first four tiles lose up to 512 queries),
# and the plain dq without the keys more than K1_DQ_DROP_BEFORE before each
# 128-row query tile (the last 128 rows lose their first 128 keys). Both are
# chosen so that the check against 3e-2 of max|ref| passes them (at four
# heads on the CPU: dk 1.81e-2, dv 7.98e-3, dq 1.71e-2), while their rows
# fail the row check (by 9.9e-2, 7.2e-2 and 0.53); that check's reading is
# printed beside each
K1_DKV_DROP_AFTER = 7680
K1_DQ_DROP_BEFORE = 7936


def bwd_by_heads(torch, fa, q, k, v, o, lse, do, causal, heads=2, dd=None):
    """The plain backward, `heads` heads at a time (its (B, H, T, T) fp32
    matrices do not fit at once at T=8192, H=12): [dq, dk, dv]. With ``dd``
    (B, H, Tq), the row term (D, or D - dlse) given as the general and lse
    backward kernels take it, ``o`` is not read."""
    parts = []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        parts.append(fa.flash_attention_backward_reference(
            q[:, :, c], k[:, :, c], v[:, :, c], None if dd is not None else o[:, :, c],
            lse[:, c], do[:, :, c], causal=causal, dd=None if dd is None else dd[:, c]))
    return [torch.cat([p[j] for p in parts], dim=2) for j in range(3)]


def phase_flash_bwd(torch, fa, attention, dev):
    print("[6] flash-attention backward vs plain (bf16)", flush=True)
    tol = 3e-2  # max|err| / max|ref|; P and dS round to bf16 in the kernel
    g = torch.Generator(dev).manual_seed(6)
    errs = {"max_rel": 0.0, "dq_row": 0.0, "dkv_row": 0.0}
    timing = {}
    # the training shape, a ragged T, and K1_MAX_T, where the key rows of dk
    # and dv and the query rows of dq differ most in size (the plain side two
    # heads at a time)
    for b, t in ((8, 1024), (8, 1000), (1, fa.K1_MAX_T)):
        h, hs = 12, 64
        q, k, v, do = qkv_inputs(torch, b, t, t, h, dev, g)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        again = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        same = [bool(torch.equal(x, y)) for x, y in zip(got, again)]
        del again
        want = bwd_by_heads(torch, fa, q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        rels = [rel_err(x, r) for x, r in zip(got, want)]
        rows = [grad_row_excess(x, r) for x, r in zip(got, want)]
        print(f"  B={b} T={t} H={h} hs={hs}: dq, dk, dv max|err| / max|ref| "
              + ", ".join(f"{e:.3e}" for e in rels) + f" (tol {tol}), max row |err| / "
              f"(|ref| + 1e-3) " + ", ".join(f"{r[0]:.3e}" for r in rows) + " (tol 2^-6); "
              f"twice on one input bit-equal {same}", flush=True)
        require(all(same), f"two runs of the flash backward differ at T={t}: dq, dk and dv "
                "are summed in a fixed order")
        require(max(rels) <= tol and max(r[1] for r in rows) <= 0,
                f"flash backward T={t} disagrees")
        errs["max_rel"] = max(errs["max_rel"], *rels)
        errs["dq_row"] = max(errs["dq_row"], rows[0][0])
        errs["dkv_row"] = max(errs["dkv_row"], rows[1][0], rows[2][0])
        if t == fa.K1_MAX_T:
            # controls: the plain dk/dv of key tiles that stop their query
            # sweep early, and the plain dq of query tiles that start their
            # key sweep late; the row check must fail both
            dd = fa.rowdot_reference(do, o)
            sk, sv = dkv_reference(torch, q, k, v, do, lse, dd, True,
                                   drop_after=K1_DKV_DROP_AFTER)
            control = max(grad_row_excess(sk, want[1])[1], grad_row_excess(sv, want[2])[1])
            loose = max(rel_err(sk, want[1]), rel_err(sv, want[2]))
            del sk, sv
            print(f"  control: dk/dv without the queries from {K1_DKV_DROP_AFTER} after each "
                  f"key tile on pass the row tolerance by {control:.3e} (must be > 0); "
                  f"max|err| / max|ref| {loose:.3e} (tol {tol})", flush=True)
            require(control > 0, "dk/dv without the far queries passed the row check at "
                    "T=8192: the check cannot see a short key-tile sweep")
            errs["dkv_control"], errs["dkv_control_max_rel"] = control, loose
            sq = dq_reference(torch, q, k, v, do, lse, dd, True, drop_before=K1_DQ_DROP_BEFORE)
            control, loose = grad_row_excess(sq, want[0])[1], rel_err(sq, want[0])
            del sq
            print(f"  control: dq without the keys more than {K1_DQ_DROP_BEFORE} before each "
                  f"query tile passes the row tolerance by {control:.3e} (must be > 0); "
                  f"max|err| / max|ref| {loose:.3e} (tol {tol})", flush=True)
            require(control > 0, "dq without the far keys passed the row check at T=8192: "
                    "the check cannot see a late start of a query tile's key sweep")
            errs["dq_control"], errs["dq_control_max_rel"] = control, loose
            timing["B1_T8192"] = interleaved(
                lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
                lambda: bwd_by_heads(torch, fa, q, k, v, o, lse, do, True), 10, 1)
        if t == 1024:
            timing["B8_T1024"] = interleaved(
                lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
                lambda: fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                              causal=True),
                50, 3,
            )
            leaf = torch.cat([q, k, v], dim=2).view(b, t, 3 * h * hs).requires_grad_(True)

            def layer(impl):
                def run():
                    qq, kk, vv = (a.view(b, t, h, hs) for a in leaf.split(h * hs, dim=-1))
                    y = attention.sdpa(qq, kk, vv, causal=True, impl=impl, layout="bthd")
                    y.backward(do)
                    leaf.grad = None
                return run

            fb = interleaved(layer("flash"), layer("xla"), 20, 3)
            print(f"  one attention layer, forward + backward through autograd: "
                  f"kernels {fb[0]:.4f} ms, plain {fb[1]:.4f} ms", flush=True)
        del q, k, v, do, o, lse, got, want
    return errs, timing


def phase_adamw(torch, gpt2, fw, schedule, cfgs, dev):
    print("[7] AdamW kernel vs plain over GPT-2 124M", flush=True)
    tol = 1e-6  # max|err| / max|ref|; fp32 both ways, FMA contraction only
    model = gpt2.init(cfgs["gpt"], generator=torch.Generator(dev).manual_seed(7), device=dev)
    params = gpt2.named_params(model)
    mask = gpt2.decay_mask(model)
    g = torch.Generator(dev).manual_seed(8)
    names = list(params)
    leaves = [(params[n].detach().clone(), torch.randn(params[n].shape, device=dev, generator=g),
               torch.randn(params[n].shape, device=dev, generator=g) * 1e-2,
               torch.rand(params[n].shape, device=dev, generator=g) * 1e-4) for n in names]
    ref = [tuple(a.clone() for a in leaf) for leaf in leaves]
    ocfg = cfgs["opt"]
    step = 10
    bc1, bc2 = 1 - ocfg.beta1 ** step, 1 - ocfg.beta2 ** step
    lr = schedule.cosine_warmup_lr(step, cfgs["sched"])
    scal = torch.tensor([lr, ocfg.beta1, ocfg.beta2, ocfg.eps, 0.5, bc1, bc2],
                        dtype=torch.float32, device=dev)
    wds = [ocfg.weight_decay if mask[n] else 0.0 for n in names]
    fw.fused_adamw(leaves, scal, wds)
    for (p, gr, m, v), wd in zip(ref, wds):
        fw.adamw_reference(p, gr, m, v, scal, wd=wd)
    torch.cuda.synchronize()
    err = max(rel_err(a, r) for leaf, rleaf in zip(leaves, ref) for a, r in zip(leaf, rleaf))
    n = sum(p.numel() for p in params.values())
    print(f"  {len(names)} leaves, {n:,} params, step {step}: p, m, v max|err| / max|ref| "
          f"{err:.3e} (tol {tol})", flush=True)
    require(err <= tol, "AdamW kernel disagrees")

    def plain():
        for (p, gr, m, v), wd in zip(ref, wds):
            fw.adamw_reference(p, gr, m, v, scal, wd=wd)

    timing = interleaved(lambda: fw.fused_adamw(leaves, scal, wds), plain, 20, 5)
    gbytes = n * 4 * 7 / 1e9  # p, g, m, v read; p, m, v written
    print(f"  {gbytes:.3f} GB moved per update: kernel {gbytes / timing[0] * 1e3:.1f} GB/s, "
          f"plain {gbytes / timing[1] * 1e3:.1f} GB/s", flush=True)
    # the kernel's own device time: the call's copy of its leaf table from
    # pageable memory waits for the work queued before it, which cuda_ms's
    # reading holds
    kernel_ms, _, top = profiled_kernel_ms(torch, lambda: fw.fused_adamw(leaves, scal, wds))
    print(f"  torch.profiler, kernels only: {kernel_ms:.4f} ms a call {top}", flush=True)
    return err, timing, kernel_ms


def _counters(fa, fc, fw):
    return {"flash_fwd": fa.flash_attention, "flash_fwd_f32": fa.flash_forward_f32,
            "flash_bwd": fa.flash_attention_backward, "flash_bwd_f32": fa.flash_bwd_f32_cuda,
            "ce_fwd": fc.ce_forward, "ce_bwd": fc.ce_backward, "adamw": fw.fused_adamw,
            "flash_general_fwd": fa.flash_general_forward, "flash_rowdot": fa.flash_rowdot,
            "flash_general_dq": fa.flash_general_dq, "flash_general_dkv": fa.flash_general_dkv,
            "flash_lse_fwd": fa.flash_lse_forward, "flash_fused_bwd": fa.flash_fused_backward,
            "flash_general_fwd_f32": fa.flash_general_forward_f32,
            "flash_general_bwd_f32": fa.flash_general_backward_f32,
            "flash_rowdot_f32": fa.flash_rowdot_f32, "flash_lse_fwd_f32": fa.flash_lse_forward_f32,
            "flash_fused_bwd_f32": fa.flash_fused_backward_f32}


def reset_counts(fa, fc, fw):
    for fn in _counters(fa, fc, fw).values():
        fn.launches = 0


def read_counts(fa, fc, fw):
    return {name: fn.launches for name, fn in _counters(fa, fc, fw).items()}


def with_zeros(counts):
    """Expected launch counts: the named ones, every other kernel 0."""
    return {**dict.fromkeys(("flash_fwd", "flash_fwd_f32", "flash_bwd", "flash_bwd_f32",
                             "ce_fwd", "ce_bwd", "adamw",
                             "flash_general_fwd", "flash_rowdot", "flash_general_dq",
                             "flash_general_dkv", "flash_lse_fwd", "flash_fused_bwd",
                             "flash_general_fwd_f32", "flash_general_bwd_f32", "flash_rowdot_f32",
                             "flash_lse_fwd_f32", "flash_fused_bwd_f32"), 0),
            **counts}


def ce_train(micro, chunks=8, val=0):
    """The CE kernels' launches of ``micro`` bf16 training micro-batches: K4
    over each, K4b on each of its ``chunks`` chunks of rows (the loss's
    ``ce_chunks``, 8 unless the caller says); and K4 alone over ``val``
    validation micro-batches."""
    return {"ce_fwd": micro + val, "ce_bwd": micro * chunks}


def update_err(delta, ref):
    """max |delta - ref| / max |ref| over dicts of tensors."""
    num = max((delta[n] - r).abs().max().item() for n, r in ref.items())
    return num / max(r.abs().max().item() for r in ref.values())


def compare_train_steps(torch, gpt2, mods, cfgs, kernel, plain, batch, tols=(1e-2, 2e-2, 2e-2)):
    """One step on each path from one state (params and moments after the
    kernel path's steps) and one batch, at the schedule's peak LR. ``tols``:
    the limits of the loss (absolute), the grad norm and the grads (relative),
    the bf16 policy's by default. Returns the readings.

    Gradients: the two paths' accumulated .grad, as a relative L2 error.
    Update: the kernel path's parameter change against the plain AdamW
    replayed on the same state with the kernel path's own gradients, as
    max|err| / max|ref|. Adam divides each grad by its own running
    magnitude, so a grad that is all rounding noise on one path moves its
    param by up to the LR on either path: the update is compared on one set
    of grads, the grads on their own. Controls (no update, no weight decay,
    no clipping) show the update limit sees each of those."""
    (model, state_k, step_k), (plain_model, state_p, step_p) = kernel, plain
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    ocfg = cfgs["opt"]
    (l_tol, n_tol, g_tol), upd_tol = tols, 1e-3
    params_k, params_p = gpt2.named_params(model), gpt2.named_params(plain_model)
    with torch.no_grad():
        for n, p in params_k.items():
            params_p[n].copy_(p)
        for key in ("m", "v"):
            for n, a in state_k[key].items():
                state_p[key][n].copy_(a)
    state_p["step"] = state_k["step"]
    before = {n: p.detach().clone() for n, p in params_k.items()}
    saved = {"m": {n: a.clone() for n, a in state_k["m"].items()},
             "v": {n: a.clone() for n, a in state_k["v"].items()}, "step": state_k["step"]}
    idx = cfgs["sched"].warmup_steps  # the peak LR
    mk = step_k(model, state_k, batch, idx)
    counts = read_counts(fa, fc, fw)
    mp = step_p(plain_model, state_p, batch, idx)
    require(read_counts(fa, fc, fw) == counts, "the plain-path step launched a kernel")

    dl = abs(mk["loss"] - mp["loss"])
    dn = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    grads = {n: p.grad for n, p in params_k.items()}
    sq = lambda ts: sum(t.float().square().sum().item() for t in ts)  # noqa: E731
    dg = math.sqrt(sq(grads[n] - p.grad for n, p in params_p.items())
                   / sq(p.grad for p in params_p.values()))
    print(f"  kernel vs plain paths (attn 'xla', CE 'xla', AdamW plain), one step from "
          f"one state at lr {mk['lr']:.4e}: loss {mk['loss']:.6f} vs {mp['loss']:.6f} "
          f"(|diff| {dl:.3e}, tol {l_tol}), grad_norm {mk['grad_norm']:.6f} vs "
          f"{mp['grad_norm']:.6f} (rel diff {dn:.3e}, tol {n_tol}), grads ||err|| / ||ref|| "
          f"{dg:.3e} (tol {g_tol})", flush=True)
    require(dl <= l_tol and dn <= n_tol and dg <= g_tol, "kernel and plain train steps disagree")

    inv = 1.0 / batch.shape[0]
    norm = mods["global_norm"](grads) * inv
    mask = gpt2.decay_mask(model)

    def replay(opt_cfg, decay_mask):
        p = {n: a.clone() for n, a in before.items()}
        st = {"m": {n: a.clone() for n, a in saved["m"].items()},
              "v": {n: a.clone() for n, a in saved["v"].items()}, "step": saved["step"]}
        mods["adamw_update"](p, grads, st, mk["lr"], opt_cfg, norm=norm, decay_mask=decay_mask,
                             use_fused=False, grad_scale=inv)
        return {n: p[n] - before[n] for n in p}

    with torch.no_grad():
        ref = replay(ocfg, mask)
        delta = {n: p.detach() - before[n] for n, p in params_k.items()}
        err = update_err(delta, ref)
        controls = {
            "no update": update_err({n: torch.zeros_like(r) for n, r in ref.items()}, ref),
            "no weight decay": update_err(replay(ocfg, {n: False for n in mask}), ref),
        }
        clip_on = norm.item() > ocfg.grad_clip
        if clip_on:
            controls["no clipping"] = update_err(
                replay(dataclasses.replace(ocfg, grad_clip=math.inf), mask), ref)
    print(f"  update: kernel path vs plain AdamW on its grads, max|err| / max|ref| "
          f"{err:.3e} (tol {upd_tol}; max|ref| {max(r.abs().max().item() for r in ref.values()):.4e}); "
          f"controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items())
          + ("" if clip_on else " (the clip was inactive)"), flush=True)
    require(err <= upd_tol, "the kernel path's update differs from the plain AdamW's")
    require(all(v > upd_tol for v in controls.values()),
            "a control update passed the update check: the check cannot see it")
    return {"loss_abs_err": dl, "grad_norm_rel_err": dn, "grads_rel_l2": dg,
            "update_max_rel": err, "update_controls": controls}


def phase_train_step(torch, np, gpt2, mods, cfgs, dev):
    print("[8] train step: GPT-2 124M, bf16 policy, 4 x (B=8, T=1024) per step", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"]
    accum, b, t = 4, 8, 1024
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    plain_model = copy.deepcopy(model)
    rows = np.random.RandomState(2).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)

    def loss_fn(attn_impl, ce_impl):
        return lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:],
                                      policy=mods["policy"], attn_impl=attn_impl,
                                      ce_chunks=1, ce_impl=ce_impl)

    def make(model, attn_impl, ce_impl, fused):
        step = mods["make_train_step"](loss_fn(attn_impl, ce_impl), cfgs["opt"], cfgs["sched"],
                                       decay_mask=gpt2.decay_mask(model),
                                       use_fused_adamw=fused)
        return step, mods["adamw_init"](gpt2.named_params(model))

    step_k, state_k = make(model, "auto", "auto", True)
    step_p, state_p = make(plain_model, "xla", "xla", False)
    n_tok = accum * b * t
    reset_counts(fa, fc, fw)
    per_step = with_zeros({"flash_fwd": accum * cfg.n_layer,
                           "flash_bwd": accum * cfg.n_layer, "adamw": 1, **ce_train(accum, 1)})
    metrics, times = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step_k(model, state_k, batch, i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts(fa, fc, fw)
        print(f"  step {i}: loss {metrics[-1]['loss']:.6f}, grad_norm "
              f"{metrics[-1]['grad_norm']:.6f}, lr {metrics[-1]['lr']:.4e}, "
              f"{n_tok / times[-1]:.1f} tokens/s; launches {counts}", flush=True)
        require(counts == {k: (i + 1) * v for k, v in per_step.items()},
                f"expected {per_step} launches per step, got {counts} after {i + 1}")
        require(math.isfinite(metrics[-1]["loss"]) and math.isfinite(metrics[-1]["grad_norm"]),
                "train loss or grad norm is not finite")
        if i == 0:
            ln_v = math.log(cfg.padded_vocab_size)
            require(abs(metrics[0]["loss"] - ln_v) < 0.5, "first loss is not near ln(V)")
    main_counts = read_counts(fa, fc, fw)
    compare_train_steps(torch, gpt2, mods, cfgs, (model, state_k, step_k),
                        (plain_model, state_p, step_p), batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_p(plain_model, state_p, batch, 1)
    torch.cuda.synchronize()
    plain_tps = n_tok / (time.perf_counter() - t0)
    kernel_tps = n_tok / (sum(times[1:]) / 2)
    print(f"  tokens/s: kernel path {kernel_tps:.1f} (steps 1-2), plain paths "
          f"{plain_tps:.1f} (step 1)", flush=True)
    del plain_model, state_p

    # K4 in the training forward: one micro-batch forward + backward
    micro = batch[0]

    def fwd_bwd(ce_impl):
        def run():
            loss_fn("auto", ce_impl)(model, micro).backward()
            for p in model.parameters():
                p.grad = None
        return run

    saved = read_counts(fa, fc, fw)
    ce_ms = interleaved(fwd_bwd("auto"), fwd_bwd("xla"), 3, 3)
    got = read_counts(fa, fc, fw)
    calls = 2 * (1 + 3)  # interleaved: two readings of a warm-up and 3 calls
    require(got["ce_fwd"] - saved["ce_fwd"] == calls and got["ce_bwd"] - saved["ce_bwd"] == calls,
            "CE 'auto' under autograd did not take K4 and K4b once a micro-batch")
    print(f"  one micro-batch forward + backward: CE 'auto' (K4 forward, K4b backward) "
          f"{ce_ms[0]:.4f} ms, CE 'xla' (the chunked plain path) {ce_ms[1]:.4f} ms", flush=True)

    # FP32_POLICY keeps the CE on the plain path: no K4 and no K4b
    saved = read_counts(fa, fc, fw)
    gpt2.loss(model, micro[:, :-1], cfg, targets=micro[:, 1:], policy=mods["fp32_policy"],
              ce_chunks=1).backward()
    for p in model.parameters():
        p.grad = None
    got = read_counts(fa, fc, fw)
    print(f"  one micro-batch forward + backward under FP32_POLICY: CE launches "
          f"{got['ce_fwd'] - saved['ce_fwd']} K4, {got['ce_bwd'] - saved['ce_bwd']} K4b",
          flush=True)
    require(got["ce_fwd"] == saved["ce_fwd"] and got["ce_bwd"] == saved["ce_bwd"],
            "a train step under FP32_POLICY launched a CE kernel")
    return {"kernel_tps": kernel_tps, "plain_tps": plain_tps, "counts": main_counts,
            "micro_ce_ms": ce_ms}


def phase_trainer(torch, mods, cfgs):
    print("[9] trainer: cli.pretrain --synthetic, 3 steps of 65,536 tokens, then resume",
          flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    old_tmp = tempfile.tempdir
    tempfile.tempdir = log_dir  # the synthetic shards go under it too
    try:
        argv = ["--synthetic", "--total-batch", "65536", "--no-hellaswag",
                "--log-dir", os.path.join(log_dir, "log")]
        reset_counts(fa, fc, fw)
        t0 = time.perf_counter()
        out = mods["pretrain"].main(argv + ["--steps", "3"])
        dt = time.perf_counter() - t0
        counts = read_counts(fa, fc, fw)
        accum, val_steps = 8, 20
        want = with_zeros({"flash_fwd": cfg.n_layer * (3 * accum + 2 * val_steps),
                           "flash_bwd": cfg.n_layer * 3 * accum, "adamw": 3,
                           **ce_train(3 * accum, val=2 * val_steps)})
        print(f"  3 steps in {dt:.1f} s (val at steps 0 and 2, samples, checkpoints); "
              f"launches {counts}", flush=True)
        require(counts == want, f"expected launches {want}, got {counts}")
        require(out["opt_state"]["step"] == 3 and math.isfinite(out["val_loss"]),
                "the trainer did not take 3 finite steps")
        rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                for line in open(f).read().splitlines()[1:]]
        phases = [r[1] for r in rows]
        print(f"  CSV: {phases.count('train')} train rows, {phases.count('val')} val rows",
              flush=True)
        require(phases.count("train") == 3 and phases.count("val") >= 1,
                "the CSV does not hold 3 train rows and a val row")
        ckpts = sorted(os.listdir(os.path.join(log_dir, "log", "ckpts")))
        print(f"  checkpoints: {ckpts}", flush=True)
        require("model_final.pt" in ckpts, "model_final was not written")

        reset_counts(fa, fc, fw)
        out = mods["pretrain"].main(argv + ["--steps", "4"])
        rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                for line in open(f).read().splitlines()[1:]]
        steps = [int(r[2]) for r in rows if r[1] == "train"]
        print(f"  resumed: train steps logged {steps}, AdamW launches "
              f"{fw.fused_adamw.launches}, optimizer step {out['opt_state']['step']}",
              flush=True)
        require(steps == [0, 1, 2, 3] and fw.fused_adamw.launches == 1
                and out["opt_state"]["step"] == 4,
                "the second call did not resume at step 3 and run one step")
        return counts, phases.count("train")
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(log_dir, ignore_errors=True)


def phase_profiler(torch, mods):
    print("[9b] ProfilerHook(start_step=1, num_steps=1) in cli.pretrain --synthetic, 3 steps "
          "of 8,192 tokens, PROFILE_DIR set: the trace of step 2 names the port's kernels "
          "and holds its spans",
          flush=True)
    from gpt2_vision_language_tpu_torch.obs import csvlog
    from gpt2_vision_language_tpu_torch.train import pretrain as trainer

    work = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    prof_dir = os.path.join(work, "prof")
    old_tmp, old_hook, old_env = tempfile.tempdir, trainer.ProfilerHook, os.environ.get(
        "PROFILE_DIR")
    tempfile.tempdir = work  # the synthetic shards go under it too
    os.environ["PROFILE_DIR"] = prof_dir
    # the trainer makes its hook with the JAX window (10, 5): this run's is
    # (1, 1), so the trace opens after step 1 and closes after step 2
    trainer.ProfilerHook = lambda: csvlog.ProfilerHook(start_step=1, num_steps=1)
    try:
        t0 = time.perf_counter()
        mods["pretrain"].main(["--synthetic", "--total-batch", "8192", "--no-hellaswag",
                               "--no-ckpt", "--val-every", "0", "--sample-every", "0",
                               "--log-dir", os.path.join(work, "log"), "--steps", "3"])
        dt = time.perf_counter() - t0
        traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
        require(len(traces) == 1, f"expected one trace under PROFILE_DIR, got {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
        found = {k: [n for n in kernels if k in n] for k in ("flash_fwd", "flash_bwd", "adamw")}
        spans = {}
        for e in events:
            if e.get("cat") == "gpt2vl":
                spans[e["name"]] = spans.get(e["name"], 0) + 1
        print(f"  3 steps in {dt:.1f} s; trace {os.path.getsize(traces[0])} bytes, "
              f"{len(kernels)} kernel names; the port's: {found}; its spans: {spans}", flush=True)
        require(all(found.values()), f"the trace does not name the port's kernels: {found}")
        want = ("step", "step.forward", "step.backward", "linear.fwd", "linear.bwd", "attn.fwd",
                "attn.bwd", "ce.fwd", "ce.bwd", "step.optimizer", "optimizer.kernel")
        require(spans.get("step") == 1 and all(spans.get(n) for n in want),
                f"the trace does not hold the port's spans of one step: {spans}")
        return {"seconds": dt, "kernel_names": len(kernels), "port_kernels": found,
                "port_spans": spans}
    finally:
        trainer.ProfilerHook = old_hook
        tempfile.tempdir = old_tmp
        if old_env is None:
            os.environ.pop("PROFILE_DIR", None)
        else:
            os.environ["PROFILE_DIR"] = old_env
        shutil.rmtree(work, ignore_errors=True)


# Published peaks of one H100 SXM (NVIDIA's data sheet): bf16 dense tensor-core
# rate, fp32 rate outside the tensor cores (what a kernel whose products are
# true fp32 FMAs can reach; the tensor cores take fp32 only as TF32) and HBM3
# rate. A kernel's bound is the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written once)
# over the last.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(least milliseconds the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(kind, b, tq, tk, h, hs, causal, elem_bytes=2, peak=PEAK_BF16_FLOPS):
    """Bound of one attention kernel on operands of ``elem_bytes`` bytes
    (bf16 unless said), its products at ``peak``. Operations count the
    (query, key) pairs the mask leaves visible: two products in the forward
    (S, PV), five in the whole backward (S, dP, dV, dQ, dK), three of them for
    dq alone (S, dP, dQ) and four for dk/dv alone (S, dP, dV, dK). The one-pass
    backward reads dcap where the self-attention backward reads o."""
    pairs = b * h * (tq * (tk - tq) + tq * (tq + 1) // 2 if causal else tq * tk)
    n_q, n_k, stats = b * tq * h * hs, b * tk * h * hs, b * h * tq * 4
    products, q_like, k_like, n_stats = {
        "fwd": (2, 2, 2, 1),   # q, o; k, v; lse
        "bwd": (5, 4, 4, 1),   # q, o, dO, dq; k, v, dk, dv; lse
        "fused_bwd": (5, 3, 4, 2),  # q, dO, dq; k, v, dk, dv; lse, dcap
        "dq": (3, 3, 2, 2),    # q, dO, dq; k, v; lse, D
        "dkv": (4, 2, 4, 2),   # q, dO; k, v, dk, dv; lse, D
    }[kind]
    return bound_ms(2 * products * hs * pairs, elem_bytes * (q_like * n_q + k_like * n_k)
                    + n_stats * stats, peak)


def qkv_inputs(torch, b, tq, tk, h, dev, g, dtype=None):
    """q (B, Tq, H, 64) and k, v (B, Tk, H, 64) in ``dtype`` (bf16 by
    default), strided views of fused projections as the model makes them
    (one QKV tensor when Tq == Tk), and an output cotangent."""
    hs, dtype = 64, dtype or torch.bfloat16
    if tq == tk:
        qkv = torch.randn(b, tq, 3 * h * hs, device=dev, generator=g).to(dtype)
        q, k, v = (a.view(b, tq, h, hs) for a in qkv.split(h * hs, dim=-1))
    else:
        q = torch.randn(b, tq, h, hs, device=dev, generator=g).to(dtype)
        kv = torch.randn(b, tk, 2 * h * hs, device=dev, generator=g).to(dtype)
        k, v = (a.view(b, tk, h, hs) for a in kv.split(h * hs, dim=-1))
    do = torch.randn(b, tq, h, hs, device=dev, generator=g).to(dtype)
    return q, k, v, do


def out_excess(o, ref):
    """(max|err|, the largest amount by which |err| passes max(2e-2, one bf16
    ulp of |ref|)): the kernel and the plain version both round o to bf16, so
    where |ref| > 2.56 one ulp (2^-7 |ref|) is more than 2e-2."""
    err = (o.float() - ref.float()).abs()
    allowed = (ref.float().abs() * 2.0 ** -7).clamp(min=2e-2)
    return err.max().item(), (err - allowed).max().item()


def row_excess(o, ref, rel=2.0 ** -6):
    """(the largest |o - ref| / |ref| over the rows of hs values, by how much
    it passes ``rel``). Unlike ``out_excess`` this scales with each row: at
    T=16384 a late row's |o| is near 0.015, below that check's 2e-2 floor,
    so only this one sees a wrong P @ V there. The kernel and the plain
    version round P to bf16 at different points (before and after the
    normalisation) and then o, which leaves a few 2^-9 of |ref| a row."""
    err = (o.float() - ref.float()).norm(dim=-1)
    r = (err / ref.float().norm(dim=-1)).max().item()
    return r, r - rel


def grad_row_excess(x, ref, rel=2.0 ** -6, floor=1e-3):
    """(the largest |x - ref| / (|ref| + floor) over the rows of hs values of
    a gradient, the key rows of dk or dv or the query rows of dq, by how much
    it passes ``rel``). Under a causal mask these rows differ in size by
    orders of magnitude (dq's from 2.6e-7 to 4.67 at T=8192), so the check
    against 3e-2 of max|ref|, which the largest rows set, can pass a row that
    is off by most of its norm: what a dk/dv kernel whose key tiles stop
    their query sweep early gives, or a dq kernel whose query tiles skip far
    keys. The absolute floor keeps rows near zero, whose error is set by the
    size of their terms rather than of their sum, from turning rounding into
    a failure. Sound kernels read at most about 6e-3 (P and dS rounded to
    bf16, then the gradient)."""
    err = (x.float() - ref.float()).norm(dim=-1)
    r = (err / (ref.float().norm(dim=-1) + floor)).max().item()
    return r, r - rel


def dkv_reference(torch, q, k, v, do, lse, dd, causal, drop_after=None, tile=128, heads=2):
    """dk and dv of the plain backward (flash_attention_backward_reference's
    fp32 arithmetic on the kernels' lse and D), `heads` heads at a time. With
    ``drop_after``, a query whose key position is ``drop_after`` or more past
    the first key of a key's 128-key tile adds nothing to that key: what a
    dk/dv kernel would give whose key tiles stop their query sweep that early,
    the control that the row check of dk and dv must fail."""
    tq, tk, hs = q.shape[1], k.shape[1], q.shape[-1]
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    hide = kpos > qpos if causal else torch.zeros(tq, tk, dtype=torch.bool, device=q.device)
    if drop_after is not None:
        hide = hide | (qpos >= kpos // tile * tile + drop_after)
    dks, dvs = [], []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        q32, k32, v32, do32 = (a[:, :, c].float() for a in (q, k, v, do))
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * hs**-0.5
        p = torch.exp(s.masked_fill(hide, float("-inf")) - lse[:, c, :, None])
        del s
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do32).to(v.dtype))
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", do32, v32) - dd[:, c, :, None])
        del p
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, q32) * hs**-0.5).to(k.dtype))
        del ds
    return torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


# phase 10's dq control at T=16384: the keys more than this many positions
# before each 128-row query tile are dropped (up to 896 keys of the last 896
# rows); chosen so that the control passes the check against 3e-2 of
# max|ref| on phase 10's inputs (1.40e-2 on an H100; 12288 read 4.45e-2),
# which is printed beside the row check's reading
DQ_DROP_BEFORE = 15360


def dq_reference(torch, q, k, v, do, lse, dd, causal, drop_before=None, tile=128, heads=2):
    """dq of the plain backward (flash_attention_backward_reference's fp32
    arithmetic on the kernels' lse and D), `heads` heads at a time. With
    ``drop_before``, a key more than ``drop_before`` positions before the
    first row of a query's 128-row tile adds nothing to that query: what a dq
    kernel would give whose query tiles start their key sweep that late, the
    control that the row check of dq must fail."""
    tq, tk, hs = q.shape[1], k.shape[1], q.shape[-1]
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    hide = kpos > qpos if causal else torch.zeros(tq, tk, dtype=torch.bool, device=q.device)
    if drop_before is not None:
        first = torch.arange(tq, device=q.device)[:, None] // tile * tile + (tk - tq)
        hide = hide | (kpos < first - drop_before)
    dqs = []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        q32, k32, v32, do32 = (a[:, :, c].float() for a in (q, k, v, do))
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * hs**-0.5
        p = torch.exp(s.masked_fill(hide, float("-inf")) - lse[:, c, :, None])
        del s
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", do32, v32) - dd[:, c, :, None])
        del p
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, k32) * hs**-0.5).to(q.dtype))
        del ds
    return torch.cat(dqs, dim=2)


def plain_by_heads(torch, fa, q, k, v, do, o, lse, dd, causal, heads=2):
    """The plain forward and backward, `heads` heads at a time (their (B, H,
    Tq, Tk) fp32 score matrices do not fit at once at T=16384, H=12). Each
    plain version gets its kernel's inputs: the forward q, k, v; D the
    kernel's o; the backward the kernels' lse and D. Returns (o, lse, D, dq,
    dk, dv)."""
    parts = []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        parts.append((
            *fa.flash_attention_reference(q[:, :, c], k[:, :, c], v[:, :, c], causal=causal),
            fa.rowdot_reference(do[:, :, c], o[:, :, c]),
            *fa.flash_attention_backward_reference(
                q[:, :, c], k[:, :, c], v[:, :, c], None, lse[:, c], do[:, :, c],
                causal=causal, dd=dd[:, c])))
    dims = (2, 1, 1, 2, 2, 2)  # the head axis of each
    return [torch.cat([p[j] for p in parts], dim=d) for j, d in enumerate(dims)]


def phase_general(torch, fa, dev):
    print("[10] general flash kernels (Tq != Tk, streamed K/V) vs plain (bf16)", flush=True)
    lse_tol, bwd_tol = 1e-3, 3e-2  # as the self-attention kernels
    dd_tol = 1e-5  # fp32 sums of the same 64 products in another order
    g = torch.Generator(dev).manual_seed(10)
    errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0, "dd": 0.0, "dq": 0.0, "dq_row": 0.0, "dkv": 0.0,
            "dkv_row": 0.0}
    # 777 / 1234: an offset Tk - Tq = 457 that is no multiple of 64 or 128, so
    # the 128-row tiles of K2b cross the diagonal mid-tile; 200: ragged
    # without a mask
    shapes = [(2, 4096, 4096, 12, True), (2, 1000, 1000, 12, True), (2, 64, 2048, 12, True),
              (2, 64, 2048, 12, False), (4, 1, 1500, 12, True), (2, 777, 1234, 12, True),
              (3, 200, 200, 12, False), (1, 16384, 16384, 12, True)]
    for b, tq, tk, h, causal in shapes:
        q, k, v, do = qkv_inputs(torch, b, tq, tk, h, dev, g)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True, stream_kv=True)
        if tq == 4096:
            # control: the kernel's o against the plain version with the other
            # mask must fail the check
            _, control = out_excess(o, fa.flash_attention_reference(q, k, v, causal=not causal)[0])
            print(f"  control: o against the plain version with causal={not causal} passes "
                  f"the tolerance by {control:.3e} (must be > 0)", flush=True)
            require(control > 0, "K2b's o passed the check against the wrong mask: the "
                    "check cannot see the mask")
        if tq == 16384:
            # control: the last 128 rows as a kernel that dropped their last
            # key tile (keys Tk-128 on, the diagonal) would give them; the row
            # check must fail it where the late rows' |o| is smallest
            r = slice(tq - 128, tq)
            dropped = fa.flash_attention_reference(q[:, r], k[:, :tk - 128], v[:, :tk - 128],
                                                   causal=False)[0]
            _, control = row_excess(o[:, r], dropped)
            _, loose = out_excess(o[:, r], dropped)
            print(f"  control: the last 128 rows without their last key tile pass the row "
                  f"tolerance by {control:.3e} (must be > 0), the elementwise one by "
                  f"{loose:.3e}", flush=True)
            require(control > 0, "K2b's o passed the row check against o without the last "
                    "key tile: the check cannot see the late rows' P @ V")
        dd = fa.flash_rowdot(do, o)
        dq = fa.flash_general_dq(q, k, v, do, lse, dd, causal=causal)
        dq2 = fa.flash_general_dq(q, k, v, do, lse, dd, causal=causal)
        dk, dv = fa.flash_general_dkv(q, k, v, do, lse, dd, causal=causal)
        dk2, dv2 = fa.flash_general_dkv(q, k, v, do, lse, dd, causal=causal)
        require(torch.equal(dq2, dq) and torch.equal(dk2, dk) and torch.equal(dv2, dv),
                f"two runs of the dq or the dk/dv kernel differ at Tq={tq} Tk={tk}: both sum "
                "in a fixed order")
        del dq2, dk2, dv2
        ro, rlse, rdd, rdq, rdk, rdv = plain_by_heads(torch, fa, q, k, v, do, o, lse, dd,
                                                       causal)
        torch.cuda.synchronize()
        eo, excess = out_excess(o, ro)
        erow, row_over = row_excess(o, ro)
        el = (lse - rlse).abs().max().item()
        ed = rel_err(dd, rdd)
        eq, ek, ev = rel_err(dq, rdq), rel_err(dk, rdk), rel_err(dv, rdv)
        (rq, q_over), (rk, k_over), (rv, v_over) = (grad_row_excess(x, r) for x, r in
                                                     ((dq, rdq), (dk, rdk), (dv, rdv)))
        finite = all(torch.isfinite(a.float()).all().item() for a in (o, lse, dd, dq, dk, dv))
        print(f"  B={b} Tq={tq} Tk={tk} H={h} causal={causal}: out max|err| {eo:.3e} (tol "
              f"2e-2 or one bf16 ulp), max row |err| / |ref| {erow:.3e} (tol 2^-6), lse "
              f"max|err| {el:.3e} (tol {lse_tol}), D "
              f"{ed:.3e} (tol {dd_tol}), dq, dk, dv max|err| / max|ref| {eq:.3e}, "
              f"{ek:.3e}, {ev:.3e} (tol {bwd_tol}), dq, dk, dv max row |err| / (|ref| + 1e-3) "
              f"{rq:.3e}, {rk:.3e}, {rv:.3e} (tol 2^-6)", flush=True)
        require(finite, f"general kernels gave a non-finite value at Tq={tq} Tk={tk}")
        require(excess <= 0 and row_over <= 0 and el <= lse_tol,
                f"general forward Tq={tq} Tk={tk} disagrees")
        require(ed <= dd_tol and max(eq, ek, ev) <= bwd_tol and max(q_over, k_over, v_over) <= 0,
                f"general backward Tq={tq} Tk={tk} disagrees")
        if tq == 16384:
            # control: the plain dk/dv with the query rows from 4096 after each
            # key tile on dropped, as a K3b whose sweeps stop early would give
            # them; the row check must fail it (the check against max|ref| is
            # printed beside it)
            sk, sv = dkv_reference(torch, q, k, v, do, lse, dd, causal, drop_after=4096)
            control = max(grad_row_excess(sk, rdk)[1], grad_row_excess(sv, rdv)[1])
            loose = max(rel_err(sk, rdk), rel_err(sv, rdv))
            del sk, sv
            print(f"  control: dk/dv without the queries from 4096 after each key tile on "
                  f"pass the row tolerance by {control:.3e} (must be > 0); max|err| / "
                  f"max|ref| {loose:.3e} (tol {bwd_tol})", flush=True)
            require(control > 0, "dk/dv without the far queries passed the row check: the "
                    "check cannot see a short key-tile sweep")
            # control: the plain dq without the keys more than DQ_DROP_BEFORE
            # before each query tile, as a K3a whose sweeps start late would
            # give it; the row check must fail it, the check against max|ref|
            # passes it
            sq = dq_reference(torch, q, k, v, do, lse, dd, causal, drop_before=DQ_DROP_BEFORE)
            control, loose = grad_row_excess(sq, rdq)[1], rel_err(sq, rdq)
            del sq
            print(f"  control: dq without the keys more than {DQ_DROP_BEFORE} before each query "
                  f"tile passes the row tolerance by {control:.3e} (must be > 0); max|err| / "
                  f"max|ref| {loose:.3e} (tol {bwd_tol})", flush=True)
            require(control > 0, "dq without the far keys passed the row check: the check "
                    "cannot see a late start of a query tile's key sweep")
            errs["dq_control"], errs["dq_control_max_rel"] = control, loose
        for key, e in (("o", eo), ("o_row", erow), ("lse", el), ("dd", ed), ("dq", eq),
                       ("dq_row", rq), ("dkv", max(ek, ev)), ("dkv_row", max(rk, rv))):
            errs[key] = max(errs[key], e)
    # times at the long-context shape (the last one above); the backward's
    # plain version computes dq, dk and dv together
    print(f"  times at B={b} T={tq} H={h} causal, plain two heads at a time:", flush=True)

    def plain_fwd():
        for i in range(0, h, 2):
            fa.flash_attention_reference(q[:, :, i:i + 2], k[:, :, i:i + 2], v[:, :, i:i + 2],
                                         causal=True)

    def plain_bwd():
        for i in range(0, h, 2):
            c = slice(i, i + 2)
            fa.flash_attention_backward_reference(q[:, :, c], k[:, :, c], v[:, :, c], None,
                                                  lse[:, c], do[:, :, c], causal=True,
                                                  dd=dd[:, c])

    times = {
        "fwd": interleaved(lambda: fa.flash_general_forward(q, k, v, causal=True),
                           plain_fwd, 5, 1),
        "dq": interleaved(lambda: fa.flash_general_dq(q, k, v, do, lse, dd, causal=True),
                          plain_bwd, 5, 1),
        "dkv": interleaved(lambda: fa.flash_general_dkv(q, k, v, do, lse, dd, causal=True),
                           plain_bwd, 5, 1),
        "rowdot": interleaved(lambda: fa.flash_rowdot(do, o),
                              lambda: fa.rowdot_reference(do, o), 20, 5),
    }
    return errs, times


def phase_general_vs_self(torch, fa, dev):
    print("[11] general kernels vs self-attention kernels on the same inputs", flush=True)
    g = torch.Generator(dev).manual_seed(11)
    out = {}
    for b, t in ((8, 1024), (2, 4096)):
        q, k, v, do = qkv_inputs(torch, b, t, t, 12, dev, g)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        og, lseg = fa.flash_attention(q, k, v, causal=True, return_lse=True, stream_kv=True)
        bs = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        bg = fa.flash_general_backward(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        same = (torch.equal(o, og) and torch.equal(lse, lseg)
                and all(torch.equal(x, y) for x, y in zip(bs, bg)))
        fwd = interleaved(lambda: fa.flash_attention(q, k, v, causal=True, stream_kv=True),
                          lambda: fa.flash_attention(q, k, v, causal=True), 20, 20)
        bwd = interleaved(lambda: fa.flash_general_backward(q, k, v, o, lse, do, causal=True),
                          lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
                          20, 20)
        print(f"  B={b} T={t} H=12 causal: forward general {fwd[0]:.4f} ms, self {fwd[1]:.4f} "
              f"ms; backward general (D + dq + dk/dv) {bwd[0]:.4f} ms, self {bwd[1]:.4f} ms; "
              f"results bit-identical: {same}", flush=True)
        require(max(rel_err(og, o), *(rel_err(x, y) for x, y in zip(bg, bs))) <= 1e-2,
                f"the two kernel families disagree at T={t}")
        out[f"B{b}_T{t}"] = {"general_fwd_ms": fwd[0], "self_fwd_ms": fwd[1],
                             "general_bwd_ms": bwd[0], "self_bwd_ms": bwd[1]}
    return out


def phase_library_probes(torch, gpt2, cfgs, dev):
    """One PyTorch call computing the same function as a kernel, timed beside
    it. Nothing in the port calls these."""
    import torch.nn.functional as F

    print("[12] library-call probes (timed only; never a route of the port)", flush=True)
    g = torch.Generator(dev).manual_seed(12)
    out = {}
    # the last two are the ring's chunk pair, with its causal mask and without
    for b, t, causal, iters in ((8, 1024, True, 20), (1, 8192, True, 10), (1, 16384, True, 5),
                                (1, 4096, True, 20), (1, 4096, False, 20)):
        # (B, H, T, hs) contiguous, the layout the library call is built for
        q, k, v, do = (a.transpose(1, 2).contiguous()
                       for a in qkv_inputs(torch, b, t, t, 12, dev, g))
        for a in (q, k, v):
            a.requires_grad_(True)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        # SDPA's backward forms dq, dk and dv in one kernel whichever of them
        # are asked for, so no call times dq or dk/dv alone
        r = {"fwd": cuda_ms(fwd, iters),
             "bwd": cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True),
                            iters)}
        print(f"  F.scaled_dot_product_attention B={b} T={t} H=12 hs=64 bf16 "
              f"{'causal' if causal else 'no mask'}: forward "
              f"{r['fwd']:.4f} ms, backward (autograd.grad of q, k, v) {r['bwd']:.4f} ms, "
              f"forward + backward {r['fwd'] + r['bwd']:.4f} ms", flush=True)
        out[f"B{b}_T{t}" + ("" if causal else "_nomask")] = r
        del o

    model = gpt2.init(cfgs["gpt"], generator=torch.Generator(dev).manual_seed(7), device=dev)
    params = [p.detach().clone().requires_grad_(True) for p in gpt2.named_params(model).values()]
    for p in params:
        p.grad = torch.randn(p.shape, device=dev, generator=g)
    ocfg = cfgs["opt"]
    opt = torch.optim.AdamW(params, lr=6e-4, betas=(ocfg.beta1, ocfg.beta2), eps=ocfg.eps,
                            weight_decay=ocfg.weight_decay, fused=True)
    out["adamw_fused"] = cuda_ms(opt.step, 20)
    out["adamw_fused_kernel_ms"], _, top = profiled_kernel_ms(torch, opt.step)
    print(f"  torch.optim.AdamW(fused=True).step() over {len(params)} leaves: "
          f"{out['adamw_fused']:.4f} ms; torch.profiler, kernels only: "
          f"{out['adamw_fused_kernel_ms']:.4f} ms {top}", flush=True)
    return out


def phase_long_train_step(torch, np, gpt2, mods, cfgs, dev):
    accum, b, t = 2, 1, 16384
    print(f"[13] long-context train step: GPT-2 124M, block_size {t}, bf16 policy, "
          f"{accum} x (B={b}, T={t}) per step", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"].replace(block_size=t)

    def loss_fn(cfg, attn_impl, ce_impl):
        return lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:],
                                      policy=mods["policy"], attn_impl=attn_impl,
                                      ce_chunks=1, ce_impl=ce_impl)

    def make(model, cfg, attn_impl, ce_impl, fused):
        step = mods["make_train_step"](loss_fn(cfg, attn_impl, ce_impl), cfgs["opt"],
                                       cfgs["sched"], decay_mask=gpt2.decay_mask(model),
                                       use_fused_adamw=fused)
        return step, mods["adamw_init"](gpt2.named_params(model))

    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    rows = np.random.RandomState(13).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    step_k, state_k = make(model, cfg, "auto", "auto", True)
    n = accum * cfg.n_layer
    per_step = with_zeros({"flash_general_fwd": n, "flash_rowdot": n, "flash_general_dq": n,
                           "flash_general_dkv": n, "adamw": 1, **ce_train(accum, 1)})
    n_tok = accum * b * t
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, fc, fw)
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_k(model, state_k, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts(fa, fc, fw)
        print(f"  step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, lr "
              f"{m['lr']:.4e}, {n_tok / times[-1]:.1f} tokens/s; launches {counts}", flush=True)
        require(counts == {k: (i + 1) * v for k, v in per_step.items()},
                f"expected {per_step} launches per step, got {counts} after {i + 1}")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                "long-context train loss or grad norm is not finite")
        if i == 0:
            require(abs(m["loss"] - math.log(cfg.padded_vocab_size)) < 0.5,
                    "first long-context loss is not near ln(V)")
    main_counts = read_counts(fa, fc, fw)
    tps = n_tok / (sum(times[1:]) / 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  tokens/s {tps:.1f} (steps 1-2), peak device memory {peak:.2f} GiB", flush=True)
    del model, state_k, step_k, batch
    torch.cuda.empty_cache()

    # against the plain paths where einsum attention fits: full width, 2
    # layers, T just above the self-attention kernels' longest
    t2 = 8320
    cfg2 = cfgs["gpt"].replace(block_size=t2, n_layer=2)
    print(f"  kernel path vs plain paths at {cfg2.n_layer} layers, B=1, T={t2}:", flush=True)
    model = gpt2.init(cfg2, generator=torch.Generator(dev).manual_seed(1338), device=dev)
    plain_model = copy.deepcopy(model)
    rows = np.random.RandomState(14).randint(0, cfg2.vocab_size, (1, 1, t2 + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    kernel = (model, *reversed(make(model, cfg2, "auto", "auto", True)))
    plain = (plain_model, *reversed(make(plain_model, cfg2, "xla", "xla", False)))
    kernel[2](model, kernel[1], batch, 0)  # one step first, so the moments are not zero
    reset_counts(fa, fc, fw)
    compare_train_steps(torch, gpt2, mods, cfgs, kernel, plain, batch)
    counts = read_counts(fa, fc, fw)
    require(counts == with_zeros({"flash_general_fwd": 2, "flash_rowdot": 2,
                                  "flash_general_dq": 2, "flash_general_dkv": 2, "adamw": 1,
                                  **ce_train(1, 1)}),
            f"the T={t2} kernel-path step did not run on the general kernels: {counts}")
    return {"tps": tps, "peak_gib": peak, "counts": main_counts}


def write_synthetic_hellaswag(np, path, n=16, seed=0, ctx_tokens=None, tokenizer=None):
    """A small seeded HellaSwag-format file (no such data ships with the
    repository and none can be fetched). With ``ctx_tokens=(lo, hi)`` each
    context grows until ``tokenizer`` encodes it to a length drawn from
    [lo, hi] or more."""
    rng = np.random.RandomState(seed)
    words = "the a cat dog runs sleeps quickly under over bridge river and then stops".split()
    with open(path, "w") as f:
        for _ in range(n):
            phrase = lambda k: " ".join(rng.choice(words, size=k))  # noqa: E731
            ctx = phrase(int(rng.randint(3, 9)))
            if ctx_tokens is not None:
                want = int(rng.randint(ctx_tokens[0], ctx_tokens[1] + 1))
                while len(tokenizer.encode(ctx)) < want:
                    ctx += " " + phrase(8)
            f.write(json.dumps({"ctx": ctx, "label": int(rng.randint(4)),
                                "endings": [phrase(int(rng.randint(1, 5))) for _ in range(4)]})
                    + "\n")


def phase_long_trainer(torch, np, mods, cfgs):
    print("[14] long-context trainer: cli.pretrain --synthetic --seq-len 16384 --micro-batch 1, "
          "3 steps of 32,768 tokens with HellaSwag, then resume", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    n_layer = cfgs["gpt"].n_layer
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_long_")
    old_tmp, old_hs = tempfile.tempdir, os.environ.get("HELLASWAG_DIR")
    tempfile.tempdir = log_dir  # the synthetic shards go under it too
    try:
        hs_dir = os.path.join(log_dir, "hellaswag")
        os.makedirs(hs_dir)
        write_synthetic_hellaswag(np, os.path.join(hs_dir, "hellaswag_val.jsonl"))
        os.environ["HELLASWAG_DIR"] = hs_dir
        argv = ["--synthetic", "--seq-len", "16384", "--micro-batch", "1", "--total-batch",
                "32768", "--log-dir", os.path.join(log_dir, "log")]
        reset_counts(fa, fc, fw)
        t0 = time.perf_counter()
        out = mods["pretrain"].main(argv + ["--steps", "3"])
        dt = time.perf_counter() - t0
        counts = read_counts(fa, fc, fw)
        accum, val_steps = 2, 20
        bwd = n_layer * 3 * accum
        want = with_zeros({"flash_general_fwd": n_layer * (3 * accum + 2 * val_steps),
                           "flash_rowdot": bwd, "flash_general_dq": bwd,
                           "flash_general_dkv": bwd, "adamw": 3,
                           **ce_train(3 * accum, val=2 * val_steps)})
        print(f"  3 steps in {dt:.1f} s (val and HellaSwag at steps 0 and 2, samples, "
              f"checkpoints); launches {counts}", flush=True)
        require(counts == want, f"expected launches {want}, got {counts}")
        require(out["opt_state"]["step"] == 3 and math.isfinite(out["val_loss"])
                and out["model"].transformer.wpe.weight.shape[0] == 16384,
                "the long-context trainer did not take 3 finite steps at block_size 16384")

        def csv_rows():
            return [line.split(",")
                    for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                    for line in open(f).read().splitlines()[1:]]

        rows = csv_rows()
        phases = [r[1] for r in rows]
        hella = [(int(r[2]), float(r[8])) for r in rows if r[1] == "hella"]
        tps = [float(r[7]) for r in rows if r[1] == "train"]
        print(f"  CSV: {phases.count('train')} train rows (tokens/s {tps}), "
              f"{phases.count('val')} val rows, hella rows {hella}", flush=True)
        require(phases.count("train") == 3 and phases.count("val") == 2
                and [s for s, _ in hella] == [0, 2] and all(0 <= a <= 1 for _, a in hella),
                "the CSV does not hold 3 train, 2 val and 2 hella rows")
        ckpts = sorted(os.listdir(os.path.join(log_dir, "log", "ckpts")))
        print(f"  checkpoints: {ckpts}", flush=True)
        require("model_final.pt" in ckpts, "model_final was not written")

        reset_counts(fa, fc, fw)
        out = mods["pretrain"].main(argv + ["--steps", "4"])
        rows = csv_rows()
        steps = [int(r[2]) for r in rows if r[1] == "train"]
        resumed = read_counts(fa, fc, fw)
        print(f"  resumed: train steps logged {steps}, launches {resumed}, optimizer step "
              f"{out['opt_state']['step']}", flush=True)
        require(steps == [0, 1, 2, 3] and resumed["adamw"] == 1
                and resumed["flash_general_dq"] == n_layer * accum
                and resumed["flash_fwd"] == 0 and out["opt_state"]["step"] == 4,
                "the second call did not resume at step 3 and run one step")
        return counts, tps
    finally:
        tempfile.tempdir = old_tmp
        if old_hs is None:
            os.environ.pop("HELLASWAG_DIR", None)
        else:
            os.environ["HELLASWAG_DIR"] = old_hs
        shutil.rmtree(log_dir, ignore_errors=True)


def chunk_views(torch, b, tq, tk, h, dev, g, dtype=None):
    """q (B, Tq, H, 64) and k, v (B, Tk, H, 64) in ``dtype`` (bf16 by
    default) as the ring passes them: views of one fused (B, Tk + Tq,
    3 * H * 64) projection, K/V the first Tk positions and q the last Tq, so
    every sequence stride is the long tensor's; an output cotangent and a
    logsumexp cotangent."""
    hs, dtype = 64, dtype or torch.bfloat16
    qkv = torch.randn(b, tk + tq, 3 * h * hs, device=dev, generator=g).to(dtype)
    q, k, v = (a.view(b, tk + tq, h, hs) for a in qkv.split(h * hs, dim=-1))
    do = torch.randn(b, tq, h, hs, device=dev, generator=g).to(dtype)
    dlse = torch.randn(b, h, tq, device=dev, generator=g)
    return q[:, tk:], k[:, :tk], v[:, :tk], do, dlse


def phase_lse(torch, fa, dev):
    print("[15] lse-forward and one-pass backward kernels vs plain (bf16, chunk views)",
          flush=True)
    lse_tol, bwd_tol = 1e-3, 3e-2  # as the general family
    g = torch.Generator(dev).manual_seed(15)
    errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0, "bwd": 0.0, "dq_row": 0.0, "dkv_row": 0.0,
            "rerun": 0.0}
    times = {}
    # the last two as in phase 10: an offset that is no multiple of the tiles,
    # and ragged without a mask
    shapes = [(1, 4096, 4096, True), (1, 4096, 4096, False), (2, 1000, 1000, True),
              (2, 64, 2048, True), (2, 64, 2048, False), (4, 1, 1500, True),
              (2, 777, 1234, True), (3, 200, 200, False)]
    h = 12
    for b, tq, tk, causal in shapes:
        q, k, v, do, dlse = chunk_views(torch, b, tq, tk, h, dev, g)
        o, lse = fa.flash_lse_forward(q, k, v, causal=causal)
        ro, rlse = fa.flash_attention_with_lse_reference(q, k, v, causal=causal)
        dd = fa.flash_rowdot(do, o)
        dcap = dd - dlse
        got = fa.flash_fused_backward(q, k, v, do, lse, dcap, causal=causal)
        again = fa.flash_fused_backward(q, k, v, do, lse, dcap, causal=causal)
        want = fa.flash_fused_backward_reference(q, k, v, do, lse, dcap, causal=causal)
        no_dlse = fa.flash_fused_backward(q, k, v, do, lse, dd, causal=causal)
        torch.cuda.synchronize()
        eo, excess = out_excess(o, ro)
        erow, row_over = row_excess(o, ro)
        el = (lse - rlse).abs().max().item()
        eq, ek, ev = (rel_err(x, r) for x, r in zip(got, want))
        (rq, q_over), (rk, k_over), (rv, v_over) = (grad_row_excess(x, r)
                                                     for x, r in zip(got, want))
        control = max(rel_err(x, r) for x, r in zip(no_dlse, want))
        rerun = rel_err(again[0], got[0])
        finite = all(torch.isfinite(a.float()).all().item() for a in (o, lse, *got))
        print(f"  B={b} Tq={tq} Tk={tk} H={h} causal={causal}: out max|err| {eo:.3e} (tol 2e-2 "
              f"or one bf16 ulp), max row |err| / |ref| {erow:.3e} (tol 2^-6), lse max|err| "
              f"{el:.3e} (tol {lse_tol}); with a random lse "
              f"cotangent dq, dk, dv max|err| / max|ref| {eq:.3e}, {ek:.3e}, {ev:.3e} (tol "
              f"{bwd_tol}), dq, dk, dv max row |err| / (|ref| + 1e-3) {rq:.3e}, {rk:.3e}, "
              f"{rv:.3e} (tol 2^-6), control without it {control:.3e}; dq of two runs differs by "
              f"{rerun:.3e} of max|dq|", flush=True)
        require(finite, f"lse kernels gave a non-finite value at Tq={tq} Tk={tk}")
        require(excess <= 0 and row_over <= 0 and el <= lse_tol,
                f"lse forward Tq={tq} Tk={tk} disagrees")
        require(max(eq, ek, ev) <= bwd_tol and max(q_over, k_over, v_over) <= 0,
                f"one-pass backward Tq={tq} Tk={tk} disagrees")
        if tq == 4096 and not causal:
            # control: the last 128 rows as a K2a that dropped their last key
            # tile would give them; the row check must fail it
            r = slice(tq - 128, tq)
            dropped = fa.flash_attention_reference(q[:, r], k[:, :tk - 128], v[:, :tk - 128],
                                                   causal=False)[0]
            _, o_control = row_excess(o[:, r], dropped)
            _, loose = out_excess(o[:, r], dropped)
            print(f"  control: the last 128 rows without their last key tile pass the row "
                  f"tolerance by {o_control:.3e} (must be > 0), the elementwise one by "
                  f"{loose:.3e}", flush=True)
            require(o_control > 0, "K2a's o passed the row check against o without the last "
                    "key tile: the check cannot see a short key sweep")
        require(control > bwd_tol, "the backward without the lse cotangent passed the check: "
                "the check cannot see dcap")
        require(rerun <= bwd_tol and torch.equal(again[1], got[1])
                and torch.equal(again[2], got[2]),
                "two runs of the one-pass backward differ by more than its tolerance, or in "
                "dk/dv, which are summed in a fixed order")
        errs["o"], errs["lse"] = max(errs["o"], eo), max(errs["lse"], el)
        errs["o_row"], errs["dkv_row"] = max(errs["o_row"], erow), max(errs["dkv_row"], rk, rv)
        errs["dq_row"] = max(errs["dq_row"], rq)
        errs["bwd"], errs["rerun"] = max(errs["bwd"], eq, ek, ev), max(errs["rerun"], rerun)
        if tq == 1000:
            # the same through autograd: the Function forms dcap = D - dlse itself
            leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
            oo, ll = fa.flash_attention_with_lse(*leaves, causal=causal)
            torch.autograd.backward((oo, ll), (do, dlse))
            e = max(rel_err(a.grad, r) for a, r in zip(leaves, got))
            print(f"    through flash_attention_with_lse and autograd: grads differ from the "
                  f"direct launch by {e:.3e} of max|ref| (dq's run-to-run sum order only)",
                  flush=True)
            require(torch.equal(oo, o) and torch.equal(ll, lse) and e <= 1e-2,
                    "flash_attention_with_lse through autograd disagrees with the kernels")
        if tq == 4096:
            key = "causal" if causal else "nomask"
            print(f"  times at B={b} Tq={tq} Tk={tk} H={h} causal={causal}:", flush=True)
            fwd = interleaved(
                lambda: fa.flash_lse_forward(q, k, v, causal=causal),
                lambda: fa.flash_attention_with_lse_reference(q, k, v, causal=causal), 20, 3)
            bwd = interleaved(
                lambda: fa.flash_fused_backward(q, k, v, do, lse, dcap, causal=causal),
                lambda: fa.flash_fused_backward_reference(q, k, v, do, lse, dcap,
                                                          causal=causal), 20, 3)

            def split_bwd():
                fa.flash_general_dq(q, k, v, do, lse, dcap, causal=causal)
                fa.flash_general_dkv(q, k, v, do, lse, dcap, causal=causal)

            general = (cuda_ms(lambda: fa.flash_general_forward(q, k, v, causal=causal), 20),
                       cuda_ms(split_bwd, 20))
            print(f"  the general kernels on the same inputs: forward {general[0]:.4f} ms, "
                  f"dq + dk/dv {general[1]:.4f} ms", flush=True)
            times[key] = {"fwd": fwd, "bwd": bwd, "general_fwd_ms": general[0],
                          "general_bwd_ms": general[1]}
    return errs, times


def phase_ring_op(torch, mods, attention, dev):
    fa, fc, fw, ra = mods["fa"], mods["fc"], mods["fw"], mods["ra"]
    n, b, t, h, hs = 4, 1, 16384, 12, 64
    print(f"[16] ring attention as an op: {n} chunks at B={b}, T={t}, H={h}, forward and "
          f"backward through autograd", flush=True)
    tol = 3e-2
    g = torch.Generator(dev).manual_seed(16)

    def inputs(t):
        qkv = torch.randn(b, t, 3 * h * hs, device=dev, generator=g).to(torch.bfloat16)
        do = torch.randn(b, t, h, hs, device=dev, generator=g).to(torch.bfloat16)
        return qkv.requires_grad_(True), do

    def run(leaf, do, fn):
        """out and the gradient of the fused projection under cotangent do."""
        leaf.grad = None
        q, k, v = (a.view(b, leaf.shape[1], h, hs) for a in leaf.split(h * hs, dim=-1))
        out = fn(q, k, v)
        out.backward(do)
        return out.detach(), leaf.grad

    def grad_errs(got, want):
        return [rel_err(x, r) for x, r in zip(got.split(h * hs, dim=-1),
                                              want.split(h * hs, dim=-1))]

    ring = lambda impl: lambda q, k, v: ra.ring_attention(q, k, v, n, chunk_impl=impl)  # noqa: E731
    whole = lambda q, k, v: fa.flash_attention(q, k, v, causal=True)  # noqa: E731

    leaf, do = inputs(t)
    reset_counts(fa, fc, fw)
    out, grad = run(leaf, do, ring("auto"))
    torch.cuda.synchronize()
    launched = read_counts(fa, fc, fw)
    pairs = n * (n + 1) // 2
    print(f"  launches of one forward + backward: {launched}", flush=True)
    require(launched == with_zeros({"flash_lse_fwd": pairs, "flash_fused_bwd": pairs,
                                    "flash_rowdot": pairs}),
            f"expected {pairs} lse-forward, D and one-pass backward launches and no other")
    out_w, grad_w = run(leaf, do, whole)
    torch.cuda.synchronize()
    eo, excess = out_excess(out, out_w)
    ge = grad_errs(grad, grad_w)
    print(f"  against the general kernels on the whole sequence: out max|err| {eo:.3e} (tol "
          f"2e-2 or one bf16 ulp), dq, dk, dv max|err| / max|ref| "
          + ", ".join(f"{e:.3e}" for e in ge) + f" (tol {tol})", flush=True)
    require(excess <= 0 and max(ge) <= tol and torch.isfinite(grad.float()).all().item(),
            "ring attention disagrees with the whole-sequence kernels")
    ring_ms, whole_ms = interleaved(lambda: run(leaf, do, ring("auto")),
                                    lambda: run(leaf, do, whole), 3, 3)
    del leaf, do, out, grad, out_w, grad_w

    t2 = 2048
    leaf, do = inputs(t2)
    out_f, grad_f = run(leaf, do, ring("flash"))
    out_e, grad_e = run(leaf, do, ring("einsum"))
    out_p, grad_p = run(leaf, do, lambda q, k, v: attention.xla_sdpa(q, k, v, causal=True,
                                                                     layout="bthd"))
    # control: the kernels' backward without the lse cotangent
    real = fa._FlashAttnLse.backward
    fa._FlashAttnLse.backward = staticmethod(lambda ctx, do, dlse: real(ctx, do, None))
    try:
        _, grad_c = run(leaf, do, ring("flash"))
    finally:
        fa._FlashAttnLse.backward = staticmethod(real)
    torch.cuda.synchronize()
    checks = {"einsum-chunk ring": (out_excess(out_f, out_e), grad_errs(grad_f, grad_e)),
              "plain attention": (out_excess(out_f, out_p), grad_errs(grad_f, grad_p))}
    control = max(grad_errs(grad_c, grad_p))
    for name, ((eo2, ex2), ge2) in checks.items():
        print(f"  T={t2}, kernel-chunk ring against the {name}: out max|err| {eo2:.3e}, dq, dk, "
              f"dv max|err| / max|ref| " + ", ".join(f"{e:.3e}" for e in ge2)
              + f" (tol {tol})", flush=True)
        require(ex2 <= 0 and max(ge2) <= tol, f"ring attention disagrees with the {name}")
    print(f"  control, the lse cotangent dropped: {control:.3e} (must pass {tol})", flush=True)
    require(control > tol, "the ring without the lse cotangent passed the check")
    return {"ring_fwd_bwd_ms": ring_ms, "general_fwd_bwd_ms": whole_ms, "launches": launched}


def phase_ring_train_step(torch, np, gpt2, mods, cfgs, dev, whole):
    """`whole`: phase 13's result, the same step on the general kernels over the
    whole sequence, printed beside this one's."""
    accum, b, t, n = 2, 1, 16384, 4
    ra = mods["ra"]
    print(f"[17] ring train step: GPT-2 124M, block_size {t}, a ring of {n} chunks, bf16 "
          f"policy, {accum} x (B={b}, T={t}) per step", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"].replace(block_size=t)

    def make(model, attn_impl):
        step = mods["make_train_step"](
            lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:], policy=mods["policy"],
                                   attn_impl=attn_impl, ce_chunks=1),
            cfgs["opt"], cfgs["sched"], decay_mask=gpt2.decay_mask(model))
        return step, mods["adamw_init"](gpt2.named_params(model))

    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    rows = np.random.RandomState(17).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    step_r, state_r = make(model, "ring")
    pairs = accum * cfg.n_layer * n * (n + 1) // 2
    per_step = with_zeros({"flash_lse_fwd": pairs, "flash_rowdot": pairs,
                           "flash_fused_bwd": pairs, "adamw": 1, **ce_train(accum, 1)})
    n_tok = accum * b * t
    ra.set_ring(n)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, fc, fw)
        times = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step_r(model, state_r, batch, i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = read_counts(fa, fc, fw)
            print(f"  step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, lr "
                  f"{m['lr']:.4e}, {n_tok / times[-1]:.1f} tokens/s; launches {counts}",
                  flush=True)
            require(counts == {k: (i + 1) * v for k, v in per_step.items()},
                    f"expected {per_step} launches per step, got {counts} after {i + 1}")
            require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                    "ring train loss or grad norm is not finite")
            if i == 0:
                require(abs(m["loss"] - math.log(cfg.padded_vocab_size)) < 0.5,
                        "first ring loss is not near ln(V)")
        main_counts = read_counts(fa, fc, fw)
        tps = n_tok / times[1]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  tokens/s {tps:.1f} (step 1), peak device memory {peak:.2f} GiB; the general "
              f"kernels on the whole sequence (phase 13): {whole['tps']:.1f} tokens/s, "
              f"{whole['peak_gib']:.2f} GiB", flush=True)

        # one step from one state on the ring path, on the flash path (the general
        # kernels on the whole sequence), and on a ring whose merge drops its weights
        def twin():
            m2 = copy.deepcopy(model)
            step, state = make(m2, "flash")
            with torch.no_grad():
                for key in ("m", "v"):
                    for name, a in state_r[key].items():
                        state[key][name].copy_(a)
            state["step"] = state_r["step"]
            return m2, step, state

        flash_model, step_f, state_f = twin()
        ctrl_model, _, state_c = twin()
        step_c, _ = make(ctrl_model, "ring")
        idx = cfgs["sched"].warmup_steps  # the peak LR
        m_ring = step_r(model, state_r, batch, idx)
        reset_counts(fa, fc, fw)
        m_flash = step_f(flash_model, state_f, batch, idx)
        counts = read_counts(fa, fc, fw)
        whole = accum * cfg.n_layer
        require(counts == with_zeros({"flash_general_fwd": whole, "flash_rowdot": whole,
                                      "flash_general_dq": whole, "flash_general_dkv": whole,
                                      "adamw": 1, **ce_train(accum, 1)}),
                f"the flash-path step did not run on the general kernels: {counts}")
        real_merge = ra._merge
        ra._merge = lambda c, u: (c[0] + u[0], torch.logaddexp(c[1], u[1]))
        try:
            m_ctrl = step_c(ctrl_model, state_c, batch, idx)
        finally:
            ra._merge = real_merge
    finally:
        ra.set_ring(None)

    def diffs(m, other):
        sq = lambda ts: sum(x.float().square().sum().item() for x in ts)  # noqa: E731
        ref = [p.grad for p in flash_model.parameters()]
        dg = math.sqrt(sq(p.grad - r for p, r in zip(other.parameters(), ref)) / sq(ref))
        return (abs(m["loss"] - m_flash["loss"]),
                abs(m["grad_norm"] - m_flash["grad_norm"]) / m_flash["grad_norm"], dg)

    dl, dn, dg = diffs(m_ring, model)
    cl, cn, cg = diffs(m_ctrl, ctrl_model)
    print(f"  ring path vs flash path, one step from one state at lr {m_ring['lr']:.4e}: loss "
          f"{m_ring['loss']:.6f} vs {m_flash['loss']:.6f} (|diff| {dl:.3e}, tol 5e-3), "
          f"grad_norm {m_ring['grad_norm']:.6f} vs {m_flash['grad_norm']:.6f} (rel diff "
          f"{dn:.3e}, tol 2e-2), grads ||err|| / ||ref|| {dg:.3e} (tol 2e-2); control with the "
          f"merge weights dropped: loss |diff| {cl:.3e}, grad_norm rel diff {cn:.3e}, grads "
          f"{cg:.3e}", flush=True)
    require(dl <= 5e-3 and dn <= 2e-2 and dg <= 2e-2, "ring and flash train steps disagree")
    require(cg > 2e-2, "the control ring passed the check: it cannot see the merge")
    return {"tps": tps, "peak_gib": peak, "counts": main_counts}


def phase_ring_trainer(torch, mods, cfgs):
    print("[18] ring trainer: cli.pretrain --synthetic --seq-len 16384 --micro-batch 1 "
          "--attn-impl ring --tp 4, 2 steps of 32,768 tokens, then resume", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    n_layer, pairs = cfgs["gpt"].n_layer, 10  # chunk pairs of a ring of 4
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    old_tmp = tempfile.tempdir
    tempfile.tempdir = log_dir  # the synthetic shards go under it too
    try:
        argv = ["--synthetic", "--seq-len", "16384", "--micro-batch", "1", "--total-batch",
                "32768", "--no-hellaswag", "--log-dir", os.path.join(log_dir, "log")]
        ring = ["--attn-impl", "ring", "--tp", "4"]
        reset_counts(fa, fc, fw)
        t0 = time.perf_counter()
        out = mods["pretrain"].main(argv + ring + ["--steps", "2"])
        dt = time.perf_counter() - t0
        counts = read_counts(fa, fc, fw)
        accum, val_steps = 2, 20
        bwd = n_layer * pairs * 2 * accum
        want = with_zeros({"flash_lse_fwd": n_layer * pairs * (2 * accum + 2 * val_steps),
                           "flash_rowdot": bwd, "flash_fused_bwd": bwd, "adamw": 2,
                           **ce_train(2 * accum, val=2 * val_steps)})
        print(f"  2 steps in {dt:.1f} s (val at steps 0 and 1, samples, checkpoints); "
              f"launches {counts}", flush=True)
        require(counts == want, f"expected launches {want}, got {counts}")
        require(out["opt_state"]["step"] == 2 and math.isfinite(out["val_loss"])
                and out["model"].transformer.wpe.weight.shape[0] == 16384,
                "the ring trainer did not take 2 finite steps at block_size 16384")
        require(mods["ra"].RING is None, "the trainer left its ring installed")

        def csv_rows():
            return [line.split(",")
                    for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                    for line in open(f).read().splitlines()[1:]]

        rows = csv_rows()
        phases = [r[1] for r in rows]
        tps = [float(r[7]) for r in rows if r[1] == "train"]
        print(f"  CSV: {phases.count('train')} train rows (tokens/s {tps}), "
              f"{phases.count('val')} val rows", flush=True)
        require(phases.count("train") == 2 and phases.count("val") == 2,
                "the CSV does not hold 2 train and 2 val rows")
        require("model_final.pt" in os.listdir(os.path.join(log_dir, "log", "ckpts")),
                "model_final was not written")

        reset_counts(fa, fc, fw)
        out = mods["pretrain"].main(argv + ring + ["--steps", "3"])
        steps = [int(r[2]) for r in csv_rows() if r[1] == "train"]
        resumed = read_counts(fa, fc, fw)
        print(f"  resumed: train steps logged {steps}, launches {resumed}, optimizer step "
              f"{out['opt_state']['step']}", flush=True)
        require(steps == [0, 1, 2] and resumed["adamw"] == 1
                and resumed["flash_fused_bwd"] == n_layer * pairs * accum
                and resumed["flash_general_fwd"] == 0 and out["opt_state"]["step"] == 3,
                "the second call did not resume at step 2 and run one step on the ring")
        try:
            # Megatron TP runs over tp processes (phases 33-34); one refuses it
            mods["pretrain"].main(argv + ["--tp", "4", "--steps", "1"])
        except ValueError as e:
            require("runs over tp processes" in str(e), f"--tp 4 on one process: {e}")
            print(f"  --tp 4 without --attn-impl ring on one process: ValueError: {e}",
                  flush=True)
        else:
            raise RuntimeError("chip_smoke: --tp 4 on one process did not raise")
        return counts, tps
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(log_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# fp32 long context and the fp32 ring: the fp32 general and lse kernels
# ---------------------------------------------------------------------------


def general_hide(torch, tq, tk, causal, device, left=False, drop_last_tile=False):
    """(Tq, Tk) bool, True where a query does not see a key: the right-aligned
    causal mask (query i sees the keys j <= i + Tk - Tq), or none. The faults
    that phase 10b's controls stand for: ``left``, the causal mask aligned at
    the top left (j <= i), which agrees with the right one only at Tq == Tk;
    ``drop_last_tile``, the last key tile of 64 hidden from every row as
    well (a key sweep that stops one tile short at a ragged Tk)."""
    qpos = torch.arange(tq, device=device)[:, None] + (0 if left else tk - tq)
    kpos = torch.arange(tk, device=device)[None, :]
    hide = kpos > qpos if causal else torch.zeros(tq, tk, dtype=torch.bool, device=device)
    if drop_last_tile:
        hide = hide | (kpos >= (tk - 1) // 64 * 64)
    return hide


def f32_bwd_errs(got, want, causal_dq):
    """([max|err| / max|ref| of dq, dk, dv], [their f32_row_err]): phase 2c's
    rules. ``causal_dq``: dq's first row is 0 in exact arithmetic (a causal
    Tq == Tk) and is left to the elementwise rule."""
    rels = [rel_err(x, r) for x, r in zip(got, want)]
    rows = [f32_row_err(x, r, causal_dq=causal_dq and i == 0)
            for i, (x, r) in enumerate(zip(got, want))]
    return rels, rows


def f32_control_errs(torch, q, k, v, do, lse, dd, o, got, hide):
    """(the forward's o, the backward's dq, dk, dv) of a kernel against the
    plain version with the (Tq, Tk) bool mask ``hide``, by the row rules of
    phases 2b and 2c: (f32_fwd_row_err of o, the largest f32_row_err of the
    three gradients). A control's mask must fail both."""
    fwd = f32_fwd_row_err(o, masked_fwd_reference(torch, q, k, v, slice(None), hide))
    ctrl = masked_bwd_reference(torch, q, k, v, do, lse, dd, hide)
    return fwd, max(f32_row_err(x, r) for x, r in zip(got, ctrl))


# phase 10b's shapes (B, Tq, Tk, causal): the long-context layer, a ragged
# pair with Tq != Tk with the mask and without, a single query row, a short
# query tile, a pair of several thousand whose Tk is no multiple of 64, and
# an unmasked Tq == Tk whose heads do not fill the backward's last round of
# whole heads (24 heads of 16 key tiles over 264 resident blocks: rounds of
# 16 heads, the second half empty)
GENERAL_F32_SHAPES = ((1, 16384, 16384, True), (2, 130, 385, True), (2, 130, 385, False),
                      (4, 1, 193, True), (2, 64, 256, True), (1, 3000, 4133, True),
                      (2, 1024, 1024, False))
# runs on one input that must agree bit for bit: of the fp32 general and lse
# backwards (phases 10b and 15b) and the fp32 dt backward (phase 19b), whose
# query tiles sum dq from many key tiles in a fixed order that the kernel
# keeps across blocks, and of the split fp32 lse forward (phase 15b), whose
# parts are merged in a fixed order
F32_BWD_RUNS = 5


def phase_general_f32(torch, fa, dev):
    print("[10b] the general kernels on fp32 operands (csrc/flash_general_fwd_f32.cu, "
          "flash_general_bwd_f32.cu, the fp32 D) vs plain (fp32, no TF32)", flush=True)
    import torch.nn.functional as F

    g = torch.Generator(dev).manual_seed(101)
    errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0, "dd": 0.0, "max_rel": 0.0, "row": 0.0,
            "controls": {}}
    timing = {}
    for b, tq, tk, causal in GENERAL_F32_SHAPES:
        h = 12
        q, k, v, do = qkv_inputs(torch, b, tq, tk, h, dev, g, dtype=torch.float32)
        n0 = (fa.flash_general_forward_f32.launches, fa.flash_rowdot_f32.launches,
              fa.flash_general_backward_f32.launches)
        o, lse = fa.flash_general_forward_f32(q, k, v, causal=causal)
        o2, lse2 = fa.flash_general_forward_f32(q, k, v, causal=causal)
        dd = fa.flash_rowdot(do, o)
        got = fa.flash_general_backward_f32(q, k, v, do, lse, dd, causal=causal)
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        for _ in range(F32_BWD_RUNS - 1):
            again = fa.flash_general_backward_f32(q, k, v, do, lse, dd, causal=causal)
            same = same and all(torch.equal(x, y) for x, y in zip(got, again))
            del again
        torch.cuda.synchronize()
        require((fa.flash_general_forward_f32.launches, fa.flash_rowdot_f32.launches,
                 fa.flash_general_backward_f32.launches)
                == (n0[0] + 2, n0[1] + 1, n0[2] + F32_BWD_RUNS),
                "the fp32 general kernels did not run")
        del o2, lse2
        ro, rlse = fwd_by_heads(torch, fa, q, k, v, causal)
        rdd = fa.rowdot_reference(do, o)
        want = bwd_by_heads(torch, fa, q, k, v, None, lse, do, causal, dd=dd)
        torch.cuda.synchronize()
        eo, el = (o - ro).abs().max().item(), (lse - rlse).abs().max().item()
        erow = f32_fwd_row_err(o, ro)
        edd = ((dd - rdd).abs().max() / rdd.abs().max()).item()
        rels, rows = f32_bwd_errs(got, want, causal and tq == tk)
        print(f"  B={b} Tq={tq} Tk={tk} H={h} {'causal' if causal else 'no mask'}: o max|err| "
              f"{eo:.3e}, lse {el:.3e} (tol {F32_TOL}), max row |err| / |ref| {erow:.3e} (tol "
              f"{F32_ROW_TOL}); D max|err| / max|ref| {edd:.3e}; dq, dk, dv max|err| / max|ref| "
              + ", ".join(f"{e:.3e}" for e in rels) + f" (tol {F32_TOL}), max row |err| / "
              "(|ref| + mean row norm) " + ", ".join(f"{r:.3e}" for r in rows)
              + f" (tol {F32_ROW_TOL}); the backward bit-equal over {F32_BWD_RUNS} runs, the "
              f"forward twice: {same}", flush=True)
        require(all(x.dtype == torch.float32 for x in (o, *got)), "the fp32 kernels are not fp32")
        require(max(eo, el, edd) <= F32_TOL and erow <= F32_ROW_TOL,
                f"the fp32 general forward or D disagrees at B={b} Tq={tq} Tk={tk}")
        require(max(rels) <= F32_TOL and max(rows) <= F32_ROW_TOL,
                f"the fp32 general backward disagrees at B={b} Tq={tq} Tk={tk}")
        require(same, f"two runs of the fp32 general kernels differ at Tq={tq} Tk={tk}")
        errs["o"], errs["lse"] = max(errs["o"], eo), max(errs["lse"], el)
        errs["o_row"], errs["dd"] = max(errs["o_row"], erow), max(errs["dd"], edd)
        errs["max_rel"], errs["row"] = max(errs["max_rel"], *rels), max(errs["row"], *rows)
        # controls, each a fault the checks above must see: the causal mask
        # aligned at the top left where Tq != Tk; the last key tile dropped at
        # a ragged Tk
        ctrl = {}
        if (tq, tk, causal) == (130, 385, True):
            ctrl["left_aligned_mask"] = general_hide(torch, tq, tk, True, dev, left=True)
        if (tq, tk) == (3000, 4133):
            ctrl["last_key_tile_dropped"] = general_hide(torch, tq, tk, causal, dev,
                                                         drop_last_tile=True)
        for name, hide in ctrl.items():
            fwd_c, bwd_c = f32_control_errs(torch, q, k, v, do, lse, dd, o, got, hide)
            print(f"  control {name}: o max row |err| / |ref| {fwd_c:.3e}, dq/dk/dv max row "
                  f"|err| / (|ref| + mean row norm) {bwd_c:.3e} (both must be > {F32_ROW_TOL})",
                  flush=True)
            require(fwd_c > F32_ROW_TOL and bwd_c > F32_ROW_TOL,
                    f"the control {name} passed the fp32 general kernels' row checks")
            errs["controls"][name] = {"o_row": fwd_c, "grad_row": bwd_c}
        if tq == 16384:
            timing["fwd"] = interleaved(
                lambda: fa.flash_general_forward_f32(q, k, v, causal=True),
                lambda: fwd_by_heads(torch, fa, q, k, v, True), 5, 1)
            timing["dd"] = interleaved(lambda: fa.flash_rowdot(do, o),
                                       lambda: fa.rowdot_reference(do, o), 20, 5)
            timing["bwd"] = interleaved(
                lambda: fa.flash_general_backward_f32(q, k, v, do, lse, dd, causal=True),
                lambda: bwd_by_heads(torch, fa, q, k, v, None, lse, do, True, dd=dd), 3, 1)
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            timing["sdpa_fwd_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 5)
            leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            dot = do.transpose(1, 2)
            timing["sdpa_bwd_ms"] = cuda_ms(
                lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True), 3)
            del qt, kt, vt, leaves, out
        del q, k, v, do, o, lse, dd, got, want, ro, rlse
    torch.cuda.empty_cache()
    return errs, timing


# phase 15b's shapes (B, Tq, Tk, causal), H=12, chunk views: the ring's two
# chunk pairs, and a pair whose query tiles split into uneven parts (both
# lengths ragged: 51 to 65 visible key tiles a query tile, parts of at most
# ceil(65 / parts) tiles)
LSE_F32_SHAPES = ((1, 4096, 4096, False), (1, 4096, 4096, True), (1, 1000, 4133, True))


def lse_dropped_part(torch, fa, q, k, v, causal, parts):
    """o of K2a's fp32 split-and-merge in plain PyTorch with the last part of
    every query tile of several left out of its merge: the fault that phase
    15b's control stands for."""
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for rows, pts in fa.lse_f32_parts_reference(q, k, v, causal=causal, parts=parts):
        o[:, rows] = fa.merge_lse_parts(pts[:-1] if len(pts) > 1 else pts)[0]
    return o


def phase_lse_f32(torch, fa, dev):
    print("[15b] the lse kernels on fp32 operands (csrc/flash_lse_fwd_f32.cu, "
          "flash_general_bwd_f32.cu) on the ring's chunk pairs (B=1, Tq=Tk=4096, H=12, chunk "
          "views) and an uneven split, with a non-zero lse cotangent, vs plain (fp32, no TF32)",
          flush=True)
    import torch.nn.functional as F

    g = torch.Generator(dev).manual_seed(151)
    errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0, "max_rel": 0.0, "row": 0.0, "controls": {},
            "parts": {}}
    timing = {}
    slots = fa._lse_f32_slots(dev.index)
    for b, tq, tk, causal in LSE_F32_SHAPES:
        h = 12
        key = ("causal" if causal else "nomask") + ("" if tq == tk else f"_Tq{tq}_Tk{tk}")
        parts = fa.lse_f32_parts(b * h, tq, tk, causal, slots)
        errs["parts"][key] = parts
        q, k, v, do, dlse = chunk_views(torch, b, tq, tk, h, dev, g, dtype=torch.float32)
        n0 = (fa.flash_lse_forward_f32.launches, fa.flash_fused_backward_f32.launches)
        o, lse = fa.flash_lse_forward_f32(q, k, v, causal=causal)
        same = True
        for _ in range(F32_BWD_RUNS - 1):
            o2, lse2 = fa.flash_lse_forward_f32(q, k, v, causal=causal)
            same = same and torch.equal(o, o2) and torch.equal(lse, lse2)
            del o2, lse2
        dcap = (fa.flash_rowdot(do, o) - dlse).contiguous()  # as _FlashAttnLse.backward forms it
        got = fa.flash_fused_backward_f32(q, k, v, do, lse, dcap, causal=causal)
        for _ in range(F32_BWD_RUNS - 1):
            again = fa.flash_fused_backward_f32(q, k, v, do, lse, dcap, causal=causal)
            same = same and all(torch.equal(x, y) for x, y in zip(got, again))
            del again
        torch.cuda.synchronize()
        require((fa.flash_lse_forward_f32.launches, fa.flash_fused_backward_f32.launches)
                == (n0[0] + F32_BWD_RUNS, n0[1] + F32_BWD_RUNS),
                "the fp32 lse kernels did not run")
        ro, rlse = fwd_by_heads(torch, fa, q, k, v, causal)
        want = bwd_by_heads(torch, fa, q, k, v, None, lse, do, causal, dd=dcap)
        # controls: the lse cotangent dropped (dcap = D), as a backward that
        # ignores it would give; the merge without each split query tile's
        # last part
        dd = fa.rowdot_reference(do, o)
        ctrl = bwd_by_heads(torch, fa, q, k, v, None, lse, do, causal, dd=dd)
        merge_ctrl = (f32_fwd_row_err(o, lse_dropped_part(torch, fa, q, k, v, causal, parts))
                      if parts > 1 else None)
        torch.cuda.synchronize()
        eo, el = (o - ro).abs().max().item(), (lse - rlse).abs().max().item()
        erow = f32_fwd_row_err(o, ro)
        rels, rows = f32_bwd_errs(got, want, causal and tq == tk)
        control = max(f32_row_err(x, r) for x, r in zip(got, ctrl))
        print(f"  {key}: {parts} parts a query tile; o max|err| {eo:.3e}, lse {el:.3e} (tol "
              f"{F32_TOL}), max row |err| / |ref| {erow:.3e} (tol {F32_ROW_TOL}); dq, dk, dv "
              "max|err| / max|ref| " + ", ".join(f"{e:.3e}" for e in rels) + f" (tol "
              f"{F32_TOL}), max row |err| / (|ref| + mean row norm) "
              + ", ".join(f"{r:.3e}" for r in rows) + f" (tol {F32_ROW_TOL}); both kernels "
              f"bit-equal over {F32_BWD_RUNS} runs: {same}; control without the lse cotangent "
              f"{control:.3e}, merge without the last part "
              + ("(one part)" if merge_ctrl is None else f"{merge_ctrl:.3e}")
              + f" (must be > {F32_ROW_TOL})", flush=True)
        require(max(eo, el) <= F32_TOL and erow <= F32_ROW_TOL,
                f"the fp32 lse forward disagrees on the {key} pair")
        require(max(rels) <= F32_TOL and max(rows) <= F32_ROW_TOL,
                f"the fp32 one-pass backward disagrees on the {key} pair")
        require(same, f"two runs of the fp32 lse kernels differ on the {key} pair")
        require(control > F32_ROW_TOL, "the fp32 one-pass backward passed the check against "
                "the plain backward without the lse cotangent")
        require(merge_ctrl is None or merge_ctrl > F32_ROW_TOL,
                "the fp32 lse forward passed the check against a merge without a part")
        errs["o"], errs["lse"] = max(errs["o"], eo), max(errs["lse"], el)
        errs["o_row"] = max(errs["o_row"], erow)
        errs["max_rel"], errs["row"] = max(errs["max_rel"], *rels), max(errs["row"], *rows)
        errs["controls"][f"{key}_without_dlse"] = control
        if merge_ctrl is not None:
            errs["controls"][f"{key}_merge_without_last_part"] = merge_ctrl
        if tq == tk:
            fwd_t = interleaved(lambda: fa.flash_lse_forward_f32(q, k, v, causal=causal),
                                lambda: fa.flash_attention_reference(q, k, v, causal=causal),
                                10, 2)
            bwd_t = interleaved(
                lambda: fa.flash_fused_backward_f32(q, k, v, do, lse, dcap, causal=causal),
                lambda: fa.flash_fused_backward_reference(q, k, v, do, lse, dcap,
                                                          causal=causal),
                10, 2)
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            dot = do.transpose(1, 2)
            timing[key] = {
                "fwd": fwd_t, "bwd": bwd_t,
                "sdpa_fwd_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 10),
                "sdpa_bwd_ms": cuda_ms(lambda: torch.autograd.grad(out, leaves, dot,
                                                                   retain_graph=True), 10)}
            del qt, kt, vt, leaves, out
        del q, k, v, do, dlse, o, lse, dcap, got, want, ctrl, ro, rlse
    torch.cuda.empty_cache()
    return errs, timing


def fp32_steps(torch, gpt2, mods, cfgs, cfg, model, attn_impl, ce_impl="auto", fused=True):
    """make_train_step under FP32_POLICY on ``model`` (the trainer's loss:
    ce_chunks 8) and a fresh AdamW state."""
    step = mods["make_train_step"](
        lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:], policy=mods["fp32_policy"],
                               attn_impl=attn_impl, ce_impl=ce_impl),
        cfgs["opt"], cfgs["sched"], decay_mask=gpt2.decay_mask(model), use_fused_adamw=fused)
    return step, mods["adamw_init"](gpt2.named_params(model))


def timed_steps(torch, mods, step, model, state, batch, per_step, n_steps, label):
    """n_steps of ``step`` with the launch counts checked after each:
    (the metrics of each step, its wall seconds, the counts)."""
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    n_tok = batch.shape[0] * batch.shape[1] * (batch.shape[2] - 1)
    reset_counts(fa, fc, fw)
    ms, times = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms.append(step(model, state, batch, i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts(fa, fc, fw)
        m = ms[-1]
        print(f"  step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
              f"{n_tok / times[-1]:.1f} tokens/s; launches "
              f"{ {k_: v_ for k_, v_ in counts.items() if v_} }", flush=True)
        require(counts == {k_: (i + 1) * v_ for k_, v_ in per_step.items()},
                f"{label}: expected {per_step} launches per step, got {counts} after {i + 1}")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"{label}: loss or grad norm is not finite")
    return ms, times, read_counts(fa, fc, fw)


def phase_fp32_long_train_step(torch, np, gpt2, mods, cfgs, dev):
    accum, b, t = 2, 1, 16384
    print(f"[13b] long-context train step under FP32_POLICY: GPT-2 124M, block_size {t}, "
          f"{accum} x (B={b}, T={t}) per step, attn_impl auto", flush=True)
    cfg = cfgs["gpt"].replace(block_size=t)
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    rows = np.random.RandomState(131).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    step, state = fp32_steps(torch, gpt2, mods, cfgs, cfg, model, "auto")
    n = accum * cfg.n_layer
    per_step = with_zeros({"flash_general_fwd_f32": n, "flash_rowdot_f32": n,
                           "flash_general_bwd_f32": n, "adamw": 1})
    torch.cuda.reset_peak_memory_stats()
    ms, times, counts = timed_steps(torch, mods, step, model, state, batch, per_step, 2,
                                    "the fp32 long-context step")
    require(abs(ms[0]["loss"] - math.log(cfg.padded_vocab_size)) < 0.5,
            "the first fp32 long-context loss is not near ln(V)")
    tps = accum * b * t / times[1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  tokens/s {tps:.1f} (step 1), peak device memory {peak:.2f} GiB", flush=True)
    out = {"tps": tps, "peak_gib": peak, "counts": counts, "first_step_s": times[0]}
    del model, state, step, batch
    torch.cuda.empty_cache()

    # against the plain paths where fp32 einsum attention fits: full width, 2
    # layers, T just above the self-attention kernels' longest; the fp32
    # tolerances of phase 29 for the loss, the grad norm and the grads, and
    # the update against the plain AdamW
    t2 = 8320
    cfg2 = cfgs["gpt"].replace(block_size=t2, n_layer=2)
    print(f"  kernel path vs plain paths at {cfg2.n_layer} layers, B=1, T={t2}, FP32_POLICY:",
          flush=True)
    model = gpt2.init(cfg2, generator=torch.Generator(dev).manual_seed(1339), device=dev)
    plain_model = copy.deepcopy(model)
    rows = np.random.RandomState(132).randint(0, cfg2.vocab_size, (1, 1, t2 + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    kernel = (model, *reversed(fp32_steps(torch, gpt2, mods, cfgs, cfg2, model, "auto")))
    plain = (plain_model, *reversed(fp32_steps(torch, gpt2, mods, cfgs, cfg2, plain_model,
                                               "xla", "xla", False)))
    kernel[2](model, kernel[1], batch, 0)  # one step first, so the moments are not zero
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    reset_counts(fa, fc, fw)
    out["vs_plain_T8320_2_layers"] = compare_train_steps(
        torch, gpt2, mods, cfgs, kernel, plain, batch, tols=(1e-4, 1e-4, 1e-4))
    got = read_counts(fa, fc, fw)
    require(got == with_zeros({"flash_general_fwd_f32": 2, "flash_rowdot_f32": 2,
                               "flash_general_bwd_f32": 2, "adamw": 1}),
            f"the T={t2} fp32 kernel-path step did not run on the fp32 general kernels: {got}")
    del model, plain_model, kernel, plain, batch
    torch.cuda.empty_cache()
    return out


def phase_fp32_ring_train_step(torch, np, gpt2, mods, cfgs, dev, whole):
    """`whole`: phase 13b's result, printed beside this one's."""
    accum, b, t, n = 2, 1, 16384, 4
    ra, fa, fc, fw = mods["ra"], mods["fa"], mods["fc"], mods["fw"]
    print(f"[17b] ring train step under FP32_POLICY: GPT-2 124M, block_size {t}, a ring of {n} "
          f"chunks, {accum} x (B={b}, T={t}) per step", flush=True)
    cfg = cfgs["gpt"].replace(block_size=t)
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    rows = np.random.RandomState(171).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    step_r, state_r = fp32_steps(torch, gpt2, mods, cfgs, cfg, model, "ring")
    pairs = accum * cfg.n_layer * n * (n + 1) // 2
    per_step = with_zeros({"flash_lse_fwd_f32": pairs, "flash_rowdot_f32": pairs,
                           "flash_fused_bwd_f32": pairs, "adamw": 1})
    ra.set_ring(n)
    try:
        torch.cuda.reset_peak_memory_stats()
        ms, times, counts = timed_steps(torch, mods, step_r, model, state_r, batch, per_step, 2,
                                        "the fp32 ring step")
        tps = accum * b * t / times[1]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  tokens/s {tps:.1f} (step 1), peak device memory {peak:.2f} GiB; the fp32 "
              f"general kernels on the whole sequence (phase 13b): {whole['tps']:.1f} tokens/s, "
              f"{whole['peak_gib']:.2f} GiB", flush=True)

        # one step from one state on the ring, on the whole sequence (phase
        # 13b's path, the fp32 general kernels), and on a ring whose merge
        # drops its weights
        def twin(attn_impl):
            m2 = copy.deepcopy(model)
            step, state = fp32_steps(torch, gpt2, mods, cfgs, cfg, m2, attn_impl)
            with torch.no_grad():
                for key in ("m", "v"):
                    for name, a in state_r[key].items():
                        state[key][name].copy_(a)
            state["step"] = state_r["step"]
            return m2, step, state

        flash_model, step_f, state_f = twin("auto")
        ctrl_model, step_c, state_c = twin("ring")
        idx = cfgs["sched"].warmup_steps  # the peak LR
        m_ring = step_r(model, state_r, batch, idx)
        reset_counts(fa, fc, fw)
        m_flash = step_f(flash_model, state_f, batch, idx)
        got = read_counts(fa, fc, fw)
        w = accum * cfg.n_layer
        require(got == with_zeros({"flash_general_fwd_f32": w, "flash_rowdot_f32": w,
                                   "flash_general_bwd_f32": w, "adamw": 1}),
                f"the whole-sequence fp32 step did not run on the fp32 general kernels: {got}")
        real_merge = ra._merge
        ra._merge = lambda c, u: (c[0] + u[0], torch.logaddexp(c[1], u[1]))
        try:
            m_ctrl = step_c(ctrl_model, state_c, batch, idx)
        finally:
            ra._merge = real_merge
    finally:
        ra.set_ring(None)

    def diffs(m, other):
        sq = lambda ts: sum(x.float().square().sum().item() for x in ts)  # noqa: E731
        ref = [p.grad for p in flash_model.parameters()]
        dg = math.sqrt(sq(p.grad - r for p, r in zip(other.parameters(), ref)) / sq(ref))
        return (abs(m["loss"] - m_flash["loss"]),
                abs(m["grad_norm"] - m_flash["grad_norm"]) / m_flash["grad_norm"], dg)

    dl, dn, dg = diffs(m_ring, model)
    cl, cn, cg = diffs(m_ctrl, ctrl_model)
    print(f"  fp32 ring vs the fp32 whole sequence, one step from one state on one batch at lr "
          f"{m_ring['lr']:.4e}: loss {m_ring['loss']:.6f} vs {m_flash['loss']:.6f} (|diff| "
          f"{dl:.3e}, tol 1e-4), grad_norm rel diff {dn:.3e} (tol 1e-4), grads ||err|| / "
          f"||ref|| {dg:.3e} (tol 1e-4); control with the merge weights dropped: loss |diff| "
          f"{cl:.3e}, grad_norm {cn:.3e}, grads {cg:.3e}", flush=True)
    require(dl <= 1e-4 and dn <= 1e-4 and dg <= 1e-4,
            "the fp32 ring and whole-sequence train steps disagree")
    require(cg > 1e-4, "the control ring passed the check: it cannot see the merge")
    del model, flash_model, ctrl_model, state_r, state_f, state_c, batch
    torch.cuda.empty_cache()
    return {"tps": tps, "peak_gib": peak, "counts": counts,
            "vs_whole": {"loss_abs_err": dl, "grad_norm_rel_err": dn, "grads_rel_l2": dg,
                         "control_grads_rel_l2": cg}}


def phase_fp32_trainers(torch, mods, cfgs):
    print("[18b] train.pretrain.run_pretrain(cfg, device='cuda', policy=FP32_POLICY, "
          "max_steps_override=2), cfg from cli.pretrain --synthetic --seq-len 16384 "
          "--micro-batch 1 --total-batch 32768: --attn-impl flash, and --attn-impl ring --tp 4",
          flush=True)
    from gpt2_vision_language_tpu_torch.train.pretrain import run_pretrain

    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    n_layer, pairs, accum, steps = cfgs["gpt"].n_layer, 10, 2, 2
    runs = {}
    for form, extra, fwd, n_att in (
            ("flash", ["--attn-impl", "flash"], "flash_general_fwd_f32", 1),
            ("ring", ["--attn-impl", "ring", "--tp", "4"], "flash_lse_fwd_f32", pairs)):
        log_dir = tempfile.mkdtemp(prefix=f"chip_smoke_fp32_{form}_")
        old_tmp = tempfile.tempdir
        tempfile.tempdir = log_dir  # the synthetic shards go under it too
        try:
            cfg, _ = mods["pretrain"].parse_and_build(
                ["--synthetic", "--seq-len", "16384", "--micro-batch", "1", "--total-batch",
                 "32768", "--no-hellaswag", "--log-dir", os.path.join(log_dir, "log")] + extra)
            reset_counts(fa, fc, fw)
            t0 = time.perf_counter()
            out = run_pretrain(cfg, device="cuda", policy=mods["fp32_policy"],
                               max_steps_override=steps)
            dt = time.perf_counter() - t0
            counts = read_counts(fa, fc, fw)
            bwd = "flash_general_bwd_f32" if form == "flash" else "flash_fused_bwd_f32"
            n_bwd = n_layer * n_att * accum * steps
            want = with_zeros({fwd: n_layer * n_att * (accum * steps + 2 * cfg.val_steps),
                               "flash_rowdot_f32": n_bwd, bwd: n_bwd, "adamw": steps,
                               "ce_fwd": counts["ce_fwd"]})
            rows = [line.split(",")
                    for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                    for line in open(f).read().splitlines()[1:]]
            train = [(int(r[2]), float(r[3]), float(r[7])) for r in rows if r[1] == "train"]
            val = [float(r[3]) for r in rows if r[1] == "val"]
            print(f"  {form}: {steps} steps in {dt:.1f} s (val at steps 0 and 1, samples, "
                  f"checkpoints); train rows (step, loss, tokens/s) {train}, val losses {val}; "
                  f"launches { {k_: v_ for k_, v_ in counts.items() if v_} }", flush=True)
            require(counts == want, f"fp32 trainer ({form}): expected launches {want}, got "
                    f"{counts}")
            require(out["opt_state"]["step"] == steps and math.isfinite(out["val_loss"])
                    and out["model"].transformer.wpe.weight.dtype == torch.float32
                    and out["model"].transformer.wpe.weight.shape[0] == 16384,
                    f"fp32 trainer ({form}) did not take {steps} finite steps at block_size "
                    "16384")
            require([s for s, _, _ in train] == list(range(steps)) and len(val) == 2
                    and all(math.isfinite(x) for _, x, _ in train)
                    and all(math.isfinite(x) for x in val),
                    f"fp32 trainer ({form}): the CSV does not hold {steps} finite train rows and "
                    "2 finite val rows")
            require(mods["ra"].RING is None, "the trainer left its ring installed")
            runs[form] = {"counts": counts, "seconds": dt, "train_rows": train, "val": val}
        finally:
            tempfile.tempdir = old_tmp
            shutil.rmtree(log_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return runs


def dt_inputs(torch, ab, dev, seed, dtype="bf16"):
    """The tool's own inputs at its bench shape: q (pre-scaled), k, v, dO in the
    dt layout (H, 64, B*T) in ``dtype`` (bf16, or fp32 where the checkout has
    the fp32 dt kernels), the (B, T, H, hs) strided views they were copied
    from, and the shape."""
    qkv, dout, (b, h, t, hs) = (ab._bench_inputs(dev, seed) if dtype == "bf16"
                                else ab._bench_inputs(dev, seed, dtype))
    q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
    scale = hs ** -0.5
    dt = (ab.to_dt(q * scale), ab.to_dt(k), ab.to_dt(v), ab.to_dt(dout))
    return dt, (q, k, v, dout), (b, h, t, hs)


def dt_fwd_by_heads(torch, ab, qd, kd, vd, b, tq, tk, heads=4):
    """The plain dt forward, `heads` heads at a time (its (H, B, Tq, Tk) fp32
    scores do not fit at once at T=8192, H=12): (o, lse)."""
    return tuple(_dt_by_heads(torch, lambda q, k, v: ab.flash_fwd_dt_b_reference(
        q, k, v, b, tq, tk, causal=True), (qd, kd, vd), heads))


def dt_rows_without_first_keys(torch, qd, kd, vd, t, rows=128, skip=128):
    """The plain dt forward of the last `rows` queries of a B=1 input without
    their first `skip` keys, causal: what a kernel whose sweep starts one key
    tile late would give them. (H, hs, rows) in qd's dtype."""
    q, k, v = qd[:, :, t - rows:].float(), kd[:, :, skip:].float(), vd[:, :, skip:].float()
    s = torch.einsum("hdq,hdk->hqk", q, k)
    qpos = torch.arange(t - rows, t, device=qd.device)[:, None]
    kpos = torch.arange(skip, t, device=qd.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)).to(vd.dtype).float()
    return torch.einsum("hqk,hdk->hdq", p, v).to(qd.dtype)


def dt_row_excess(o, ref):
    """``row_excess`` over the rows of a dt-layout (H, hs, N) output: each
    position's hs values."""
    return row_excess(o.transpose(1, 2), ref.transpose(1, 2))


def dt_grad_row_excess(x, ref):
    """``grad_row_excess`` over the rows of a dt-layout (H, hs, N) gradient:
    each position's hs values (a query row of dq, a key row of dk or dv)."""
    return grad_row_excess(x.transpose(1, 2), ref.transpose(1, 2))


def _dt_grads(torch, qd, kd, vd, dod, lse, dcap, b, tq, tk, hide, dq_scale, want):
    """The arithmetic of ``flash_bwd_dt_b_reference`` (causal) on one group of
    heads, with the extra (Tq, Tk) mask ``hide`` (None: none): the gradients
    named in ``want`` ("dq", "dk", "dv"), in the operands' dtypes."""
    h, hs, _ = qd.shape
    q4, do4 = (a.float().reshape(h, hs, b, tq) for a in (qd, dod))
    k4, v4 = (a.float().reshape(h, hs, b, tk) for a in (kd, vd))
    s = torch.einsum("hdbq,hdbk->hbqk", q4, k4)
    qpos = torch.arange(tq, device=qd.device)[:, None]
    kpos = torch.arange(tk, device=qd.device)[None, :]
    mask = kpos > qpos if hide is None else (kpos > qpos) | hide
    p = torch.exp(s.masked_fill(mask, float("-inf")) - lse.reshape(h, b, tq, 1))
    del s
    out = {}
    if "dv" in want:
        out["dv"] = torch.einsum("hbqk,hdbq->hdbk", p.to(dod.dtype).float(), do4).reshape(
            h, hs, b * tk).to(vd.dtype)
    dp = torch.einsum("hdbq,hdbk->hbqk", do4, v4)
    ds = (p * (dp - dcap.reshape(h, b, tq, 1))).to(qd.dtype).float()
    del p, dp
    if "dk" in want:
        out["dk"] = torch.einsum("hbqk,hdbq->hdbk", ds, q4).reshape(h, hs, b * tk).to(kd.dtype)
    if "dq" in want:
        out["dq"] = (torch.einsum("hbqk,hdbk->hdbq", ds, k4) * dq_scale).reshape(
            h, hs, b * tq).to(qd.dtype)
    return [out[n] for n in want]


def _dt_by_heads(torch, fn, xs, heads):
    """fn over the heads `heads` at a time; each of its outputs concatenated
    along the head axis."""
    parts = [fn(*(a[i:i + heads] for a in xs)) for i in range(0, xs[0].shape[0], heads)]
    return [torch.cat([p[j] for p in parts]) for j in range(len(parts[0]))]


def dt_dkv_reference(torch, qd, kd, vd, dod, lse, dcap, b, tq, tk, drop_after=None, tile=128,
                     heads=2):
    """dk and dv of the plain dt backward (``flash_bwd_dt_b_reference``'s
    arithmetic on the kernels' lse and dcap), `heads` heads at a time: the
    dt form of ``dkv_reference``. With ``drop_after``, a query ``drop_after``
    or more positions past the first key of a key's 128-key tile adds nothing
    to that key: what a dk/dv block whose key tiles stop their query sweep
    that early would give, the control that the row check must fail."""
    hide = None
    if drop_after is not None:
        qpos = torch.arange(tq, device=qd.device)[:, None]
        kpos = torch.arange(tk, device=qd.device)[None, :]
        hide = qpos >= kpos // tile * tile + drop_after
    return _dt_by_heads(torch, lambda q, k, v, do, ls, dc: _dt_grads(
        torch, q, k, v, do, ls, dc, b, tq, tk, hide, 1.0, ("dk", "dv")),
        (qd, kd, vd, dod, lse, dcap), heads)


def dt_dq_reference(torch, qd, kd, vd, dod, lse, dcap, b, tq, tk, dq_scale=1.0,
                    drop_before=None, tile=128, heads=2):
    """dq of the plain dt backward, times dq_scale, `heads` heads at a time:
    the dt form of ``dq_reference``. With ``drop_before``, a key more than
    ``drop_before`` positions before the first row of a query's 128-row tile
    adds nothing to that query: what a dq block whose query tiles start their
    key sweep that late would give, the control that the row check must
    fail."""
    hide = None
    if drop_before is not None:
        qpos = torch.arange(tq, device=qd.device)[:, None]
        kpos = torch.arange(tk, device=qd.device)[None, :]
        hide = kpos < qpos // tile * tile - drop_before
    return _dt_by_heads(torch, lambda q, k, v, do, ls, dc: _dt_grads(
        torch, q, k, v, do, ls, dc, b, tq, tk, hide, dq_scale, ("dq",)),
        (qd, kd, vd, dod, lse, dcap), heads)[0]


def phase_dt_kernels(torch, ab, fa, dev):
    print("[19] dt-layout forward (P1) and one-pass backward (P2) vs plain (bf16), H=12 "
          "hs=64 causal", flush=True)
    (qd, kd, vd, dod), (q, k, v, _), (b, h, t, hs) = dt_inputs(torch, ab, dev, 19)
    scale = hs ** -0.5
    fwd_errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0}

    def check_fwd(bb, tq, tk, xs):
        o, lse = ab.flash_fwd_dt_b(*xs, bb, tq, tk, causal=True)
        o_ref, lse_ref = dt_fwd_by_heads(torch, ab, *xs, bb, tq, tk)
        torch.cuda.synchronize()
        o_err, o_excess = out_excess(o, o_ref)
        o_row, row_over = dt_row_excess(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"  P1 B={bb} Tq={tq} Tk={tk}: o max|err| {o_err:.3e} (tol max(2e-2, one bf16 "
              f"ulp); excess {o_excess:.3e}), max row |err| / |ref| {o_row:.3e} (tol 2^-6), "
              f"lse max|err| {lse_err:.3e} (tol 1e-3)", flush=True)
        require(o_excess <= 0 and row_over <= 0 and lse_err <= 1e-3,
                f"dt forward disagrees with its plain version at B={bb} Tq={tq} Tk={tk}")
        for key, e in (("o", o_err), ("o_row", o_row), ("lse", lse_err)):
            fwd_errs[key] = max(fwd_errs[key], e)
        return o, lse

    o, lse = check_fwd(b, t, t, (qd, kd, vd))
    # P2's inputs at each shape: q, k, v, dO and the kernel's o and lse
    bwd_cases = [(b, t, t, [qd, kd, vd, dod, o, lse])]
    # a T that is a multiple of 64 but not of 128 (each sequence ends in half
    # a 128-row tile, and the next sequence starts where zeros belong); Tq !=
    # Tk under the no-offset mask (query i sees keys <= i); and T=8192, where
    # a late row's |o| is small (the plain side four heads at a time)
    g = torch.Generator(dev).manual_seed(190)
    for bb, tq, tk in ((3, 1088, 1088), (2, 512, 1024), (1, 8192, 8192)):
        xs = [ab.to_dt(torch.randn(bb, n, h, hs, device=dev, generator=g).to(torch.bfloat16))
              for n in (tq, tk, tk, tq)]
        xs[0] = (xs[0].float() * scale).to(torch.bfloat16)
        o_x, lse_x = check_fwd(bb, tq, tk, xs[:3])
        bwd_cases.append((bb, tq, tk, [*xs, o_x, lse_x]))
        if tq == 8192:
            # control: the last 128 rows without their first key tile; the row
            # check must fail it where the late rows' |o| is smallest (the
            # elementwise check's reading beside it)
            late = dt_rows_without_first_keys(torch, *xs[:3], tq)
            _, control = dt_row_excess(o_x[:, :, tq - 128:], late)
            _, loose = out_excess(o_x[:, :, tq - 128:], late)
            print(f"  control: the last 128 rows without their first key tile pass the row "
                  f"tolerance by {control:.3e} (must be > 0), the elementwise one by "
                  f"{loose:.3e}", flush=True)
            require(control > 0, "P1's o passed the row check against o without the first key "
                    "tile: the check cannot see a late start of the key sweep")
            fwd_errs["o_control"], fwd_errs["o_control_elementwise"] = control, loose
        del xs, o_x, lse_x
    # against the shipping forward on the same values (q unscaled there; the
    # pre-scaled bf16 q of the dt side rounds once more, so one bf16 ulp apart)
    o_k1 = fa.flash_attention(q, k, v, causal=True, layout="bthd")
    k1_err, k1_excess = out_excess(ab.from_dt(o, b, t), o_k1)
    print(f"  P1 vs the shipping forward's output transposed: max|err| {k1_err:.3e} "
          f"(excess {k1_excess:.3e})", flush=True)
    require(k1_excess <= 0, "dt forward disagrees with the shipping forward")

    # P2 on the kernels' o and lse at the four shapes: against 3e-2 of
    # max|ref| and row by row (each position's 64 channels of dq, dk and dv
    # within 2^-6 of the row's norm plus 1e-3), twice on one input bit for
    # bit; at T=8192 the plain side two heads at a time, and two controls
    # that must fail the row check while they pass the old one
    tol = 3e-2  # max|err| / max|ref|; P and dS round to bf16 in the kernel
    bwd_errs = {"bwd": 0.0, "dq_row": 0.0, "dkv_row": 0.0}
    same_all = []
    for bb, tq, tk, xs in bwd_cases:
        qx, kx, vx, dox, ox, lsex = xs
        dcx = ab.dcap_dt(ox, dox)
        args = (qx, kx, vx, dox, lsex, dcx, bb, tq, tk)
        got = ab.flash_bwd_dt_b(*args, causal=True, dq_scale=scale)
        again = ab.flash_bwd_dt_b(*args, causal=True, dq_scale=scale)
        torch.cuda.synchronize()
        same = [bool(torch.equal(x, y)) for x, y in zip(got, again)]
        rerun = rel_err(again[0], got[0])
        del again
        heads = 2 if tq * tk > 1024 * 1024 else h
        want = _dt_by_heads(torch, lambda *a: ab.flash_bwd_dt_b_reference(
            *a, bb, tq, tk, causal=True, dq_scale=scale), (qx, kx, vx, dox, lsex, dcx), heads)
        torch.cuda.synchronize()
        rels = [rel_err(x, r) for x, r in zip(got, want)]
        rows = [dt_grad_row_excess(x, r) for x, r in zip(got, want)]
        print(f"  P2 B={bb} Tq={tq} Tk={tk}: dq, dk, dv max|err| / max|ref| "
              + ", ".join(f"{e:.3e}" for e in rels) + f" (tol {tol}), max row |err| / "
              "(|ref| + 1e-3) " + ", ".join(f"{r[0]:.3e}" for r in rows) + " (tol 2^-6); "
              f"twice on one input bit-equal {same} (dq max|diff| / max {rerun:.3e})",
              flush=True)
        require(max(rels) <= tol and max(r[1] for r in rows) <= 0,
                f"dt backward disagrees with its plain version at B={bb} Tq={tq} Tk={tk}")
        same_all.append(same)
        bwd_errs["bwd"] = max(bwd_errs["bwd"], *rels)
        bwd_errs["dq_row"] = max(bwd_errs["dq_row"], rows[0][0])
        bwd_errs["dkv_row"] = max(bwd_errs["dkv_row"], rows[1][0], rows[2][0])
        bwd_errs["rerun"] = max(bwd_errs.get("rerun", 0.0), rerun)
        if tq == 8192:
            sk, sv = dt_dkv_reference(torch, qx, kx, vx, dox, lsex, dcx, bb, tq, tk,
                                      drop_after=K1_DKV_DROP_AFTER)
            control = max(dt_grad_row_excess(sk, want[1])[1],
                          dt_grad_row_excess(sv, want[2])[1])
            loose = max(rel_err(sk, want[1]), rel_err(sv, want[2]))
            del sk, sv
            print(f"  control: dk/dv without the queries from {K1_DKV_DROP_AFTER} after each "
                  f"key tile on pass the row tolerance by {control:.3e} (must be > 0); "
                  f"max|err| / max|ref| {loose:.3e} (tol {tol})", flush=True)
            require(control > 0, "P2's dk/dv passed the row check against dk/dv without the "
                    "far queries: the check cannot see a short key-tile sweep")
            bwd_errs["dkv_control"], bwd_errs["dkv_control_max_rel"] = control, loose
            sq = dt_dq_reference(torch, qx, kx, vx, dox, lsex, dcx, bb, tq, tk, dq_scale=scale,
                                 drop_before=K1_DQ_DROP_BEFORE)
            control, loose = dt_grad_row_excess(sq, want[0])[1], rel_err(sq, want[0])
            del sq
            print(f"  control: dq without the keys more than {K1_DQ_DROP_BEFORE} before each "
                  f"query tile passes the row tolerance by {control:.3e} (must be > 0); "
                  f"max|err| / max|ref| {loose:.3e} (tol {tol})", flush=True)
            require(control > 0, "P2's dq passed the row check against dq without the far "
                    "keys: the check cannot see a late start of a query tile's key sweep")
            bwd_errs["dq_control"], bwd_errs["dq_control_max_rel"] = control, loose
        if (bb, tq) == (b, t):
            # the wrong-dcap control on the tool's inputs
            control = [rel_err(x, r) for x, r in zip(
                ab.flash_bwd_dt_b(qx, kx, vx, dox, lsex, torch.zeros_like(dcx), bb, tq, tk,
                                  causal=True, dq_scale=scale), want)]
            print("  control (dcap = 0): " + ", ".join(f"{e:.3e}" for e in control),
                  flush=True)
            require(max(control[:2]) > tol, "the wrong-dcap control passed: the check cannot "
                    "fail")
        del got, want, xs
    bwd_cases.clear()
    torch.cuda.empty_cache()

    dcap = ab.dcap_dt(o, dod)
    fwd_t = interleaved(lambda: ab.flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True),
                        lambda: ab.flash_fwd_dt_b_reference(qd, kd, vd, b, t, t, causal=True),
                        50, 3)
    bwd_t = interleaved(lambda: ab.flash_bwd_dt_b(qd, kd, vd, dod, lse, dcap, b, t, t,
                                                  causal=True, dq_scale=scale),
                        lambda: ab.flash_bwd_dt_b_reference(qd, kd, vd, dod, lse, dcap, b, t, t,
                                                            causal=True, dq_scale=scale), 50, 3)
    require(all(all(x) for x in same_all), "two runs of the dt backward differ: dq, dk and dv "
            f"are summed in a fixed order (bit-equal dq, dk, dv by shape: {same_all})")
    return ({**fwd_errs, "vs_k1": k1_err, **bwd_errs, "dq_bit_equal": True},
            {"fwd": fwd_t, "bwd": bwd_t})


# phase 19b's shapes (B, Tq, Tk, causal), all H=12: P1's four of phase 19,
# causal, an unmasked Tq == Tk whose backward runs whole (b, h) in rounds
# (24 (b, h) of 16 key tiles on 264 resident blocks: rounds of 16), and a
# causal Tq > Tk, whose query tiles past Tk see every key, split over its
# key range (T=1024) and whole (T=2048)
DT_F32_SHAPES = ((2, 1024, 1024, True), (3, 1088, 1088, True), (2, 512, 1024, True),
                 (1, 8192, 8192, True), (2, 1024, 1024, False), (2, 1024, 512, True),
                 (2, 2048, 1024, True))


def dt_dropped_part(torch, ab, qd, kd, vd, b, tq, tk, causal, parts):
    """o (dt layout) of P1 fp32's split-and-merge in plain PyTorch with the
    last part of every query tile of several left out of its merge: the
    fault that phase 19b's merge control stands for."""
    h, hs, _ = qd.shape
    o = torch.empty((h, hs, b, tq), dtype=torch.float32, device=qd.device)
    for rows, pts in ab.dt_f32_parts_reference(qd, kd, vd, b, tq, tk, causal=causal,
                                               parts=parts):
        o[..., rows] = ab.merge_dt_parts(pts[:-1] if len(pts) > 1 else pts)[0]
    return o.reshape(h, hs, b * tq)


def dt_f32_inputs(torch, ab, b, tq, tk, h, dev, g):
    """q (pre-scaled by 1/sqrt(hs)), k, v, dO in the dt layout (H, 64, B*T),
    fp32, from one generator."""
    hs = 64
    q, do = (torch.randn(b, tq, h, hs, device=dev, generator=g) for _ in range(2))
    k, v = (torch.randn(b, tk, h, hs, device=dev, generator=g) for _ in range(2))
    return ab.to_dt(q * hs ** -0.5), ab.to_dt(k), ab.to_dt(v), ab.to_dt(do)


def dt_f32_masked(torch, qd, kd, vd, dod, b, tq, tk, hide, dq_scale):
    """The dt forward and backward in fp32 with the (Tq, Tk) bool mask
    ``hide`` (True: a key the query does not see) in place of the no-offset
    causal one, the softmax statistics and dcap its own: (o, dq * dq_scale,
    dk, dv) in the dt layout, what a kernel with that mask would give. The
    control of phase 19b."""
    h, hs, _ = qd.shape
    q4, do4 = (a.reshape(h, hs, b, tq) for a in (qd, dod))
    k4, v4 = (a.reshape(h, hs, b, tk) for a in (kd, vd))
    s = torch.einsum("hdbq,hdbk->hbqk", q4, k4).masked_fill(hide, float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    o = torch.einsum("hbqk,hdbk->hdbq", p, v4)
    dv = torch.einsum("hbqk,hdbq->hdbk", p, do4)
    ds = p * (torch.einsum("hdbq,hdbk->hbqk", do4, v4) - (o * do4).sum(1)[..., None])
    del p
    dk = torch.einsum("hbqk,hdbq->hdbk", ds, q4)
    dq = torch.einsum("hbqk,hdbk->hdbq", ds, k4) * dq_scale
    return [x.reshape(h, hs, -1) for x in (o, dq, dk, dv)]


def phase_dt_kernels_f32(torch, ab, dev):
    print("[19b] dt-layout forward (P1) and one-pass backward (P2) on fp32 operands "
          "(csrc/flash_dt_fwd_f32.cu, flash_dt_bwd_f32.cu) vs plain (fp32, no TF32), H=12 "
          "hs=64", flush=True)
    import torch.nn.functional as F

    g = torch.Generator(dev).manual_seed(191)
    h, hs = 12, 64
    scale = hs ** -0.5
    errs = {"o": 0.0, "o_row": 0.0, "lse": 0.0, "max_rel": 0.0, "row": 0.0, "controls": {},
            "parts": {}}
    timing = {}
    slots = ab._dt_f32_slots(dev.index)
    for b, tq, tk, causal in DT_F32_SHAPES:
        parts = ab.dt_f32_parts(b * h, tq, tk, causal, slots)
        errs["parts"][f"B{b}_Tq{tq}_Tk{tk}_{'causal' if causal else 'nomask'}"] = parts
        qd, kd, vd, dod = dt_f32_inputs(torch, ab, b, tq, tk, h, dev, g)
        n0 = (ab.flash_fwd_dt_b.launches_f32, ab.flash_bwd_dt_b.launches_f32,
              ab.flash_fwd_dt_b.launches_f32_merge)
        o, lse = ab.flash_fwd_dt_b(qd, kd, vd, b, tq, tk, causal=causal)
        same = True
        for _ in range(F32_BWD_RUNS - 1):
            o2, lse2 = ab.flash_fwd_dt_b(qd, kd, vd, b, tq, tk, causal=causal)
            same = same and torch.equal(o, o2) and torch.equal(lse, lse2)
            del o2, lse2
        dcap = ab.dcap_dt(o, dod)
        args = (qd, kd, vd, dod, lse, dcap, b, tq, tk)
        got = ab.flash_bwd_dt_b(*args, causal=causal, dq_scale=scale)
        for _ in range(F32_BWD_RUNS - 1):
            again = ab.flash_bwd_dt_b(*args, causal=causal, dq_scale=scale)
            same = same and all(torch.equal(x, y) for x, y in zip(got, again))
            del again
        torch.cuda.synchronize()
        # the merge runs with every forward of a split shape and with none
        # of the others
        require((ab.flash_fwd_dt_b.launches_f32, ab.flash_bwd_dt_b.launches_f32,
                 ab.flash_fwd_dt_b.launches_f32_merge)
                == (n0[0] + F32_BWD_RUNS, n0[1] + F32_BWD_RUNS,
                    n0[2] + (F32_BWD_RUNS if parts > 1 else 0)),
                "the fp32 dt kernels (or P1's merge) did not run as the parts say")
        if causal:
            ro, rlse = dt_fwd_by_heads(torch, ab, qd, kd, vd, b, tq, tk)
        else:
            ro, rlse = ab.flash_fwd_dt_b_reference(qd, kd, vd, b, tq, tk, causal=False)
        heads = 2 if tq * tk > 1024 * 1024 else h
        want = _dt_by_heads(torch, lambda *a: ab.flash_bwd_dt_b_reference(
            *a, b, tq, tk, causal=causal, dq_scale=scale), (qd, kd, vd, dod, lse, dcap), heads)
        torch.cuda.synchronize()
        eo, el = (o - ro).abs().max().item(), (lse - rlse).abs().max().item()
        erow = f32_fwd_row_err(ab.from_dt(o, b, tq), ab.from_dt(ro, b, tq))
        # (B, T, H, hs) views: each query row of dq, key row of dk and dv; a
        # sequence's first query sees one key, its dq row 0 in exact arithmetic
        bthd = [ab.from_dt(x, b, n) for x, n in zip(got, (tq, tk, tk))]
        rthd = [ab.from_dt(x, b, n) for x, n in zip(want, (tq, tk, tk))]
        rels, rows = f32_bwd_errs(bthd, rthd, causal)
        print(f"  B={b} Tq={tq} Tk={tk} {'causal' if causal else 'no mask'}, P1 {parts} "
              f"part{'s' if parts > 1 else ''} a query tile: o max|err| "
              f"{eo:.3e}, lse {el:.3e} (tol {F32_TOL}), max row |err| / |ref| {erow:.3e} (tol "
              f"{F32_ROW_TOL}); dq, dk, dv max|err| / max|ref| "
              + ", ".join(f"{e:.3e}" for e in rels) + f" (tol {F32_TOL}), max row |err| / "
              "(|ref| + mean row norm) " + ", ".join(f"{r:.3e}" for r in rows)
              + f" (tol {F32_ROW_TOL}); {o.dtype}; both bit-equal over {F32_BWD_RUNS} runs: "
              f"{same}", flush=True)
        require(all(x.dtype == torch.float32 for x in (o, *got)),
                "the fp32 dt kernels are not fp32")
        require(max(eo, el) <= F32_TOL and erow <= F32_ROW_TOL,
                f"the fp32 dt forward disagrees at B={b} Tq={tq} Tk={tk}")
        require(max(rels) <= F32_TOL and max(rows) <= F32_ROW_TOL,
                f"the fp32 dt backward disagrees at B={b} Tq={tq} Tk={tk}")
        require(same, f"two runs of the fp32 dt kernels differ at B={b} Tq={tq} Tk={tk}")
        errs["o"], errs["lse"] = max(errs["o"], eo), max(errs["lse"], el)
        errs["o_row"] = max(errs["o_row"], erow)
        errs["max_rel"], errs["row"] = max(errs["max_rel"], *rels), max(errs["row"], *rows)
        # controls, each a fault the rules above must see
        ctrl = {}
        if parts > 1:
            # P1's merge without each split query tile's last part
            short = dt_dropped_part(torch, ab, qd, kd, vd, b, tq, tk, causal, parts)
            ctrl[f"merge_without_last_part_B{b}_Tq{tq}_Tk{tk}"
                 + ("" if causal else "_nomask")] = {"o_row": f32_fwd_row_err(
                ab.from_dt(o, b, tq), ab.from_dt(short, b, tq))}
            del short
        if tq == 8192:
            # the last 128 rows without their first key tile (a late key sweep)
            late = dt_rows_without_first_keys(torch, qd, kd, vd, tq)
            ctrl["rows_without_first_keys"] = {"o_row": f32_fwd_row_err(
                ab.from_dt(o[:, :, tq - 128:], 1, 128), ab.from_dt(late, 1, 128))}
            del late
            # dk/dv without the far queries, dq without the far keys
            sk, sv = dt_dkv_reference(torch, qd, kd, vd, dod, lse, dcap, b, tq, tk,
                                      drop_after=K1_DKV_DROP_AFTER)
            ctrl["dkv_reference"] = {"grad_row": max(
                f32_row_err(ab.from_dt(x, b, tk), r) for x, r in zip((sk, sv), rthd[1:]))}
            del sk, sv
            sq = dt_dq_reference(torch, qd, kd, vd, dod, lse, dcap, b, tq, tk, dq_scale=scale,
                                 drop_before=K1_DQ_DROP_BEFORE)
            ctrl["dq_reference"] = {"grad_row": f32_row_err(ab.from_dt(sq, b, tq), rthd[0],
                                                            causal_dq=True)}
            del sq
        if causal and tq < tk:
            # the causal mask right-aligned (query i sees keys <= i + Tk - Tq),
            # the general kernels' rule, which the dt kernels must not follow
            wrong = dt_f32_masked(torch, qd, kd, vd, dod, b, tq, tk,
                                  general_hide(torch, tq, tk, True, dev), scale)
            ctrl["right_aligned_mask"] = {
                "o_row": f32_fwd_row_err(ab.from_dt(o, b, tq), ab.from_dt(wrong[0], b, tq)),
                "grad_row": max(f32_row_err(x, ab.from_dt(w, b, n)) for x, w, n in
                                zip(bthd, wrong[1:], (tq, tk, tk)))}
            del wrong
        for name, c in ctrl.items():
            print(f"  control {name}: " + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in c.items())
                  + f" (each must be > {F32_ROW_TOL})", flush=True)
            require(all(v_ > F32_ROW_TOL for v_ in c.values()),
                    f"the control {name} passed the fp32 dt kernels' row checks")
            errs["controls"][name] = c
        del qd, kd, vd, dod, o, lse, dcap, got, want, ro, rlse, bthd, rthd
        torch.cuda.empty_cache()
    # times at the A/B tool's shape (B=8, T=1024), its own inputs in fp32:
    # plain, kernel, kernel, plain; SDPA on the same fp32 operands (q pre-scaled,
    # so its scale 1) beside them, forward and whole backward
    (qd, kd, vd, dod), _, (b, h, t, hs) = dt_inputs(torch, ab, dev, 19, dtype="fp32")
    o, lse = ab.flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True)
    dcap = ab.dcap_dt(o, dod)
    timing["fwd"] = interleaved(lambda: ab.flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True),
                                lambda: ab.flash_fwd_dt_b_reference(qd, kd, vd, b, t, t,
                                                                    causal=True), 20, 3)
    timing["bwd"] = interleaved(
        lambda: ab.flash_bwd_dt_b(qd, kd, vd, dod, lse, dcap, b, t, t, causal=True,
                                  dq_scale=scale),
        lambda: ab.flash_bwd_dt_b_reference(qd, kd, vd, dod, lse, dcap, b, t, t, causal=True,
                                            dq_scale=scale), 10, 2)
    qt, kt, vt, dot = (ab.from_dt(x, b, t).transpose(1, 2).contiguous()
                       for x in (qd, kd, vd, dod))
    timing["sdpa_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=1.0), 20)
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=1.0)
    timing["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, dot,
                                                                retain_graph=True), 10)
    bounds = [attention_bound(kind, b, t, t, h, hs, True, elem_bytes=4, peak=PEAK_FP32_FLOPS)[0]
              for kind in ("fwd", "fused_bwd")]
    print(f"  B={b} T={t}: P1 fp32 {timing['fwd'][0]:.4f} ms (bound {bounds[0]:.4f}, "
          f"{bounds[0] / timing['fwd'][0]:.1%}), SDPA forward on the fp32 operands "
          f"{timing['sdpa_fwd_ms']:.4f}; P2 fp32 {timing['bwd'][0]:.4f} ms (bound "
          f"{bounds[1]:.4f}, {bounds[1] / timing['bwd'][0]:.1%}), SDPA's whole backward "
          f"{timing['sdpa_bwd_ms']:.4f}", flush=True)
    del qd, kd, vd, dod, o, lse, dcap, qt, kt, vt, dot, leaves, out
    torch.cuda.empty_cache()
    return errs, timing


def phase_dt_tool(ab):
    print("[20] the A/B tool through its main in both dtypes: --check, --check-bwd, forward "
          "bench, --bwd", flush=True)
    ab.flash_fwd_dt_b.launches = ab.flash_bwd_dt_b.launches = 0
    ab.flash_fwd_dt_b.launches_f32 = ab.flash_bwd_dt_b.launches_f32 = 0
    ab.flash_fwd_dt_b.launches_f32_merge = 0
    checks, benches = {}, {}
    for dtype in ("fp32", "bf16"):
        flag = ["--dtype", dtype]
        checks[dtype] = {"o": ab.main(["--check", *flag]), **ab.main(["--check-bwd", *flag])}
        benches[dtype] = {"forward_ms_per_layer": ab.main(flag),
                          "forward_backward_ms_per_layer": ab.main(["--bwd", *flag])}
    # the checks' default dtype is fp32: one more of each, on the fp32 kernels
    checks["default"] = {"o": ab.main(["--check"]), **ab.main(["--check-bwd"])}
    counts = {"flash_dt_fwd": ab.flash_fwd_dt_b.launches, "flash_dt_bwd": ab.flash_bwd_dt_b.launches,
              "flash_dt_fwd_f32": ab.flash_fwd_dt_b.launches_f32,
              "flash_dt_bwd_f32": ab.flash_bwd_dt_b.launches_f32,
              "flash_dt_fwd_f32_merge": ab.flash_fwd_dt_b.launches_f32_merge}
    # per dtype: check 1; check-bwd 1 + 1; each bench one set-up call and a
    # warm-up + 12 timed; the default checks 1 + 1 and 1 more on fp32. P1
    # fp32's merge runs with each forward at a shape that it splits: the four
    # checks' (B=2, H=3, T=1024), the benches' (B=8, H=12, T=1024)
    slots = ab._dt_f32_slots(0)  # the tool's device, cuda:0
    split = [ab.dt_f32_parts(b * h, t, t, True, slots) > 1 for b, h, t in ((2, 3, 1024),
                                                                          (8, 12, 1024))]
    want = {"flash_dt_fwd": 1 + 1 + 14 + 14, "flash_dt_bwd": 1 + 14,
            "flash_dt_fwd_f32": 1 + 1 + 14 + 14 + 2, "flash_dt_bwd_f32": 1 + 14 + 1,
            "flash_dt_fwd_f32_merge": 4 * split[0] + 28 * split[1]}
    print(f"  launches {counts}", flush=True)
    require(counts == want, f"expected launches {want}, got {counts}")
    # the limits of the tool's checks by dtype: fp32 the TPU tool's own
    for key, (o_lim, grad_lim) in (("fp32", (2e-5, 1e-5)), ("default", (2e-5, 1e-5)),
                                   ("bf16", (2e-2, 3e-2))):
        c = checks[key]
        require(c["o"] < o_lim and max(c[n] for n in ("dq", "dk", "dv")) < grad_lim,
                f"the tool's {key} checks disagree: {c}")
    return counts, {"checks": checks, **benches}


def phase_k1_short(torch, fa, attention, dev):
    b, t, h, hs = 128, 65, 12, 64
    print(f"[21] the self-attention kernels against the plain path at the fine-tune shape "
          f"B={b} T={t} H={h} hs={hs} causal (below the {attention.AUTO_FLASH_MIN_T}-token "
          f"routing threshold)", flush=True)
    g = torch.Generator(dev).manual_seed(21)
    q, k, v, do = qkv_inputs(torch, b, t, t, h, dev, g)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=True)
    o_err, o_excess = out_excess(o, o_ref)
    o_row, row_over = row_excess(o, o_ref)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    errs = [rel_err(x, r) for x, r in zip(got, want)]
    rows = [grad_row_excess(x, r) for x, r in zip(got, want)]
    print(f"  o max|err| {o_err:.3e} (excess {o_excess:.3e}), max row |err| / |ref| "
          f"{o_row:.3e} (tol 2^-6), lse {(lse - lse_ref).abs().max().item():.3e}; dq, dk, dv "
          f"max|err| / max|ref| " + ", ".join(f"{e:.3e}" for e in errs) + " (tol 3e-2), "
          "max row |err| / (|ref| + 1e-3) " + ", ".join(f"{r[0]:.3e}" for r in rows)
          + " (tol 2^-6)", flush=True)
    require(o_excess <= 0 and row_over <= 0 and max(errs) <= 3e-2
            and max(r[1] for r in rows) <= 0, "the kernels disagree at T=65")

    def fwd(impl):
        def run():
            with torch.no_grad():
                attention.sdpa(q, k, v, causal=True, impl=impl, layout="bthd")
        return run

    leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]

    def fwd_bwd(impl):
        def run():
            y = attention.sdpa(*leaves, causal=True, impl=impl, layout="bthd")
            y.backward(do)
            for a in leaves:
                a.grad = None
        return run

    f = interleaved(fwd("flash"), fwd("xla"), 50, 20)
    fb = interleaved(fwd_bwd("flash"), fwd_bwd("xla"), 50, 20)
    print(f"  forward: kernel {f[0]:.4f} ms, plain {f[1]:.4f} ms; forward + backward through "
          f"autograd: kernels {fb[0]:.4f} ms, plain {fb[1]:.4f} ms", flush=True)
    return {"shape": f"B={b} T={t} H={h} hs={hs} causal", "o_row_err": o_row,
            "grad_row_err": max(r[0] for r in rows),
            "fwd_kernel_ms": f[0], "fwd_plain_ms": f[1], "fwd_bwd_kernel_ms": fb[0],
            "fwd_bwd_plain_ms": fb[1]}


def finetune_setup(ft, kind, n_layer, dev, policy):
    """(preset with ``n_layer`` layers at full width, the parts
    train/finetune.build_finetune makes of it on ``dev``)."""
    preset = ft["presets"][kind]()
    preset = dataclasses.replace(preset, model=preset.model.replace(n_layer=n_layer))
    return preset, ft["finetune"].build_finetune(preset, device=dev, policy=policy)


def finetune_batch(torch, np, accum, b, t, n_bank, dev, seed):
    """A synthetic accumulation window {x, y, mask, idx}, each (accum, b, ...);
    idx are rows of a bank of n_bank images."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 50257, (accum, b, t + 1))
    lens = rng.randint(4, t, (accum, b, 1))
    mask = np.arange(t)[None, None, :] < lens
    idx = rng.randint(0, n_bank, (accum, b))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in (("x", toks[..., :-1]), ("y", toks[..., 1:]), ("mask", mask),
                         ("idx", idx))}


def finetune_ce_check(torch, ft, fc, kind, model, loss_fn, micro, bank):
    """The CE kernel at the shape the fine-tune's validation gives it: the
    no-grad loss of one B=128 micro-batch at full depth launches it once on
    N = 128 * 32 = 4096 rows, about half of them ignored (-100 labels or a
    false mask). The hidden states and targets that reach ``fused_ce_loss``
    are recorded, and the kernel's per-row NLL and the path's masked-mean loss
    are held against the plain version on them. Returns the per-row error."""
    gpt2 = ft["gpt2"]
    tol = CE_TOL  # fp32 logits both ways; only the sum order differs
    seen = {}
    fused_ce_loss = gpt2.fused_ce_loss

    def recording(x, wte, targets, *, mask=None, **kw):
        seen.update(x=x, wte=wte, targets=targets, mask=mask)
        return fused_ce_loss(x, wte, targets, mask=mask, **kw)

    gpt2.fused_ce_loss = recording
    try:
        with torch.no_grad():
            n_ce = fc.ce_forward.launches
            loss_k = loss_fn(model, micro, bank).item()
            require(fc.ce_forward.launches == n_ce + 1,
                    "the no-grad loss at B=128 did not launch the CE kernel once")
    finally:
        gpt2.fused_ce_loss = fused_ce_loss
    cc = ft["policy"].cast_compute
    x = cc(seen["x"]).reshape(-1, seen["x"].shape[-1]).contiguous()
    w = cc(seen["wte"]).contiguous()
    flat_t = seen["targets"].reshape(-1)
    valid = flat_t != -100
    if seen["mask"] is not None:
        valid = valid & seen["mask"].reshape(-1).bool()
    safe_t = flat_t.clamp(min=0).to(torch.int32).contiguous()
    nll_k, _ = fc.ce_forward(x, w, safe_t)
    nll_p, _ = fc.ce_forward_reference(x, w, safe_t, n_chunks=8)
    torch.cuda.synchronize()
    n, n_valid = x.shape[0], int(valid.sum())
    err = ((nll_k - nll_p) * valid).abs().max().item()
    counted = (nll_p - nll_k * valid).abs().max().item()  # control: ignored rows kept
    loss_p = ((nll_p * valid).sum() / n_valid).item()
    sum_all = (nll_p.sum() / n_valid).item()  # control: ignored rows in the sum
    mean_all = nll_p.mean().item()  # ignored rows in the sum and the count
    print(f"  {kind} CE kernel at the validation shape, N={n} rows ({n_valid} counted), "
          f"D={x.shape[1]}, V={w.shape[0]}: per-row nll max|err| {err:.3e}, masked-mean loss "
          f"{loss_k:.6f} (path) vs {loss_p:.6f} (plain, |diff| {abs(loss_k - loss_p):.3e}), "
          f"tol {tol}; controls with the ignored "
          f"rows counted: per row {counted:.3e}, in the sum {abs(sum_all - loss_k):.3e}, in "
          f"the sum and the count {abs(mean_all - loss_k):.3e} (printed, not held)", flush=True)
    require(0 < n_valid < n, "the micro-batch has no ignored rows")
    require(err <= tol and abs(loss_k - loss_p) <= tol,
            f"{kind}: the CE kernel disagrees at the fine-tune shape")
    require(counted > tol and abs(sum_all - loss_k) > tol,
            "a loss that counts the ignored rows passed the check: the check cannot see them")
    return err


def finetune_update_check(torch, np, ft, mods, kind, model, state, make_step, opt_cfg,
                          trainable, decay, bank, dev):
    """The AdamW kernel over the trainable leaves, from warm moments.

    Adam's first step is lr * g / (|g| + eps): the clip scale, the betas and
    the bias corrections cancel, so it cannot tell a wrong scalar from a right
    one. ``state`` has taken step 0; step 1 here gives every trainable leaf
    non-zero moments (the cross-attention leaves behind the gates get their
    first gradient in it) and the grad norm, and step 2, with the clip at half
    that norm so that it is active, is the one compared: the kernel path's
    parameter change against the plain AdamW replayed on the same state with
    the same gradients, as max|err| / max|ref|. Controls (no weight decay, no
    clipping, the bias corrections of a first step) must fall outside the
    limit."""
    gpt2 = ft["gpt2"]
    tol = 1e-3
    batch = finetune_batch(torch, np, 2, 128, 32, bank.shape[0], dev, 25)
    warm = make_step(opt_cfg, True)(model, state, batch, 1, bank)
    clipped = dataclasses.replace(opt_cfg, grad_clip=0.5 * warm["grad_norm"])
    params = {n: p for n, p in gpt2.named_params(model).items() if trainable[n]}
    before = {n: p.detach().clone() for n, p in params.items()}
    saved = {"m": {n: a.clone() for n, a in state["m"].items()},
             "v": {n: a.clone() for n, a in state["v"].items()}, "step": state["step"]}
    n0 = mods["fw"].fused_adamw.launches
    mk = make_step(clipped, True)(model, state, batch, 2, bank)
    require(mods["fw"].fused_adamw.launches == n0 + 1, "the compared step did not launch AdamW")
    grads = {n: p.grad for n, p in params.items()}
    inv = 1.0 / batch["x"].shape[0]
    norm = mods["global_norm"](grads) * inv

    def replay(cfg, decay_mask, step):
        p = {n: a.clone() for n, a in before.items()}
        st = {"m": {n: a.clone() for n, a in saved["m"].items()},
              "v": {n: a.clone() for n, a in saved["v"].items()}, "step": step}
        mods["adamw_update"](p, grads, st, mk["lr"], cfg, norm=norm, decay_mask=decay_mask,
                             use_fused=False, grad_scale=inv)
        return {n: p[n] - before[n] for n in p}

    with torch.no_grad():
        ref = replay(clipped, decay, saved["step"])
        delta = {n: p.detach() - before[n] for n, p in params.items()}
        err = update_err(delta, ref)
        controls = {
            "no weight decay": update_err(replay(clipped, {n: False for n in decay},
                                                 saved["step"]), ref),
            "no clipping": update_err(replay(dataclasses.replace(clipped, grad_clip=math.inf),
                                             decay, saved["step"]), ref),
            "bias corrections of a first step": update_err(replay(clipped, decay, 0), ref),
        }
    print(f"    third step (warm moments, clip {clipped.grad_clip:.4e} against a grad norm of "
          f"{mk['grad_norm']:.4e}, lr {mk['lr']:.4e}): update on the kernel vs the plain AdamW "
          f"on its grads, max|err| / max|ref| {err:.3e} (tol {tol}); controls "
          + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()), flush=True)
    require(saved["step"] == 2 and mk["grad_norm"] > clipped.grad_clip,
            "the compared step is not a clipped third step")
    require(err <= tol, f"{kind}: the AdamW kernel's update disagrees with the plain one")
    require(all(v > tol for v in controls.values()),
            "a control update passed the update check: the check cannot see it")
    return err


def phase_finetune_ops(torch, np, ft, mods, dev):
    print("[22] fine-tune ops on the card (bf16 policy) against the same functions on the "
          "CPU in fp32", flush=True)
    gpt2, bridges, pooling = ft["gpt2"], ft["bridges"], ft["pooling"]
    fw, fc = mods["fw"], mods["fc"]
    fp32 = ft["fp32_policy"]
    cpu = torch.device("cpu")
    rng = np.random.RandomState(22)
    feats = torch.from_numpy(rng.randn(64, 197, 768).astype(np.float32))
    pooled_cpu = pooling.pool_clip_tokens_to_33(feats)
    pooled = pooling.pool_clip_tokens_to_33(feats.to(dev))
    e = (pooled.cpu() - pooled_cpu).abs().max().item()
    print(f"  pooling (64, 197, 768) -> (64, 33, 768): max|err| {e:.3e} (tol 1e-5, fp32 sums "
          f"in another order)", flush=True)
    require(tuple(pooled.shape) == (64, 33, 768) and e <= 1e-5, "pooling disagrees with the CPU")
    bank = pooled.to(torch.bfloat16)

    results = {}
    for kind in ("linear", "qformer", "xattn"):
        # 2 layers at full width: the CPU fp32 side stays short
        preset, parts = finetune_setup(ft, kind, 2, dev, ft["policy"])
        mcfg, model, loss_fn = preset.model, parts["model"], parts["loss_fn"]
        if kind == "xattn":
            with torch.no_grad():
                # open the gates, or the cross-attention changes nothing; and raise its
                # output projection from the init's 0.02 / sqrt(2 L), or what it adds to
                # a residual of size 1 is below a bf16 ulp
                for layer in model.transformer.h:
                    layer.cross_gate.fill_(0.5)
                    layer.xattn.c_proj.weight.mul_(50.0)
        _, ref_parts = finetune_setup(ft, kind, 2, cpu, fp32)
        ref, ref_loss_fn = ref_parts["model"], ref_parts["loss_fn"]
        ref.load_state_dict(model.state_dict())
        batch = finetune_batch(torch, np, 1, 16, 32, 64, dev, 23)
        micro = {k_: v_[0] for k_, v_ in batch.items()}
        micro_cpu = {k_: v_.cpu() for k_, v_ in micro.items()}
        with torch.no_grad():
            if kind != "xattn":
                z = bank[micro["idx"]]
                out = bridges.bridge_apply(model.bridge, z, preset.bridge, policy=ft["policy"])
                want = bridges.bridge_apply(ref.bridge, z.cpu().float(), preset.bridge, policy=fp32)
                e = rel_err(out.cpu(), want)
                print(f"  {kind} bridge {tuple(z.shape)} -> {tuple(out.shape)}: max|err| / "
                      f"max|ref| {e:.3e} (tol 3e-2, bf16 operands)", flush=True)
                require(out.shape == want.shape and e <= 3e-2, f"{kind} bridge disagrees")
            else:
                x = torch.randn(16, 32, 768, device=dev, generator=torch.Generator(dev).manual_seed(3))
                zp = gpt2.project_visual(model, bank[micro["idx"]], mcfg, torch.bfloat16,
                                         policy=ft["policy"])
                out = gpt2.block(model.transformer.h[0], x.to(torch.bfloat16), mcfg,
                                 policy=ft["policy"], attn_impl="auto", z=zp)
                zp_ref = gpt2.project_visual(ref, bank[micro["idx"]].cpu().float(), mcfg,
                                             torch.float32, policy=fp32)
                want = gpt2.block(ref.transformer.h[0], x.cpu(), mcfg, policy=fp32,
                                  attn_impl="xla", z=zp_ref)
                plain_no_z = gpt2.block(ref.transformer.h[0], x.cpu(), mcfg, policy=fp32,
                                        attn_impl="xla")
                e = rel_err(out.cpu(), want)
                moved = rel_err(plain_no_z, want)
                print(f"  xattn block (gate 0.5) (16, 32, 768) x z (16, 33, 768): max|err| / "
                      f"max|ref| {e:.3e} (tol 3e-2); without z the block differs by {moved:.3e}",
                      flush=True)
                require(e <= 3e-2 and moved > e, "the gated cross-attention block disagrees")
            # validation path: no autograd, so lm_head + CE go through the CE kernel
            n_ce = fc.ce_forward.launches
            loss_k = loss_fn(model, micro, bank).item()
            require(fc.ce_forward.launches == n_ce + 1, "the no-grad loss did not launch the "
                    "CE kernel")
            loss_cpu = ref_loss_fn(ref, micro_cpu, bank.cpu().float()).item()
        # under autograd: K4 too, and K4b on each of the 8 chunks in the backward
        # (the head is frozen: dx only)
        loss_g = loss_fn(model, micro, bank)
        require(fc.ce_forward.launches == n_ce + 2, "the training loss did not launch K4")
        n_bwd = fc.ce_backward.launches
        loss_g.backward()
        require(fc.ce_backward.launches == n_bwd + 8, "the training loss's backward did not "
                "launch K4b on each of its 8 chunks")
        print(f"  {kind} loss (2 layers, B=16, T=32): card, CE kernel {loss_k:.6f}; card, CE "
              f"kernels under autograd {loss_g.item():.6f}; CPU fp32 {loss_cpu:.6f} (tol 2e-2)",
              flush=True)
        require(abs(loss_k - loss_cpu) <= 2e-2 and abs(loss_g.item() - loss_k) <= 1e-2,
                f"{kind} loss disagrees")
        del model, ref

        # full depth, B=128: the shapes the fine-tune gives the CE and AdamW kernels
        preset, parts = finetune_setup(ft, kind, 12, dev, ft["policy"])
        mcfg, model, loss_fn = preset.model, parts["model"], parts["loss_fn"]
        trainable, decay = parts["trainable"], parts["decay"]
        big_bank = bank.repeat(4, 1, 1)
        batch = finetune_batch(torch, np, 2, 128, 32, big_bank.shape[0], dev, 24)
        ce_err = finetune_ce_check(torch, ft, fc, kind, model, loss_fn,
                                   {k_: v_[0] for k_, v_ in batch.items()}, big_bank)

        # one optimizer step: frozen leaves bit-identical, trainable leaves
        # moved, the AdamW kernel's table holds the trainable leaves only; the
        # same step on the plain update from the same state (the validation
        # loss_fn: no dropout, so both updates see the same grads)
        plain_model = copy.deepcopy(model)
        before = {n: p.detach().clone() for n, p in gpt2.named_params(model).items()}
        sched = dataclasses.replace(preset.schedule, warmup_steps=0)  # step 0 at the peak LR
        table_sizes = []
        launch = fw.fused_adamw_cuda

        def recording(leaves, scalars, wds):
            table_sizes.append(len(leaves))
            return launch(leaves, scalars, wds)

        def make_step(opt_cfg, fused):
            return mods["make_train_step"](loss_fn, opt_cfg, sched, decay_mask=decay,
                                           trainable_mask=trainable, use_fused_adamw=fused)

        out, states = {}, {}
        fw.fused_adamw_cuda = recording
        try:
            for name, m, fused in (("kernel", model, True), ("plain", plain_model, False)):
                states[name] = mods["adamw_init"](gpt2.named_params(m), trainable_mask=trainable)
                step = make_step(preset.optimizer, fused)
                n0 = fw.fused_adamw.launches
                out[name] = step(m, states[name], batch, 0, big_bank)
                out[name]["launches"] = fw.fused_adamw.launches - n0
                out[name]["moments"] = len(states[name]["m"])
        finally:
            fw.fused_adamw_cuda = launch
        after = gpt2.named_params(model)
        n_train = sum(trainable.values())
        frozen_same = all(torch.equal(after[n], before[n]) for n in before if not trainable[n])
        moved = [n for n in before if trainable[n] and not torch.equal(after[n], before[n])]
        no_grad = all(after[n].grad is None for n in before if not trainable[n])
        kk, pp = out["kernel"], out["plain"]
        print(f"  {kind} one step, 2 x (B=128, T=32), 12 layers: loss {kk['loss']:.6f} / "
              f"{pp['loss']:.6f}, grad norm {kk['grad_norm']:.6f} / {pp['grad_norm']:.6f} "
              f"(kernel / plain update); AdamW launches {kk['launches']} / {pp['launches']}, "
              f"leaf table {table_sizes} of {len(before)} leaves, {n_train} trainable, "
              f"{kk['moments']} with moments; frozen bit-identical {frozen_same}, frozen "
              f"without .grad {no_grad}, trainable leaves moved {len(moved)}/{n_train}",
              flush=True)
        # the kernel takes the trainable leaves whose JAX leaf passes the JAX
        # gate (train/optimizer.py kernel_leaves); the others the plain update
        n_kernel = len(mods["kernel_leaves"](gpt2.named_params(plain_model), states["plain"],
                                             trainable))
        print(f"    leaves the JAX gate gives the kernel: {n_kernel} of {n_train}", flush=True)
        require(kk["launches"] == 1 and pp["launches"] == 0 and table_sizes == [n_kernel]
                and 0 < n_kernel <= n_train and kk["moments"] == n_train,
                "the AdamW kernel's table is not the trainable leaves the JAX gate admits")
        require(frozen_same and no_grad, "a frozen leaf changed or got a gradient")
        if kind == "xattn":
            # closed gates: only the gates have a gradient at step 0 (tanh'(0) = 1);
            # the other trainable leaves move by weight decay alone or not at all
            gates = [n for n in moved if n.endswith("cross_gate")]
            require(len(gates) == mcfg.n_layer, "the first step did not move every gate")
        else:
            require(len(moved) == n_train, "a trainable leaf did not move")
        require(abs(kk["loss"] - pp["loss"]) <= 1e-2
                and abs(kk["grad_norm"] - pp["grad_norm"]) <= 0.02 * pp["grad_norm"],
                "the kernel-path and plain-path steps disagree")
        del plain_model, states["plain"]
        upd = finetune_update_check(torch, np, ft, mods, kind, model, states["kernel"],
                                    make_step, preset.optimizer, trainable, decay, big_bank, dev)
        results[kind] = {"n_trainable_leaves": n_train, "n_leaves": len(before),
                         "ce_max_abs_err": ce_err, "update_err": upd}
        del model, before
        torch.cuda.empty_cache()
    return results


def phase_finetune_clis(torch, ft, mods, dev):
    print("[23] the fine-tune entry points at full width: cli.finetune_linear / "
          "finetune_qformer / finetune_xattn --synthetic, then a resume", flush=True)
    fa, fc, fw, gpt2 = mods["fa"], mods["fc"], mods["fw"], ft["gpt2"]
    results, counts_by = {}, {}
    # outside log_root, which goes at the end of this phase
    linear_ckpt = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_linear_"), "model_final.pt")
    log_root = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    old_tmp = tempfile.tempdir
    tempfile.tempdir = log_root  # the synthetic COCO files go under it too
    try:
        for kind, steps in (("linear", 3), ("qformer", 3), ("xattn", 3)):
            cli = ft["cli"][kind]
            log_dir = os.path.join(log_root, kind)
            argv = ["--synthetic", "--log-dir", log_dir]
            reset_counts(fa, fc, fw)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = cli.main(argv + ["--steps", str(steps)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts(fa, fc, fw)
            peak = torch.cuda.max_memory_allocated() / 2**30
            model = out["model"]
            params = gpt2.named_params(model)
            trainable = (gpt2.trainable_mask_xattn(model) if kind == "xattn"
                         else {n: n.startswith("bridge.") for n in params})
            n_train = sum(p.numel() for n, p in params.items() if trainable[n])
            n_total = sum(p.numel() for p in params.values())
            # validations at step 0 and at the last step, 20 micro-batches each,
            # beside the steps' micro-batches under autograd
            accum = ft["presets"][kind]().grad_accum_steps(1)
            want = with_zeros({"adamw": steps, **ce_train(steps * accum, val=2 * 20)})
            rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "*.csv")))
                    for line in open(f).read().splitlines()[1:]]
            train_rows = [r for r in rows if r[1] == "train"]
            phases = [r[1] for r in rows]
            print(f"  {kind}: {steps} steps in {dt:.1f} s; launches {counts}; rows "
                  f"{ {p_: phases.count(p_) for p_ in ('train', 'val', 'cider')} }; val loss "
                  f"{out['val_loss']:.4f}, CIDEr {out['cider']}; peak {peak:.2f} GiB; trainable "
                  f"{n_train:,} of {n_total:,} parameters", flush=True)
            require(counts == want, f"expected launches {want}, got {counts}")
            require(out["opt_state"]["step"] == steps and math.isfinite(out["val_loss"])
                    and out["cider"] is not None and math.isfinite(out["cider"]),
                    f"{kind}: the run did not take {steps} finite steps with a CIDEr score")
            require(phases.count("train") == steps and phases.count("val") == 2
                    and phases.count("cider") == 2, f"{kind}: CSV rows missing")
            ckpts = sorted(os.listdir(os.path.join(log_dir, "ckpts")))
            require("model_final.pt" in ckpts and "model_best.pt" in ckpts,
                    f"{kind}: checkpoints missing, got {ckpts}")
            if kind == "linear":  # phase 28 captions an image with this bridge
                shutil.copy(os.path.join(log_dir, "ckpts", "model_final.pt"), linear_ckpt)
            # frozen leaves bit-identical to the seeded init, trainable leaves moved
            cfg = ft["presets"][kind]()
            fresh = gpt2.named_params(ft["finetune"].build_finetune(cfg, device=dev)["model"])
            frozen_same = all(torch.equal(params[n], p) for n, p in fresh.items()
                              if not trainable[n])
            moved = sum(not torch.equal(params[n], p) for n, p in fresh.items() if trainable[n])
            n_leaves = sum(trainable.values())
            print(f"    frozen leaves bit-identical to the seeded init: {frozen_same}; trainable "
                  f"leaves moved: {moved}/{n_leaves}", flush=True)
            require(frozen_same and moved == n_leaves, f"{kind}: freezing is broken")
            # step 1 stands for the step time: steps 0 and 2 carry a validation, a
            # CIDEr evaluation and checkpoint writes
            mid = train_rows[1]
            # CIDEr through evaluate_captions directly: a fault here fails the run
            run_cfg = out["cfg"]  # holds the synthetic dataset's directories
            val_ds = ft["coco"].CocoClipTokensDataset(
                os.path.join(run_cfg.clip_feats_dir, "val"),
                os.path.join(run_cfg.coco_root, "annotations", "captions_val2017.json"),
                ft["tokenizer"], cfg.seq_len, seed=cfg.seed)
            t0 = time.perf_counter()
            ev = ft["evaluate_captions"](model, val_ds, cfg.model,
                                         None if kind == "xattn" else cfg.bridge, ft["tokenizer"],
                                         max_samples=cfg.cider_samples,
                                         max_new_tokens=cfg.cider_max_new_tokens)
            torch.cuda.synchronize()
            dt_ev = time.perf_counter() - t0
            require(len(ev["captions"]) == 64 and math.isfinite(ev["cider"]),
                    f"{kind}: evaluate_captions did not score the 64 val images")
            results[kind] = {
                "steps": steps, "accum": cfg.grad_accum_steps(1),
                "step_ms": [float(r[6]) for r in train_rows],
                "train_tokens_per_s": [float(r[7]) for r in train_rows],
                "plain_step_ms": float(mid[6]), "plain_step_tokens_per_s": float(mid[7]),
                "cider": ev["cider"], "cider_captions": len(ev["captions"]),
                "captions_per_s": len(ev["captions"]) / dt_ev, "peak_gib": peak,
                "val_loss": out["val_loss"], "ce_fwd_launches": counts["ce_fwd"],
                "adamw_launches": counts["adamw"], "trainable_params": n_train,
                "total_params": n_total, "wall_s": dt,
            }
            print(f"    step ms {results[kind]['step_ms']}, tokens/s "
                  f"{results[kind]['train_tokens_per_s']}; CIDEr decode of 64 images "
                  f"{dt_ev:.2f} s = {64 / dt_ev:.1f} captions/s (CIDEr {ev['cider']:.4f})",
                  flush=True)
            counts_by[kind] = counts
            del model, out, fresh
            torch.cuda.empty_cache()

        # resume the cross-attention run: one more step from its checkpoints
        log_dir = os.path.join(log_root, "xattn")
        reset_counts(fa, fc, fw)
        out = ft["cli"]["xattn"].main(["--synthetic", "--log-dir", log_dir, "--steps", "4"])
        rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "*.csv")))
                for line in open(f).read().splitlines()[1:]]
        steps = [int(r[2]) for r in rows if r[1] == "train"]
        print(f"  resumed xattn: train steps logged {steps}, AdamW launches "
              f"{fw.fused_adamw.launches}, optimizer step {out['opt_state']['step']}", flush=True)
        require(steps == [0, 1, 2, 3] and fw.fused_adamw.launches == 1
                and out["opt_state"]["step"] == 4,
                "the second call did not resume at step 3 and run one step")
        return counts_by, results, linear_ckpt
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(log_root, ignore_errors=True)


def dyadic_tie_row(np, v, p, seed=0, m=8, head=20):
    """One (1, v) fp32 row of multiples of 2^-20 summing to exactly 1, with a
    tie group of m tokens at one value straddling p in shuffled positions:
    every partial sum is exact in any order, so the kept set is exact."""
    n, tie = 1 << 20, 2000
    rng = np.random.RandomState(seed)
    top = int(p * n) - (m // 2) * tie + int(rng.randint(tie))
    heads = np.full(head, top // head)
    heads[-1] += top - heads.sum()
    tail = rng.multinomial(n - top - m * tie, np.full(v - head - m, 1.0 / (v - head - m)))
    counts = np.concatenate([heads, np.full(m, tie), tail])
    require(counts.sum() == n and heads.min() > tie > tail.max(), "bad dyadic row")
    return (counts[rng.permutation(v)][None] / n).astype(np.float32)


def wall_ms(torch, fn, iters):
    """Wall milliseconds a call of fn() costs in a loop synchronised at its
    end: what a host-paced decode step pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_sampler(torch, np, gpt2, sampling, cfg, dev):
    """The sort-free nucleus sampler on the card at (50, 50304): its two
    arities bit-equal, the sorted kept set away from the boundary, a dyadic
    tie row exact, a control without the tie rule, and both samplers timed."""
    print("[24] top-p samplers at (50, 50304): sort-free against sorted", flush=True)
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(24), device=dev)
    g = torch.Generator(dev).manual_seed(25)
    scale = torch.linspace(1.0, 20.0, 50, device=dev)[:, None]
    hidden = torch.randn(50, cfg.n_embd, generator=g, device=dev) * scale
    logits = hidden @ model.transformer.wte.weight.t()  # the 124M lm_head, fp32
    del model
    probs = torch.softmax(logits / 0.8, dim=-1)
    out = {}
    for p in (0.5, 0.9):
        k2 = sampling.top_p_keep_mask(probs, p, ways=2)
        k8 = sampling.top_p_keep_mask(probs, p, ways=8)
        require(torch.equal(k2, k8), f"p={p}: ways=2 and ways=8 masks differ on the card")
        ks = sampling.sorted_keep_mask(probs, p)
        s64 = torch.sort(probs.double(), dim=-1, descending=True).values
        excl = torch.cumsum(s64, dim=-1) - s64
        kept = (excl <= p).sum(-1)
        rows = torch.arange(50, device=dev)
        near = (((excl[rows, kept - 1] - p).abs() <= 1e-5)
                | ((excl[rows, kept.clamp(max=excl.shape[1] - 1)] - p).abs() <= 1e-5))
        differ = (k2 != ks).any(-1)
        print(f"  p={p}: ways 2 = ways 8 bit for bit; kept {int(k2.sum(-1).min())}-"
              f"{int(k2.sum(-1).max())} tokens a row; rows within 1e-5 of p: "
              f"{int(near.sum())}; rows that differ from the sorted set: {int(differ.sum())}",
              flush=True)
        require(not bool((differ & ~near).any()),
                f"p={p}: the sort-free kept set differs from the sorted one away from p")
        out[f"p{p}"] = {"near_rows": int(near.sum()), "differing_rows": int(differ.sum())}
    row = torch.from_numpy(dyadic_tie_row(np, cfg.padded_vocab_size, 0.9)).to(dev)
    keep = sampling.top_p_keep_mask(row, 0.9)
    require(torch.equal(keep, sampling.sorted_keep_mask(row, 0.9))
            and torch.equal(keep, sampling.top_p_keep_mask(row, 0.9, ways=8)),
            "the dyadic tie row's kept set differs from the sorted one")
    vb = row[keep].min()
    tie = row == vb
    control = row > vb  # the tie rule dropped
    print(f"  dyadic tie row: {int(keep.sum())} kept, {int((keep & tie).sum())} of the "
          f"{int(tie.sum())}-token tie group; control without the tie rule keeps "
          f"{int(control.sum())}", flush=True)
    require(0 < int((keep & tie).sum()) < int(tie.sum()), "the tie group does not straddle p")
    require(not torch.equal(control, keep), "the control without the tie rule passed")
    gen = torch.Generator(dev).manual_seed(26)
    fns = {"sorted": lambda: sampling.sample_top_p(gen, logits),
           "fast_ways2": lambda: sampling.sample_top_p_fast(gen, logits, ways=2),
           "fast_ways8": lambda: sampling.sample_top_p_fast(gen, logits, ways=8)}
    # wall: a loop synchronised at its end, twice; device: the kernels alone
    # (torch.profiler), since the sort-free sampler's ~400 launches a call
    # outlast the hold kernel that cuda_ms queues its loop behind
    for name, fn in fns.items():
        out[name] = {"wall_ms": wall_ms(torch, fn, 20),
                     "kernel_ms": profiled_kernel_ms(torch, fn)[0]}
    for name, fn in fns.items():
        out[name]["wall_ms_2"] = wall_ms(torch, fn, 20)
    ratio = out["fast_ways2"]["wall_ms"] / out["sorted"]["wall_ms"]
    out["fast_over_sorted_wall"] = ratio
    out["faster_by_the_rule"] = "sample_top_p_fast" if ratio <= 1.10 else "sample_top_p"
    print("  one call, wall ms (again) / kernels ms: " + "; ".join(
        f"{n} {v['wall_ms']:.3f} ({v['wall_ms_2']:.3f}) / {v['kernel_ms']:.3f}"
        for n, v in out.items() if isinstance(v, dict) and "wall_ms" in v)
        + f"; sort-free / sorted wall {ratio:.2f}x", flush=True)
    return out


def phase_decode(bench_decode, first, card):
    """cli.bench_decode at B=50 with --topp-ways 2 (phase 5's run, ``first``)
    and 8, and at --batch 1 with --uncached-baseline."""
    print("[25] decode: cli.bench_decode at B=50 (--topp-ways 2 and 8) and B=1 "
          "(--uncached-baseline)", flush=True)
    out = {"B50_ways2": first}
    out["B50_ways8"] = bench_decode.main(["--batch", "50", "--new", "24", "--iters", "3",
                                          "--topp-ways", "8"])
    out["B1_ways2"] = bench_decode.main(["--batch", "1", "--new", "24", "--iters", "3",
                                         "--uncached-baseline"])
    for name, r in out.items():
        require(r["value"] > 0, f"bench_decode {name} failed")
        print(f"  {name}: {r['value']} captions/s ({card})", flush=True)
    require(out["B1_ways2"]["uncached_reference_captions_per_sec"] > 0,
            "the uncached baseline did not run")
    print(f"  uncached reference regime (B=1, a full re-forward per token, sorted "
          f"sampler): {out['B1_ways2']['uncached_reference_captions_per_sec']} captions/s; "
          f"B=1 cached is {out['B1_ways2']['speedup_vs_uncached']}x it", flush=True)
    return out


def phase_eval_quality(torch, np, mods, ft, cfg, dev):
    """cli.eval_quality at GPT-2 124M full width and depth from seeded weights,
    on files written here: HellaSwag from a reference .pt and an HF directory
    (bf16, every batch padded to 1024 so that each layer's attention runs on
    K1-fwd), from the .pt at the default fp32 policy on the fp32 kernel
    against the plain path; captions with METEOR from a linear and a
    Q-Former GPT_Caption .pt."""
    print("[26] cli.eval_quality: GPT-2 124M, reference .pt and HF directory (HellaSwag), "
          "GPT_Caption .pt of each bridge (CIDEr, METEOR)", flush=True)
    from gpt2_vision_language_tpu_torch.cli import eval_quality
    from gpt2_vision_language_tpu_torch.core.config import BridgeConfig
    from gpt2_vision_language_tpu_torch.eval import caption_eval, hellaswag

    fa, fc, fw, gpt2, bridges = mods["fa"], mods["fc"], mods["fw"], ft["gpt2"], ft["bridges"]
    out, secs = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_quality_")
    try:
        t0 = time.perf_counter()
        model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(2611), device=dev)
        with torch.no_grad():
            model.transformer.wte.weight[cfg.vocab_size:] = 0.0  # as an unpadded file reads
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        del model
        pt = os.path.join(root, "model.pt")
        torch.save({"model": sd, "step": 0}, pt)
        hf = {}
        for k, v in sd.items():
            if k.endswith(("c_attn.weight", "c_proj.weight", "c_fc.weight")):
                v = v.t().contiguous()  # HF Conv1D: (in, out)
            hf[k] = v[:cfg.vocab_size] if k in ("transformer.wte.weight", "lm_head.weight") else v
        for i in range(cfg.n_layer):
            hf[f"transformer.h.{i}.attn.bias"] = torch.tril(torch.ones(
                1, 1, cfg.block_size, cfg.block_size))
        hf_dir = os.path.join(root, "hf")
        os.makedirs(hf_dir)
        torch.save(hf, os.path.join(hf_dir, "pytorch_model.bin"))
        hs_dir = os.path.join(root, "hellaswag")
        os.makedirs(hs_dir)
        write_synthetic_hellaswag(np, os.path.join(hs_dir, "hellaswag_val.jsonl"), n=16, seed=3,
                                  ctx_tokens=(520, 900), tokenizer=ft["tokenizer"])
        tokens_dir, ann = ft["coco"].write_synthetic_coco(root, split="val", n_images=16,
                                                          n_tokens=197, enc_dim=768)
        captions = {}
        for kind in ("linear", "qformer"):
            bridge = bridges.bridge_init(BridgeConfig(kind=kind, enc_dim=768), cfg.n_embd,
                                         generator=torch.Generator().manual_seed(7))
            captions[kind] = os.path.join(root, f"caption_{kind}.pt")
            torch.save({"model": {**{f"gpt.{k}": v for k, v in sd.items()},
                                  **{f"bridge.{k}": v for k, v in bridge.state_dict().items()}}},
                       captions[kind])
        secs["write_files"] = time.perf_counter() - t0

        hs = ["--hellaswag", "--hellaswag-dir", hs_dir, "--device", "cuda"]
        for name, argv in (("reference_pt_bf16", ["--gpt-ckpt", pt, "--policy", "bf16"]),
                           ("hf_dir_bf16", ["--hf-ckpt", hf_dir, "--policy", "bf16"])):
            reset_counts(fa, fc, fw)
            t0 = time.perf_counter()
            r = eval_quality.main(argv + hs)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            counts = read_counts(fa, fc, fw)
            out[name] = {k: r[k] for k in ("ckpt_format", "hellaswag_correct",
                                           "hellaswag_total", "hellaswag_acc")}
            out[name]["launches"] = counts
            out[name]["flash_fwd_launches"] = counts["flash_fwd"]
            print(f"  HellaSwag {name}: {r['hellaswag_correct']}/{r['hellaswag_total']} in "
                  f"{secs[name]:.1f} s; launches {counts}", flush=True)
            require(r["hellaswag_total"] == 16 and "hellaswag_skipped_too_long" not in r,
                    f"{name}: not all 16 examples were scored")
            # 16 examples, 8 a batch: two flushes at width 1024, 12 layers each
            want = with_zeros({"flash_fwd": 2 * cfg.n_layer})
            require(counts == want, f"{name}: expected launches {want}, got {counts}")
        require(out["reference_pt_bf16"]["hellaswag_correct"]
                == out["hf_dir_bf16"]["hellaswag_correct"],
                "the reference .pt and the HF directory disagree on HellaSwag")
        # --policy fp32, the default (the JAX package runs its kernel on fp32
        # operands there): every layer on the fp32 forward kernel, none on
        # K1-fwd; then the same run on the plain path (the router's threshold
        # lifted past 1024), whose per-ending losses the kernel run must meet
        losses = {}
        ending_losses = hellaswag.ending_losses

        def recording(name):
            def record(tokens, mask, logits):
                out = ending_losses(tokens, mask, logits)
                losses.setdefault(name, []).append(out.float().cpu())
                return out
            return record

        min_t = mods["attention"].AUTO_FLASH_MIN_T
        fp32 = {}
        try:
            for name, threshold in (("reference_pt_fp32", min_t),
                                    ("reference_pt_fp32_plain", 1 << 30)):
                hellaswag.ending_losses = recording(name)
                mods["attention"].AUTO_FLASH_MIN_T = threshold
                reset_counts(fa, fc, fw)
                t0 = time.perf_counter()
                r = eval_quality.main(["--gpt-ckpt", pt] + hs)
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
                fp32[name] = {k: r[k] for k in ("policy", "hellaswag_correct", "hellaswag_total")}
                fp32[name]["launches"] = read_counts(fa, fc, fw)
                print(f"  HellaSwag {name}: {r['hellaswag_correct']}/{r['hellaswag_total']} in "
                      f"{secs[name]:.1f} s; launches {fp32[name]['launches']}", flush=True)
        finally:
            hellaswag.ending_losses = ending_losses
            mods["attention"].AUTO_FLASH_MIN_T = min_t
        kern, plain = (torch.cat(losses[n]) for n in ("reference_pt_fp32",
                                                      "reference_pt_fp32_plain"))
        loss_err = (kern - plain).abs().max().item()
        # predictions must agree wherever the plain path's two lowest endings
        # are further apart than twice the loss tolerance; an example closer
        # to a tie than that (two equal endings, say) may go either way
        low2 = plain.sort(-1).values
        decisive = (low2[:, 1] - low2[:, 0]) > 2e-4
        differ = kern.argmin(-1) != plain.argmin(-1)
        same_pred = not bool((differ & decisive).any())
        print(f"  fp32: per-ending losses of {kern.shape[0]} examples x 4 against the plain "
              f"path: max|err| {loss_err:.3e} (tol 1e-4); predictions equal on the "
              f"{int(decisive.sum())} examples whose two lowest endings are more than 2e-4 "
              f"apart: {same_pred}; predictions that differ: {int(differ.sum())}", flush=True)
        for i in differ.nonzero().flatten().tolist():
            print(f"    example {i}: kernel {kern[i].tolist()}, plain {plain[i].tolist()}",
                  flush=True)
        want = with_zeros({"flash_fwd_f32": 2 * cfg.n_layer})
        require(fp32["reference_pt_fp32"]["policy"] == "fp32"
                and fp32["reference_pt_fp32"]["launches"] == want,
                f"eval_quality at fp32: expected launches {want}, got "
                f"{fp32['reference_pt_fp32']['launches']}")
        require(fp32["reference_pt_fp32_plain"]["launches"] == with_zeros({}),
                "the plain-path fp32 run launched a kernel")
        require(loss_err <= 1e-4 and same_pred and int(decisive.sum()) >= 12,
                "fp32 HellaSwag on the kernel disagrees with the plain path")
        out["reference_pt_fp32"] = {**fp32["reference_pt_fp32"], "loss_max_abs_err": loss_err,
                                    "decisive_examples": int(decisive.sum()),
                                    "predictions_differ": int(differ.sum()),
                                    "plain": fp32["reference_pt_fp32_plain"]}
        # the router on fp32 q at T=1024: the fp32 forward kernel without a
        # gradient; with one, the fp32 forward and backward kernels
        q = torch.randn(1, 1024, 12, 64, device=dev)
        reset_counts(fa, fc, fw)
        with torch.no_grad():
            o = mods["attention"].sdpa(q, q, q, causal=True, layout="bthd")
        o_err = (o - mods["attention"].xla_sdpa(q, q, q, causal=True, layout="bthd")
                 ).abs().max().item()
        routed = read_counts(fa, fc, fw)
        grads = []
        for impl in ("auto", "xla"):
            qq = q.clone().requires_grad_(True)
            mods["attention"].sdpa(qq, qq, qq, causal=True, impl=impl, layout="bthd").sum().backward()
            grads.append(qq.grad)
            if impl == "auto":
                with_grad = read_counts(fa, fc, fw)
        g_err = rel_err(grads[0], grads[1])
        print(f"  ops.attention.sdpa on fp32 q at T=1024: without grad launches {routed} "
              f"(max|err| {o_err:.3e} against the plain path); forward + backward launches "
              f"{with_grad} (dq max|err| / max|ref| {g_err:.3e} against the plain path, tol "
              f"{F32_TOL})", flush=True)
        require(routed == with_zeros({"flash_fwd_f32": 1}) and o_err <= F32_TOL,
                "the router did not run fp32 q at T=1024 on the fp32 kernel")
        require(with_grad == with_zeros({"flash_fwd_f32": 2, "flash_bwd_f32": 1})
                and read_counts(fa, fc, fw) == with_grad and g_err <= F32_TOL,
                "the router did not run fp32 q that needs a gradient on the fp32 kernels")
        out["sdpa_fp32"] = {"no_grad_launches": routed, "max_abs_err": o_err,
                            "with_grad_launches": with_grad, "dq_max_rel_err": g_err}

        seen = []
        cast = caption_eval.cast_decode_params
        caption_eval.cast_decode_params = lambda m, p: seen.append(cast(m, p)) or seen[-1]
        try:
            for kind, path in captions.items():
                t0 = time.perf_counter()
                r = eval_quality.main(["--gpt-ckpt", path, "--bridge", kind, "--coco-tokens",
                                       tokens_dir, "--coco-ann", ann, "--meteor",
                                       "--cider-samples", "16", "--batch-size", "16",
                                       "--policy", "bf16", "--device", "cuda"])
                torch.cuda.synchronize()
                secs[f"captions_{kind}"] = time.perf_counter() - t0
                dtypes = {n: str(p.dtype) for n, p in seen[-1].bridge.named_parameters()
                          if n in ("query_tokens", "vis_proj.weight")}
                out[f"captions_{kind}"] = {k: r[k] for k in (
                    "cider", "cider_samples", "meteor", "meteor_synonyms")}
                out[f"captions_{kind}"]["served_dtypes"] = dtypes
                print(f"  captions {kind}: CIDEr {r['cider']:.4f}, METEOR {r['meteor']:.4f} "
                      f"({r['meteor_synonyms']}) over {r['cider_samples']} images in "
                      f"{secs[f'captions_{kind}']:.1f} s; served dtypes {dtypes}", flush=True)
                require(math.isfinite(r["cider"]) and math.isfinite(r["meteor"])
                        and r["cider_samples"] == 16, f"{kind}: caption scores are not finite")
                require(dtypes["vis_proj.weight"] == "torch.bfloat16",
                        f"{kind}: the served vis_proj is not bf16")
                if kind == "qformer":
                    require(dtypes["query_tokens"] == "torch.float32",
                            "the served Q-Former's query_tokens are not fp32")
        finally:
            caption_eval.cast_decode_params = cast
        out["seconds"] = secs
        print(f"  seconds: {json.dumps({k: round(v, 2) for k, v in secs.items()})}", flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 27's image sizes (H, W), 16 images each: shrink landscape and
# portrait, no resize, shrink at 2:3
CLIP_IMAGE_SIZES = ((480, 640), (640, 480), (224, 224), (333, 500))


def clip_flops(cfg, b):
    """Operations of one CLIP forward at batch b: every block's projections
    (2 * tokens * 12 w^2), its attention products (4 * heads * T^2 * hs) and
    the patch matmul."""
    t, w, n = cfg.num_tokens, cfg.width, cfg.grid ** 2
    blocks = cfg.layers * (2 * b * t * 12 * w * w + 4 * b * t * t * w)
    return blocks + 2 * b * n * cfg.patch_size ** 2 * 3 * w


def phase_clip(torch, np, mods, dev):
    from gpt2_vision_language_tpu_torch.core.config import CLIP_VIT_L14 as cfg
    from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
    from gpt2_vision_language_tpu_torch.models import clip_vit

    b = 16 * len(CLIP_IMAGE_SIZES)
    print(f"[27] the CLIP encoder at full width: ViT-L/14 (width {cfg.width}, {cfg.layers} "
          f"layers, {cfg.heads} heads, {cfg.num_tokens} tokens), B={b}, bf16 policy", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    model = clip_vit.init(cfg, generator=torch.Generator(dev).manual_seed(2701), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(dev).manual_seed(2702)
    groups = [torch.randint(0, 256, (16, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
              for h, w in CLIP_IMAGE_SIZES]

    def prep():
        return torch.cat([clip_vit.preprocess(x, cfg.image_size) for x in groups])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, fc, fw)
    with torch.no_grad():
        images = prep()
        feats = clip_vit.features(model, images, cfg)
    torch.cuda.synchronize()
    counts = read_counts(fa, fc, fw)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  images {tuple(images.shape)} -> features {tuple(feats.shape)} {feats.dtype}; "
          f"finite: {bool(feats.isfinite().all())}; launches {counts}; peak {peak:.2f} GiB; "
          f"{n_params:,} parameters", flush=True)
    require(feats.shape == (b, cfg.num_tokens, cfg.width) and feats.dtype == torch.bfloat16
            and bool(feats.isfinite().all()), "CLIP features are not finite bf16 of the shape")
    require(counts == with_zeros({}), "the CLIP encoder launched a kernel: its attention is "
            "plain in both packages")

    # the card against the CPU under the fp32 policy, preprocess included
    with torch.device("meta"):
        cpu_model = clip_vit.CLIPVisionTower(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
    two = groups[0][:2]
    with torch.no_grad():
        pre_card = clip_vit.preprocess(two, cfg.image_size)
        pre_cpu = clip_vit.preprocess(two.cpu(), cfg.image_size)
        f_card = clip_vit.features(model, pre_card, cfg, policy=FP32_POLICY)
        f_cpu = clip_vit.features(cpu_model, pre_cpu, cfg, policy=FP32_POLICY)
        f_bf16 = clip_vit.features(model, pre_card, cfg)
    e_pre = (pre_card.cpu() - pre_cpu).abs().max().item()
    e_f32 = (f_card.cpu() - f_cpu).abs().max().item()
    e_bf16 = (f_bf16.float().cpu() - f_cpu).abs().max().item()
    scale = f_cpu.abs().max().item()
    print(f"  B=2, fp32 policy, card against CPU: preprocess max|err| {e_pre:.3e} (tol 1e-5), "
          f"features max|err| {e_f32:.3e} (tol 1e-3, max|ref| {scale:.3f}); the card's bf16 "
          f"features against them {e_bf16:.3e}", flush=True)
    require(e_pre <= 1e-5 and e_f32 <= 1e-3, "CLIP on the card disagrees with the CPU at fp32")
    del cpu_model, f_card, f_cpu, f_bf16

    def encode():
        with torch.no_grad():
            clip_vit.features(model, images, cfg)

    ms = cuda_ms(encode, 5)
    t0 = time.perf_counter()
    for _ in range(3):
        encode()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    pre_ms = cuda_ms(prep, 5)
    dev_ms, by_class, top = profiled_kernel_ms(torch, encode, iters=3)
    flops = clip_flops(cfg, b)
    # fp32 weights and images read once, bf16 features written once
    bound = bound_ms(flops, 4 * n_params + 4 * images.numel() + 2 * feats.numel())
    print(f"  features: {ms:.3f} ms on the card ({b / ms * 1e3:.1f} images/s), {wall_ms:.3f} ms "
          f"wall ({b / wall_ms * 1e3:.1f} images/s); preprocess {pre_ms:.3f} ms; bound "
          f"{bound[0]:.3f} ms by {bound[1]} ({flops / 1e12:.2f} TFLOP at 989 TFLOP/s), "
          f"{bound[0] / ms:.1%} of it; torch.profiler, kernels only: {dev_ms:.3f} ms "
          f"{json.dumps(by_class)}; longest {top}", flush=True)

    # printed only, for a later routing change: K1-fwd non-causal at the
    # encoder's attention shape against the plain attention it runs
    h, hs, t = cfg.heads, cfg.width // cfg.heads, cfg.num_tokens
    qkv = torch.randn(b, t, 3 * cfg.width, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = (a.view(b, t, h, hs) for a in qkv.split(cfg.width, dim=-1))
    policy = mods["policy"]

    def k1():
        return fa.flash_attention(q, k, v, causal=False)

    def plain():
        return clip_vit.plain_attention(*(a.transpose(1, 2) for a in (q, k, v)), policy)

    k1_err = (k1().float() - plain().transpose(1, 2)).abs().max().item()
    k1_ms, plain_ms = interleaved(k1, plain, 20, 20)
    print(f"  K1-fwd non-causal at B={b} T={t} H={h} hs={hs}: {k1_ms:.4f} ms against the plain "
          f"attention's {plain_ms:.4f} ms ({plain_ms / k1_ms:.2f}x), max|err| {k1_err:.3e}; "
          f"x {cfg.layers} layers: {k1_ms * cfg.layers:.3f} against {plain_ms * cfg.layers:.3f} "
          f"ms a forward (not routed)", flush=True)
    return {"shape": f"ViT-L/14 B={b}", "device_ms": ms, "images_per_s": b / ms * 1e3,
            "wall_ms": wall_ms, "wall_images_per_s": b / wall_ms * 1e3,
            "preprocess_ms": pre_ms, "peak_gib": peak, "bound_ms": bound[0],
            "bound_by": bound[1], "tflop": flops / 1e12, "profiler_kernel_ms": dev_ms,
            "profiler_ms_by_class": by_class, "fp32_vs_cpu_max_abs_err": e_f32,
            "preprocess_vs_cpu_max_abs_err": e_pre, "bf16_vs_fp32_max_abs_err": e_bf16,
            "k1_fwd_noncausal_ms": k1_ms, "plain_attention_ms": plain_ms,
            "k1_vs_plain_max_abs_err": k1_err}


def phase_clip_clis(torch, np, mods, dev, tokenizer, linear_ckpt):
    print("[28] the entry points at full width: cli.extract_clip_features --variant vit-l-14 "
          "(96 images), cli.caption (vit-l-14 with a random linear and Q-Former bridge, "
          "vit-b-16 with phase 23's linear checkpoint)", flush=True)
    from gpt2_vision_language_tpu_torch.cli import caption as caption_cli
    from gpt2_vision_language_tpu_torch.cli import extract_clip_features as ex
    from gpt2_vision_language_tpu_torch.core.config import CLIP_VIT_L14 as cfg
    from gpt2_vision_language_tpu_torch.data.coco import CocoClipTokensDataset

    try:
        from PIL import Image
    except ImportError:
        Image = None
    print(f"  PIL importable on this machine: {Image is not None}", flush=True)
    if Image is None:
        print("  PIL is missing: the CLIs' device steps (everything after the JPEG decode) "
              "run on numpy uint8 crops", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    out, secs = {"pil": Image is not None}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_clip_")
    try:
        rng = np.random.RandomState(28)
        sizes = ((300, 400), (400, 300), (224, 224), (250, 500))
        n, batch, rows = 96, 32, 40
        os.makedirs(os.path.join(root, "annotations"))
        os.makedirs(os.path.join(root, "val2017"))
        metas, anns, paths = [], [], []
        for i in range(n):
            name = f"{700 + i:012d}.jpg"
            metas.append({"id": 700 + i, "file_name": name})
            anns.append({"image_id": 700 + i, "id": i, "caption": f"a synthetic image {i}"})
            paths.append(os.path.join(root, "val2017", name))
            if Image is not None:
                h, w = sizes[i % len(sizes)]
                Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(paths[-1])
        ann = os.path.join(root, "annotations", "captions_val2017.json")
        with open(ann, "w") as f:
            json.dump({"images": metas, "annotations": anns}, f)
        feats_dir = os.path.join(root, "feats")
        reset_counts(fa, fc, fw)
        t0 = time.perf_counter()
        if Image is not None:
            res = ex.main(["--coco-root", root, "--split", "val", "--out", feats_dir,
                           "--variant", "vit-l-14", "--batch", str(batch), "--rows-per-shard",
                           str(rows), "--device", "cuda"])
            crops = ex.load_batch(paths, cfg.image_size)
        else:
            crops = rng.randint(0, 256, (n, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
            encoder = ex.load_encoder(cfg, None, dev, warning="[extract] WARNING: no --hf-ckpt, "
                                      "using random CLIP init")
            writer = ex.ShardWriter(feats_dir, rows)
            for s in range(0, n, batch):
                writer.add(ex.encode(encoder, crops[s:s + batch], cfg, dev))
            res = writer.close()
            del encoder
        torch.cuda.synchronize()
        secs["extract"] = time.perf_counter() - t0
        counts = read_counts(fa, fc, fw)
        shards = sorted(x for x in os.listdir(feats_dir) if x.endswith(".npy"))
        shapes = [np.load(os.path.join(feats_dir, x), mmap_mode="r").shape for x in shards]
        print(f"  extract: {res['rows']} rows in {res['shards']} shards {shapes} in "
              f"{secs['extract']:.1f} s; launches {counts}", flush=True)
        tw = (cfg.num_tokens, cfg.width)
        require(res["rows"] == n and shapes == [(rows, *tw), (rows, *tw), (n - 2 * rows, *tw)],
                f"extract wrote {res} {shapes}")
        require(counts == with_zeros({}), "the extraction launched a kernel")
        # read back through the dataset: the rows of features of the same
        # crops in the same batches, cast to float16 (the CLI's seeded init)
        ds = CocoClipTokensDataset(feats_dir, ann, tokenizer, max_len=16)
        encoder = ex.load_encoder(cfg, None, dev, warning="  the CLI's seeded CLIP init")
        want = np.concatenate([ex.encode(encoder, crops[s:s + batch], cfg, dev)
                               for s in range(0, n, batch)])
        got = np.stack([ds.features(i) for i in range(n)]).astype(np.float16)
        row_diff = float(np.abs(got.astype(np.float32) - want.astype(np.float32)).max())
        print(f"  rows read back through CocoClipTokensDataset against features of the same "
              f"crops as float16: max|diff| {row_diff} (must be 0)", flush=True)
        require(row_diff == 0.0, "the extracted rows differ from features of the same crops")
        del encoder, ds

        captions = {}
        runs = (("vit-l-14_linear", "vit-l-14", "linear", None),
                ("vit-l-14_qformer", "vit-l-14", "qformer", None),
                ("vit-b-16_linear_finetuned", "vit-b-16", "linear", linear_ckpt))
        for name, variant, kind, ckpt in runs:
            reset_counts(fa, fc, fw)
            t0 = time.perf_counter()
            if Image is not None:
                argv = paths[:4] + ["--variant", variant, "--bridge", kind, "--new-tokens", "24",
                                    "--device", "cuda"]
                if ckpt:
                    argv += ["--gpt-ckpt", ckpt, "--bridge-ckpt", ckpt]
                lines = caption_cli.main(argv)
            else:
                clip_cfg, clip_model, gcfg, bcfg, model = caption_cli.load_models(
                    variant, kind, dev, gpt_ckpt=ckpt, bridge_ckpt=ckpt)
                size = clip_cfg.image_size
                toks = caption_cli.caption_crops(
                    clip_model, model, crops[:4, :size, :size], clip_cfg, gcfg, bcfg,
                    tokenizer.encode("A photo of"), generator=torch.Generator(dev).manual_seed(0),
                    new_tokens=24).cpu().numpy()
                lines = [f"{os.path.basename(p)}: A photo of{tokenizer.decode(t.tolist())}"
                         for p, t in zip(paths, toks)]
            torch.cuda.synchronize()
            secs[f"caption_{name}"] = time.perf_counter() - t0
            counts = read_counts(fa, fc, fw)
            print(f"  caption {name}: {len(lines)} lines in {secs[f'caption_{name}']:.1f} s; "
                  f"launches {counts}", flush=True)
            require(len(lines) == 4 and all(
                line.startswith(f"{os.path.basename(p)}: A photo of")
                for line, p in zip(lines, paths)), f"caption {name}: wrong lines {lines}")
            captions[name] = [line.encode("ascii", "replace").decode() for line in lines]
        out.update({"extract": res, "shard_shapes": shapes, "captions": captions,
                    "seconds": secs})
        print(f"  seconds: {json.dumps({k: round(v, 2) for k, v in secs.items()})}", flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(os.path.dirname(linear_ckpt), ignore_errors=True)


def phase_fp32_train_step(torch, np, gpt2, mods, cfgs, dev):
    print("[29] train step under FP32_POLICY: GPT-2 124M, 2 x (B=8, T=1024), kernel path vs "
          "plain path", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"]
    accum, b, t = 2, 8, 1024
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    plain_model = copy.deepcopy(model)
    rows = np.random.RandomState(29).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)

    def make(m, attn_impl, ce_impl, fused):
        loss_fn = lambda mm, r: gpt2.loss(mm, r[:, :-1], cfg, targets=r[:, 1:],  # noqa: E731
                                          policy=mods["fp32_policy"], attn_impl=attn_impl,
                                          ce_impl=ce_impl)
        return (mods["make_train_step"](loss_fn, cfgs["opt"], cfgs["sched"],
                                        decay_mask=gpt2.decay_mask(m), use_fused_adamw=fused),
                mods["adamw_init"](gpt2.named_params(m)))

    (step_k, st_k), (step_p, st_p) = make(model, "auto", "auto", True), make(
        plain_model, "xla", "xla", False)
    reset_counts(fa, fc, fw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk = step_k(model, st_k, batch, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts(fa, fc, fw)
    want = with_zeros({"flash_fwd_f32": accum * cfg.n_layer, "flash_bwd_f32": accum * cfg.n_layer,
                       "adamw": 1})
    print(f"  kernel path: loss {mk['loss']:.6f}, grad_norm {mk['grad_norm']:.6f}; launches "
          f"{counts}", flush=True)
    require(counts == want, f"expected launches {want}, got {counts}")
    mp = step_p(plain_model, st_p, batch, 0)
    require(read_counts(fa, fc, fw) == counts, "the plain-path step launched a kernel")
    dl = abs(mk["loss"] - mp["loss"])
    dn = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    pk, pp = gpt2.named_params(model), gpt2.named_params(plain_model)
    sq = lambda ts: sum(x.float().square().sum().item() for x in ts)  # noqa: E731
    dg = math.sqrt(sq(pk[n].grad - p.grad for n, p in pp.items()) / sq(p.grad for p in pp.values()))
    print(f"  vs the plain path (attn 'xla', CE 'xla', AdamW plain): loss {mp['loss']:.6f} "
          f"(|diff| {dl:.3e}, tol 1e-4), grad_norm {mp['grad_norm']:.6f} (rel diff {dn:.3e}, "
          f"tol 1e-4), grads ||err|| / ||ref|| {dg:.3e} (tol 1e-4)", flush=True)
    require(dl <= 1e-4 and dn <= 1e-4 and dg <= 1e-4,
            "the fp32 train step on the kernels disagrees with the plain path")
    times = []
    for i in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_k(model, st_k, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_p(plain_model, st_p, batch, 1)
    torch.cuda.synchronize()
    n_tok = accum * b * t
    out = {"counts": counts, "kernel_tps": n_tok / (sum(times) / 2),
           "plain_tps": n_tok / (time.perf_counter() - t0), "first_step_s": first_s,
           "loss_abs_err": dl, "grad_norm_rel_err": dn, "grads_rel_l2": dg,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"  tokens/s: kernel path {out['kernel_tps']:.1f} (steps 1-2), plain path "
          f"{out['plain_tps']:.1f}", flush=True)
    del model, plain_model, st_k, st_p
    return out


def phase_k1_heads(torch, fa, dev):
    print("[30] K1-fwd and K1-bwd (bf16) at the big presets' head counts, B=4, T=1024",
          flush=True)
    g = torch.Generator(dev).manual_seed(30)
    out = {}
    for h, preset in ((16, "350M"), (20, "774M"), (25, "1558M")):
        b, t = 4, 1024
        q, k, v, do = qkv_inputs(torch, b, t, t, h, dev, g)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ro, rlse = fwd_by_heads(torch, fa, q, k, v, True)
        eo, excess = out_excess(o, ro)
        erow, row_over = row_excess(o, ro)
        el = (lse - rlse).abs().max().item()
        got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        want = bwd_by_heads(torch, fa, q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        rels = [rel_err(x, r) for x, r in zip(got, want)]
        rows = [grad_row_excess(x, r) for x, r in zip(got, want)]
        fwd_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
        bwd_ms = cuda_ms(lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True), 20)
        print(f"  H={h} ({preset}): o max|err| {eo:.3e}, max row |err| / |ref| {erow:.3e} "
              f"(tol 2^-6), lse {el:.3e}; dq, dk, dv max|err| / max|ref| "
              + ", ".join(f"{e:.3e}" for e in rels) + ", max row |err| / (|ref| + 1e-3) "
              + ", ".join(f"{r[0]:.3e}" for r in rows) + f" (tol 2^-6); fwd {fwd_ms:.4f} ms, "
              f"bwd {bwd_ms:.4f} ms", flush=True)
        require(excess <= 0 and row_over <= 0 and el <= 1e-3, f"K1-fwd disagrees at H={h}")
        require(max(rels) <= 3e-2 and max(r[1] for r in rows) <= 0,
                f"K1-bwd disagrees at H={h}")
        out[f"H{h}"] = {"o_row_err": erow, "lse_err": el, "grad_max_rel": max(rels),
                        "grad_row_err": max(r[0] for r in rows), "fwd_ms": fwd_ms,
                        "bwd_ms": bwd_ms,
                        "fwd_bound_ms": attention_bound("fwd", b, t, t, h, 64, True)[0],
                        "bwd_bound_ms": attention_bound("bwd", b, t, t, h, 64, True)[0]}
        del q, k, v, do, o, lse, ro, got, want
    return out


def _csv_train_tps(log_dir):
    rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "*.csv")))
            for line in open(f).read().splitlines()[1:]]
    return [(int(r[2]), float(r[7])) for r in rows if r[1] == "train"]


# the stacks phase 31 reads the peak memory of, in the order of their cost:
# (label, micro-batch, param dtype, moment storage, accumulator dtype, remat,
# layerwise). The remat modes alone at fp32, then the JAX table's stack
# (cli/pretrain.py FIT_1CHIP there) added one mechanism at a time.
BIG_STACKS = (
    ("none B=4", 4, None, None, None, "none", False),
    ("none", 8, None, None, None, "none", False),
    ("none B=16", 16, None, None, None, "none", False),
    ("remat recompute_gelu", 8, None, None, None, "recompute_gelu", False),
    ("remat recompute_mlp", 8, None, None, None, "recompute_mlp", False),
    ("remat save_attn", 8, None, None, None, "save_attn", False),
    ("remat full", 8, None, None, None, "full", False),
    ("layerwise", 8, None, None, None, "none", True),
    ("bf16 moments", 8, None, "bfloat16", None, "none", False),
    ("int8 moments", 8, None, "int8", None, "none", False),
    ("bf16 params", 8, "bfloat16", None, None, "none", False),
    ("bf16 params + int8 moments", 8, "bfloat16", "int8", None, "none", False),
    ("+ bf16 accumulators", 8, "bfloat16", "int8", "bfloat16", "none", False),
    ("+ remat full", 8, "bfloat16", "int8", "bfloat16", "full", False),
    ("+ layerwise", 8, "bfloat16", "int8", "bfloat16", "full", True),
)
# a stack fits when one micro-batch step's peak stays under this share of the
# card's memory (room for the allocator's fragmentation and the validation pass)
FIT_SHARE = 0.9


def _fit_row(label, stacks):
    """The FIT_1CHIP row of one of BIG_STACKS' labels."""
    _, b, pdt, odt, adt, remat, lw = next(s for s in stacks if s[0] == label)
    row = {k: v for k, v in (("param_dtype", pdt), ("opt_state_dtype", odt),
                             ("grad_accum_dtype", adt)) if v}
    if remat != "none":
        row["remat"] = remat
    if lw:
        row["layerwise_grad"] = True
    if b != 8:
        row["micro_batch"] = b
    return row


def big_peaks(torch, np, gpt2, mods, cfgs, dev, cfg, stacks, seed):
    """Peak device memory (torch.cuda.max_memory_allocated) of a step of two
    micro-batches of GPT-2 ``cfg`` at T=1024 under each stack of ``stacks``
    (the second micro-batch's forward runs beside the first one's grads, as
    every later one of a 64-micro-batch step does), fresh moments each time,
    the bf16 policy; None where the step ran out of memory. The fp32 stacks
    come first, then the model is cast."""
    from gpt2_vision_language_tpu_torch.train.step import make_train_step

    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    rows = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (2, 16, 1025)).astype(np.int32)).to(dev)
    policy = mods["policy"]
    out = {}
    for label, b, pdt, odt, adt, remat, lw in stacks:
        if pdt == "bfloat16" and next(model.parameters()).dtype != torch.bfloat16:
            model.to(torch.bfloat16)
        loss_fn = lambda m, r, remat=remat: gpt2.loss(  # noqa: E731
            m, r[:, :-1], cfg, targets=r[:, 1:], policy=policy, remat=remat)
        layerwise = (lambda m, r, acc: gpt2.loss_grad_layerwise(  # noqa: E731
            m, r[:, :-1], cfg, targets=r[:, 1:], acc=acc, policy=policy)) if lw else None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, state = {"peak_gib": None}, None
        try:
            state = mods["adamw_init"](gpt2.named_params(model), state_dtype=odt)
            step = make_train_step(loss_fn, cfgs["opt"], cfgs["sched"],
                                   decay_mask=gpt2.decay_mask(model), grad_accum_dtype=adt,
                                   layerwise_loss_grad=layerwise)
            t0 = time.perf_counter()
            m = step(model, state, rows[:, :b], 0)
            torch.cuda.synchronize()
            res = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "step_s": time.perf_counter() - t0, "loss": m["loss"]}
            require(math.isfinite(m["loss"]), f"{label}: the loss is not finite")
        except torch.cuda.OutOfMemoryError:
            res["oom"] = True
        for p in model.parameters():
            p.grad = None
        del state
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out[label] = res
        print(f"    {label} (B={b}): " + ("out of memory" if res.get("oom") else
              f"peak {res['peak_gib']:.2f} GiB, step {res['step_s']:.2f} s"), flush=True)
    del model, rows
    torch.cuda.empty_cache()
    return out


def moment_gap(torch, a, b):
    """How far two AdamW states' moments are apart: the largest gap of 8-bit
    codes, the largest relative gap of their scales and of the tensor moments
    (bf16: one rounding is 2^-8 relative)."""
    gap = {"codes_max_gap": 0, "scales_max_rel": 0.0, "tensor_max_rel": 0.0}
    for key in ("m", "v"):
        for n, x in a[key].items():
            y = b[key][n]
            if isinstance(x, dict):
                gap["codes_max_gap"] = max(gap["codes_max_gap"], (
                    x["q"].cpu().int() - y["q"].cpu().int()).abs().max().item())
                gap["scales_max_rel"] = max(gap["scales_max_rel"], (
                    (x["s"].cpu() - y["s"].cpu()).abs() / y["s"].cpu().abs()).max().item())
            else:
                x, y = x.cpu().float(), y.cpu().float()
                gap["tensor_max_rel"] = max(gap["tensor_max_rel"], (
                    (x - y).abs() / y.abs().clamp(min=1e-30)).max().item())
    return gap


def phase_big_model(torch, np, gpt2, mods, cfgs, dev):
    print("[31] GPT-2 1558M at full width and depth (48 x 1600, 25 heads)", flush=True)
    from gpt2_vision_language_tpu_torch.core.config import GPT2_774M, GPT2_1558M
    from gpt2_vision_language_tpu_torch.train.step import GradAccumulators
    from gpt2_vision_language_tpu_torch.utils import fmt_count, tree_bytes

    fa, fc, fw, cli = mods["fa"], mods["fc"], mods["fw"], mods["pretrain"]
    out = {}
    limit_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    # (a) state bytes of each stack (params, moments, grad accumulators), on
    # the meta device
    with torch.device("meta"):
        meta = gpt2.GPT2(GPT2_1558M)
    n = sum(p.numel() for p in gpt2.named_params(meta).values())
    states = {}
    for label, pdt, odt, adt in (("fp32", None, None, None), ("bf16 moments", None, "bfloat16", None),
                                 ("int8 moments", None, "int8", None),
                                 ("bf16 params + int8 moments + bf16 accumulators", "bfloat16",
                                  "int8", "bfloat16")):
        pd = torch.bfloat16 if pdt else torch.float32
        params = {k: torch.empty(v.shape, dtype=pd, device="meta")
                  for k, v in gpt2.named_params(meta).items()}
        st = mods["adamw_init"](params, state_dtype=odt)
        gib = {"params": tree_bytes(params) / 2**30,
               "moments": tree_bytes([st["m"], st["v"]]) / 2**30,
               "grads": n * (2 if adt else 4) / 2**30}
        gib["total"] = sum(gib.values())
        states[label] = gib
        print(f"  (a) {label}: params {gib['params']:.2f} GiB, moments {gib['moments']:.2f} GiB, "
              f"grads {gib['grads']:.2f} GiB, total {gib['total']:.2f} GiB "
              f"({fmt_count(n)} parameters)", flush=True)
    out["state_gib"] = states
    del meta

    # (b) peak memory of one micro-batch step per stack, 1558M then 774M
    print(f"  (b) peak memory of a step of 2 micro-batches (T=1024, bf16 policy), card "
          f"{limit_gib:.1f} GiB, a stack fits under {FIT_SHARE:.0%} of it:", flush=True)
    t0 = time.perf_counter()
    peaks = big_peaks(torch, np, gpt2, mods, cfgs, dev, GPT2_1558M, BIG_STACKS, 31)
    small_stacks = tuple(s for s in BIG_STACKS if s[0] in ("none", "remat full"))
    print("  (b) GPT-2 774M:", flush=True)
    peaks_774 = big_peaks(torch, np, gpt2, mods, cfgs, dev, GPT2_774M, small_stacks, 32)
    fits = lambda r: r["peak_gib"] is not None and r["peak_gib"] <= FIT_SHARE * limit_gib  # noqa: E731
    order = [s[0] for s in BIG_STACKS if s[1] == 8]
    least = {"1558M": next((lb for lb in order if fits(peaks[lb])), None),
             "774M": next((lb for lb in order if lb in peaks_774 and fits(peaks_774[lb])), None)}
    read = {m: None if lb is None else _fit_row(lb, BIG_STACKS) for m, lb in least.items()}
    print(f"  least stack that fits at B=8: 1558M {least['1558M']!r} -> {read['1558M']}, 774M "
          f"{least['774M']!r} -> {read['774M']}; FIT_1CHIP has {cli.FIT_1CHIP['1558M']} and "
          f"{cli.FIT_1CHIP['774M']} ({time.perf_counter() - t0:.1f} s)", flush=True)
    table_label = next((s[0] for s in BIG_STACKS if _fit_row(s[0], BIG_STACKS)
                        == cli.FIT_1CHIP["1558M"]), None)
    require(table_label is not None and fits(peaks[table_label]),
            f"FIT_1CHIP['1558M'] = {cli.FIT_1CHIP['1558M']} does not fit this card's reading")
    out.update({"peaks_1558M": peaks, "peaks_774M": peaks_774, "least": least,
                "least_rows": read, "card_gib": limit_gib})

    # (c) the trainer entry point with --fit-1chip
    row = cli.FIT_1CHIP["1558M"]
    b = row.get("micro_batch", 8)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_1558m_")
    old_tmp = tempfile.tempdir
    tempfile.tempdir = log_dir
    try:
        argv = ["--model", "1558M", "--fit-1chip", "--synthetic", "--steps", "3",
                "--total-batch", str(2 * b * 1024), "--val-every", "0", "--no-hellaswag",
                "--sample-every", "0", "--no-ckpt", "--log-dir", os.path.join(log_dir, "log")]
        reset_counts(fa, fc, fw)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = cli.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts(fa, fc, fw)
        peak = torch.cuda.max_memory_allocated() / 2**30
        recompute = row.get("layerwise_grad") or row.get("remat") in ("full", "save_attn")
        n_layer = GPT2_1558M.n_layer
        fused = bool(mods["kernel_leaves"](gpt2.named_params(res["model"]), res["opt_state"]))
        want = with_zeros({"flash_fwd": 3 * 2 * n_layer * (2 if recompute else 1),
                           "flash_bwd": 3 * 2 * n_layer, "adamw": 3 if fused else 0,
                           **ce_train(3 * 2)})
        tps = _csv_train_tps(os.path.join(log_dir, "log"))
        print(f"  (c) cli.pretrain --model 1558M --fit-1chip ({row}), 3 steps of 2 x (B={b}, "
              f"T=1024): {wall:.1f} s, tokens/s by step {tps}, peak {peak:.2f} GiB; launches "
              f"{counts}", flush=True)
        require(counts == want, f"expected launches {want}, got {counts}")
        require(res["opt_state"]["step"] == 3 and [s for s, _ in tps] == [0, 1, 2],
                "the 1558M trainer did not take 3 steps")
        out["trainer"] = {"row": row, "tokens_per_s": [x for _, x in tps],
                          "tokens_per_s_steps_1_2": sum(x for _, x in tps[1:]) / 2,
                          "peak_gib": peak, "wall_s": wall, "launches": counts,
                          "launches_per_micro_batch": {"flash_fwd": counts["flash_fwd"] // 6,
                                                       "flash_bwd": counts["flash_bwd"] // 6}}
        del res
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(log_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (d) at 2 layers of the 1558M width, from one state: each mechanism
    # against the same step without it
    small = GPT2_1558M.replace(n_layer=2)
    model = gpt2.init(small, generator=torch.Generator(dev).manual_seed(33), device=dev)
    params = gpt2.named_params(model)
    r = torch.from_numpy(np.random.RandomState(33).randint(
        0, small.vocab_size, (8, 1025)).astype(np.int32)).to(dev)
    x, y = r[:, :-1], r[:, 1:]
    policy = mods["policy"]

    def standard(remat=False):
        for p in params.values():
            p.grad = None
        loss = gpt2.loss(model, x, small, targets=y, policy=policy, remat=remat)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return loss.item(), grads

    def layerwise():
        acc = GradAccumulators(params, {k: True for k in params}, torch.float32, 0)
        loss = gpt2.loss_grad_layerwise(model, x, small, targets=y, acc=acc, policy=policy)
        return loss.item(), acc.sums

    base_loss, base = standard()
    base_norm = mods["global_norm"](base).item()
    sq = lambda ts: sum(t_.float().square().sum().item() for t_ in ts)  # noqa: E731
    same = {}
    for label, fn in (("layerwise", layerwise),
                      *((f"remat {m}", lambda m=m: standard(m))
                        for m in ("full", "save_attn", "recompute_gelu", "recompute_mlp"))):
        reset_counts(fa, fc, fw)
        loss, grads = fn()
        counts = {k: v for k, v in read_counts(fa, fc, fw).items() if v}
        dl = abs(loss - base_loss)
        dn = abs(mods["global_norm"](grads).item() - base_norm) / base_norm
        dg = math.sqrt(sq(grads[k] - base[k] for k in base) / sq(base.values()))
        print(f"  (d) 2 layers x 1600: {label} vs standard: loss |diff| {dl:.3e} (tol 1e-2), "
              f"grad norm rel {dn:.3e} (tol 2e-2), grads ||err|| / ||ref|| {dg:.3e} (tol 2e-2); "
              f"launches {counts}", flush=True)
        require(dl <= 1e-2 and dn <= 2e-2 and dg <= 2e-2, f"{label} disagrees with the standard step")
        same[label] = {"loss_abs_err": dl, "grad_norm_rel_err": dn, "grads_rel_l2": dg,
                       "launches": counts}
    # the compact storages: two updates on the card against the same on the
    # CPU, the block leaves (both layers) and ln_f
    names = [k for k in params if k.startswith(("transformer.h.", "transformer.ln_f."))]
    norm = mods["global_norm"]({k: base[k] for k in names})
    upd = {}
    for label, pdt, odt in (("int8 moments", torch.float32, "int8"),
                            ("bf16 moments", torch.float32, "bfloat16"),
                            ("bf16 params", torch.bfloat16, None)):
        deltas, states = {}, {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            p = {k: params[k].detach().to(d, pdt, copy=True) for k in names}
            g = {k: base[k].to(d) for k in names}
            st = mods["adamw_init"](p, state_dtype=odt)
            dmask = {k: gpt2.decay_mask(model)[k] for k in names}
            mods["adamw_update"](p, g, st, 1e-3, cfgs["opt"], norm=norm.to(d), decay_mask=dmask)
            before = {k: t_.float().clone() for k, t_ in p.items()}
            g = {k: t_ * 0.5 for k, t_ in g.items()}
            mods["adamw_update"](p, g, st, 1e-3, cfgs["opt"], norm=(norm * 0.5).to(d),
                                 decay_mask=dmask)
            deltas[where] = {k: (p[k].float() - before[k]).cpu() for k in names}
            states[where] = st
        # the parameter change as a relative L2 error: a moment one code (or
        # one bf16 rounding) apart moves its element's update by up to the
        # LR, which a max-based reading turns into one element's whole update
        # (3.2e-2 of max|ref| for the 8-bit moments on an H100, one code
        # apart); the moments themselves are held to one code / one rounding
        l2 = math.sqrt(sum((deltas["card"][k] - deltas["cpu"][k]).square().sum().item()
                           for k in names) / sum(deltas["cpu"][k].square().sum().item()
                                                 for k in names))
        err = max((deltas["card"][k] - deltas["cpu"][k]).abs().max().item() for k in names)
        ref = max(deltas["cpu"][k].abs().max().item() for k in names)
        codes = moment_gap(torch, states["card"], states["cpu"])
        upd[label] = {"rel_l2": l2, "max_rel": err / ref, "moments": codes}
        print(f"  (d) {label}: the second update on the card vs the CPU: ||err|| / ||ref|| "
              f"{l2:.3e} (tol 3e-2), max|err| / max|ref| {err / ref:.3e}; moments {codes}",
              flush=True)
        require(l2 <= 3e-2 and codes["codes_max_gap"] <= 1 and codes["scales_max_rel"] <= 1e-5
                and codes["tensor_max_rel"] <= 2.0 ** -7,
                f"{label}: the update on the card disagrees with the CPU's")
    out["mechanisms_2_layers"] = {**same, "updates_card_vs_cpu": upd}
    del model, params, base
    torch.cuda.empty_cache()

    # (e) a resume under another --opt-state-dtype ends in the configured format
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_1558m_resume_")
    tempfile.tempdir = log_dir
    try:
        argv = ["--synthetic", "--synthetic-shards", "1", "--micro-batch", "8", "--total-batch",
                "16384", "--no-hellaswag", "--val-every", "0", "--sample-every", "0",
                "--log-dir", os.path.join(log_dir, "log")]
        first = cli.main(argv + ["--opt-state-dtype", "int8", "--steps", "2"], model=small)
        q8 = sorted(k for k, v in first["opt_state"]["m"].items() if isinstance(v, dict))
        del first
        second = cli.main(argv + ["--opt-state-dtype", "bfloat16", "--steps", "3"], model=small)
        m = second["opt_state"]["m"]
        steps = [s for s, _ in _csv_train_tps(os.path.join(log_dir, "log"))]
        ok = (second["opt_state"]["step"] == 3 and steps == [0, 1, 2]
              and all(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 for v in m.values())
              and set(m) == set(gpt2.named_params(second["model"])))
        print(f"  (e) 2 steps with --opt-state-dtype int8 ({len(q8)} 8-bit JAX leaves, e.g. "
              f"{q8[:3]}), then --steps 3 with bfloat16: train steps {steps}, every moment bf16 "
              f"and keyed by name: {ok}", flush=True)
        require(len(q8) > 0 and ok, "the resume under another --opt-state-dtype")
        out["resume"] = {"q8_leaves": len(q8), "steps": steps}
        del second
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(log_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# the one-process step's limits that a step over processes is held to
# (phase 8's, and phase 17's for the ring), plus its clip norm against the
# norm of its own gathered grads and its update against the plain AdamW
# replayed on them (tools/dist_worker.compare_steps)
PAR_LIMITS = {"loss_abs": 1e-2, "grad_norm_rel": 2e-2, "grads_rel_l2": 2e-2,
              "norm_self_rel": 1e-4, "update_max_rel": 1e-3, "eval_abs": 1e-2}
RING_LIMITS = dict(PAR_LIMITS, loss_abs=5e-3)
# the depth of the multi-process phases but 32's DP step, 34's 2 layers of
# the 1558M width and 35's ring: phase 33's TP steps, the command lines of
# 32b, 33b and 37b, and the pipelines of 37-38 run 2 of the preset's 12
# layers, to keep the script within its time
CUT_LAYERS = 2


def par_check(name, rec, limits, control=False):
    """Print a run's readings beside their limits; require them within (or,
    for a control, one of them outside)."""
    errs = rec["errors"]
    over = {k: v for k, v in errs.items() if v > limits[k]}
    print(f"  {name}: " + ", ".join(f"{k} {v:.3e} (tol {limits[k]})" for k, v in errs.items())
          + (f"; outside: {sorted(over)}" if over else ""), flush=True)
    if control:
        require(over, f"the control {name} passed the checks: they cannot see it")
    else:
        require(not over, f"{name} disagrees with the one-process step")


def par_counts(name, recs, want):
    """Each rank's launches of the step, against ``want`` (a dict, or one
    dict a rank); every other kernel 0."""
    for r, rec in enumerate(recs):
        w = with_zeros(want[r] if isinstance(want, list) else want)
        require(rec["launch_counts"] == w,
                f"{name} rank {r}: launches {rec['launch_counts']}, expected {w}")
    print(f"  {name} launches per rank: "
          + "; ".join(json.dumps({k: v for k, v in rec["launch_counts"].items() if v})
                      for rec in recs)
          + "; peak GiB per rank " + ", ".join(f"{rec['peak_gib']:.2f}" for rec in recs)
          + "; step s per rank " + ", ".join(f"{rec['seconds'][-1]:.3f}" for rec in recs),
          flush=True)


def par_records(workdir, tag, n):
    return [json.load(open(os.path.join(workdir, f"{tag}_r{r}.json"))) for r in range(n)]


def checkout_root(dist_worker):
    """The checkout: the package's parent."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(dist_worker.__file__))))


def write_hellaswag5(work):
    """A HellaSwag file of 5 examples (3 and 2 a rank of two data ranks)."""
    hs = os.path.join(work, "hellaswag")
    os.makedirs(hs)
    with open(os.path.join(hs, "hellaswag_val.jsonl"), "w") as f:
        for i in range(5):
            f.write(json.dumps({"ctx": f"The number {i} is", "label": i % 4,
                                "endings": ["small", "large!", "a word", "nothing"]}) + "\n")
    return hs


def cli_pair(work, root, label, args, runs, cli_s, cli_counts, hs=None, model=None):
    """Invocations of ``args`` on 2 processes (python -m torch.distributed.run
    --nproc_per_node 2 of the worker's "cli" job) on one log dir, each after
    the first resuming: ``runs`` is ((--steps, {kernel: launches a rank},
    host-staged exchanges a rank), ...). Returns (the log dir, the last
    invocation's output). ``model``: the job's architecture, the preset's
    replaced (GPTConfig keyword arguments)."""
    from gpt2_vision_language_tpu_torch.tools import dist_worker  # noqa: F401

    log = os.path.join(work, f"{label}_log")
    for i, (steps, want, staged) in enumerate(runs):
        tag = f"{label}_{i}"
        job = {"kind": "cli", "tag": tag, "out": work,
               "argv": args + ["--log-dir", log, "--steps", str(steps)]}
        if hs:
            job["hellaswag_dir"] = hs
        if model:
            job["model"] = model
        path = os.path.join(work, f"{tag}.json")
        with open(path, "w") as f:
            json.dump(job, f)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "gpt2_vision_language_tpu_torch.tools.dist_worker",
             path], capture_output=True, text=True, timeout=600, cwd=root)
        cli_s.setdefault(label, []).append(time.perf_counter() - t0)
        text = run.stdout + run.stderr
        tail = "\n".join(text.splitlines()[-25:])
        require(run.returncode == 0, f"torch.distributed.run of cli.pretrain failed:\n{tail}")
        require("backend gloo" in text, "the CLI did not take gloo for ranks sharing a card")
        require(i == 0 or f"[ckpt] resumed at step {runs[i - 1][0]}" in text,
                f"the CLI run did not resume:\n{tail}")
        recs = par_records(work, tag, 2)
        require([r["step"] for r in recs] == [steps, steps],
                f"{tag}: optimizer steps {[r['step'] for r in recs]}")
        for r, rec in enumerate(recs):
            w = with_zeros(want[r] if isinstance(want, list) else want)
            require(rec["launch_counts"] == w,
                    f"{tag} rank {r}: launches {rec['launch_counts']}, expected {w}")
            require(rec["host_staged"] == staged,
                    f"{tag} rank {r}: {rec['host_staged']} host-staged exchanges, expected {staged}")
        cli_counts[tag] = [rec["launch_counts"] for rec in recs]
        steps_logged = [ln for ln in text.splitlines() if ln.startswith("step ")]
        print(f"  {label} --steps {steps}: {cli_s[label][-1]:.1f} s; launches a rank "
              + "; ".join(json.dumps({k: v for k, v in rec["launch_counts"].items() if v})
                          for rec in recs)
              + f"; host-staged a rank {staged}; " + "; ".join(steps_logged), flush=True)
    rows = [ln.split(",") for f in sorted(glob.glob(os.path.join(log, "*.csv")))
            for ln in open(f).read().splitlines()[1:]]
    train = sorted({int(r[2]) for r in rows if r[1] == "train"})
    require(train == list(range(runs[-1][0])), f"{label}: the CLI runs logged train steps {train}")
    return log, text


def phase_parallel(torch, np, cfgs, dev):
    """Phases 32-36: the parallel styles over processes that share cuda:0
    over gloo (tools/dist_worker.py), each step held against the one-process
    step rank 0 runs first from the same state on the same rows."""
    from gpt2_vision_language_tpu_torch.tools import dist_worker

    work = tempfile.mkdtemp(prefix="chip_parallel_")
    base = {"device": "cuda:0", "policy": "bf16", "seed": 1337, "out": work, "reference": True,
            "save_whole": False, "step0": cfgs["sched"].warmup_steps, "threads": 2}
    vocab = cfgs["gpt"].vocab_size
    rows8 = np.random.RandomState(2).randint(0, vocab, (1, 4, 8, 1025)).astype(np.int32)
    paths = {}
    for name, a in (("rows8", rows8), ("rows_dp", rows8.reshape(1, 2, 16, 1025)),
                    ("rows_wide", np.random.RandomState(3).randint(0, vocab, (1, 2, 2, 1025))),
                    ("rows_ring", np.random.RandomState(4).randint(0, vocab, (1, 2, 1, 16385)))):
        paths[name] = os.path.join(work, f"{name}.npy")
        np.save(paths[name], a.astype(np.int32))
    out, seconds = {}, {}
    tp_model = {"n_layer": CUT_LAYERS}

    print("[32-33, 36] 2 processes on cuda:0 over gloo: DP, TP, TP+SP (GPT-2 124M, bf16, the "
          "global batch of phase 8: 4 x (B=8, T=1024)), DP fine-tunes", flush=True)
    k1 = {"flash_fwd": 24, "flash_bwd": 24, "adamw": 1, **ce_train(2)}
    jobs = [
        {"tag": "dp", "mesh": [2, 1], "rows": paths["rows_dp"], "model": {}},
        {"tag": "dp_no_allreduce", "mesh": [2, 1], "rows": paths["rows_dp"], "model": {},
         "fault": "skip_allreduce"},
        {"tag": "tp2", "mesh": [1, 2], "rows": paths["rows8"], "model": tp_model, "eval": True},
        {"tag": "tp2_sp", "mesh": [1, 2], "rows": paths["rows8"], "model": tp_model, "eval": True,
         "seq_parallel": True},
        # half the preset's per-rank batch: 2 ranks of 64 rows hold its 128
        {"kind": "ftstep", "tag": "ft_linear", "bridge": "linear", "n_layer": 12, "accum": 2,
         "b": 128, "t": 32, "n_bank": 256, "mesh": [2]},
        {"kind": "ftstep", "tag": "ft_qformer", "bridge": "qformer", "n_layer": 12, "accum": 2,
         "b": 128, "t": 32, "n_bank": 256, "mesh": [2]},
    ]
    t0 = time.perf_counter()
    dist_worker.launch(dict(base, kind="jobs", tag="two", jobs=jobs), 2, timeout=600,
                       workdir=work)
    seconds["two_process_launch"] = time.perf_counter() - t0
    recs = {j["tag"]: par_records(work, j["tag"], 2) for j in jobs}
    print("[32] DP, 2 ranks x 2 micro-batches of (B=8, T=1024)", flush=True)
    par_check("dp", recs["dp"][0], PAR_LIMITS)
    par_counts("dp", recs["dp"], k1)
    par_check("dp_no_allreduce (control)", recs["dp_no_allreduce"][0], PAR_LIMITS, control=True)
    print(f"[33] TP=2 (6 heads a rank) and TP=2 with sequence parallelism, {CUT_LAYERS} layers "
          "of 124M, 4 x (B=8, T=1024)", flush=True)
    for tag in ("tp2", "tp2_sp"):
        require([r["local_heads"] for r in recs[tag]] == [6, 6], f"{tag}: not 6 heads a rank")
        par_check(tag, recs[tag][0], PAR_LIMITS)
        par_counts(tag, recs[tag], {"flash_fwd": 4 * CUT_LAYERS, "flash_bwd": 4 * CUT_LAYERS,
                                    "adamw": 1, **ce_train(4)})
        for r, rec in enumerate(recs[tag]):  # the validation micro-batch: K4 on the gathered wte
            require(rec["eval_counts"] == with_zeros({"flash_fwd": CUT_LAYERS, "ce_fwd": 1}),
                    f"{tag} rank {r}: validation launches {rec['eval_counts']}")
    print("[36] DP fine-tunes, 2 ranks of 64 rows, 2 x (B=128, T=32) a step, 12 layers",
          flush=True)
    for tag in ("ft_linear", "ft_qformer"):
        par_check(tag, recs[tag][0], PAR_LIMITS)
        par_counts(tag, recs[tag], {"adamw": 1, **ce_train(2)})
    out.update({tag: {"errors": rs[0]["errors"], "seconds": [r["seconds"] for r in rs],
                      "peak_gib": [r["peak_gib"] for r in rs]} for tag, rs in recs.items()})
    out["dp"]["tokens_per_s"] = recs["dp"][0]["tokens_per_step"] / recs["dp"][0]["seconds"][-1]
    dp_counts = recs["dp"][0]["launch_counts"]
    tp_counts = recs["tp2"][0]["launch_counts"]

    recs4, ring_paths = phase_ring_parallel(torch, np, cfgs, base, paths, work, seconds, out)
    out["host_staged_calls"] = {tag: [r["host_staged"] for r in rs]
                                for tag, rs in {**recs, **recs4}.items()}
    for tag in recs:  # only the ring's hops and swaps cross host memory
        staged = out["host_staged_calls"][tag]
        require(staged == [0] * len(staged),
                f"{tag}: host-staged exchanges a rank {staged}, expected none")

    # the command line as users launch it, each rank's cli.pretrain.main run
    # through the worker's "cli" job, which reads its launch counts
    root = checkout_root(dist_worker)
    hs = write_hellaswag5(work)
    cli_s, cli_counts = {}, {}

    def cli_runs(label, args, runs, hellaswag=False, model=None):
        return cli_pair(work, root, label, args, [(n, w, 0) for n, w in runs], cli_s, cli_counts,
                        hs if hellaswag else None, model)

    print("[32b] python -m torch.distributed.run --nproc_per_node 2 -m "
          "gpt2_vision_language_tpu_torch.tools.dist_worker JOB: cli.pretrain --synthetic "
          "--devices 2 --device cuda:0 --total-batch 32768 --val-every 0 --steps 1 (2 x (B=8, "
          f"T=1024) a rank, {CUT_LAYERS} layers of 124M), then --steps 2 (a resume)", flush=True)
    print("[33b] beside 32b, the same of cli.pretrain --devices 2 --tp 2 --seq-parallel --device "
          "cuda:0 --micro-batch 1 --total-batch 1024 --val-every 1 --save-every 1 "
          f"--sample-every 1 --steps 1, {CUT_LAYERS} layers of 124M, HellaSwag of 5 examples, "
          "then --steps 2 (a resume)", flush=True)
    k1_micro = lambda n: {"flash_fwd": CUT_LAYERS * n, "flash_bwd": CUT_LAYERS * n}  # noqa: E731
    # 33b: a step: its micro-batch (K4 and K4b on the rank's T-shard);
    # validation: 20 micro-batches, each a K1 a layer and one K4 on the
    # gathered wte; HellaSwag: the one data rank's 5 examples on both model
    # ranks, one forward at the 64-token width bucket, under the flash
    # kernel's T >= 512 (ops/attention.AUTO_FLASH_MIN_T):
    # plain attention, as on one process; sampling: no kernel. The two
    # command lines run side by side (their own processes and log dirs), to
    # keep the script within its time
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        dp_cli = pool.submit(
            cli_runs, "cli_dp", ["--synthetic", "--synthetic-shards", "1", "--devices", "2",
                                 "--device", "cuda:0", "--total-batch", "32768",
                                 "--val-every", "0", "--no-hellaswag"],
            [(n, {**k1_micro(2), "adamw": 1, **ce_train(2)}) for n in (1, 2)], model=tp_model)
        tp_cli = pool.submit(
            cli_runs, "cli_tp_sp", ["--synthetic", "--synthetic-shards", "1", "--devices", "2",
                                    "--tp", "2", "--seq-parallel", "--device", "cuda:0",
                                    "--micro-batch", "1", "--total-batch", "1024",
                                    "--val-every", "1", "--save-every", "1", "--sample-every",
                                    "1"],
            [(n, {"flash_fwd": CUT_LAYERS * (1 + 20), "flash_bwd": CUT_LAYERS, "adamw": 1,
                  **ce_train(1, val=20)}) for n in (1, 2)], hellaswag=True, model=tp_model)
        log, _ = dp_cli.result()
        # without validation only model_final is written, by the master alone
        require(os.listdir(os.path.join(log, "ckpts")) == ["model_final.pt"],
                "the CLI's checkpoints")
        log, text = tp_cli.result()
    require(sorted(os.listdir(os.path.join(log, "ckpts")))
            == ["model_best.pt", "model_final.pt", "model_last.pt"], "the TP CLI's checkpoints")
    final = torch.load(os.path.join(log, "ckpts", "model_final.pt"), map_location="cpu",
                       weights_only=False)
    require(tuple(final["model"]["transformer.wte.weight"].shape)
            == (cfgs["gpt"].padded_vocab_size, cfgs["gpt"].n_embd),
            "the TP checkpoint does not hold the whole (gathered) wte")
    hella = [ln for ln in text.splitlines() if ln.startswith("HellaSwag accuracy:")]
    require(len(hella) == 1 and "/5=" in hella[0], f"the resumed TP run's HellaSwag: {hella}")
    require(any(ln.startswith("sample 0:") for ln in text.splitlines()),
            "the TP run did not sample")
    seconds["cli_runs"] = cli_s
    shutil.rmtree(work, ignore_errors=True)
    # each phase's wall seconds: its jobs' (the slowest rank's, rank 0's
    # reference included), the CLI runs in phase 32's
    wall = {tag: max(r["wall_s"] for r in rs) for tag, rs in {**recs, **recs4}.items()}
    seconds["phases"] = {
        "32": wall["dp"] + wall["dp_no_allreduce"] + sum(cli_s["cli_dp"]),
        "33": wall["tp2"] + wall["tp2_sp"] + sum(cli_s["cli_tp_sp"]),
        "34": wall["tp4_wide"] + wall["tp4_norm_counts_replicated"],
        "35": wall["ring4"], "35b-e": sum(wall[t] for t in RING_JOBS),
        "36": wall["ft_linear"] + wall["ft_qformer"]}
    print("  wall seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds["phases"].items())
          + f"; tokens/s: DP {out['dp']['tokens_per_s']:.1f}, the process ring "
          f"{out['ring4']['tokens_per_s']:.1f} (host- and gloo-paced, one shared card)",
          flush=True)
    out["seconds"] = seconds
    out["cli_launches"] = cli_counts
    return out, {"dp_train_step": dp_counts, "tp_train_step": tp_counts, **ring_paths}


# the ring compositions of phases 35b-e and their controls, each a job of the
# 4-process launch on 2 layers: tag -> (its model and rows in
# phase_ring_parallel's RING_MODELS, its job's own keys)
RING_JOBS = {
    "ring4_sp": ("two", {"seq_parallel": True}),
    "ring4_layerwise": ("two", {"layerwise": True}),
    "ring4_sp_wide": ("wide", {"seq_parallel": True}),
    "ring4_f32": ("two", {"policy": "fp32"}),
    "ring4_a2a_identity_backward": ("two", {"fault": "a2a_identity_backward"}),
    "ring4_drop_merge_weights": ("two", {"fault": "drop_merge_weights"}),
}
# the models of phase 35's launch (GPTConfig keyword arguments, the 124M
# preset's width unless given) and the sequence length of their rows: 35 at
# full depth and T=16384, the compositions and the controls at 2 layers and
# T=4096 (a chunk of 1024 a rank; the controls share 35b's one-process step),
# 35d at the 1558M width
RING_MODELS = {
    "ring4": ({"block_size": 16384}, 16384),
    "two": ({"n_layer": 2, "block_size": 4096}, 4096),
    "wide": ({"n_layer": 2, "n_head": 25, "n_embd": 1600, "block_size": 4096}, 4096),
}


def megatron_bytes(torch, cfg, n):
    """The fp32 parameter bytes each of n ranks holds under the Megatron
    placement of ``cfg`` (parallel/sharding.TensorParallel's whole heads, MLP
    columns and vocab rows; every other leaf whole)."""
    from gpt2_vision_language_tpu_torch.models import gpt2
    from gpt2_vision_language_tpu_torch.parallel.sharding import TensorParallel

    with torch.device("meta"):
        shapes = {n_: tuple(p.shape) for n_, p in gpt2.named_params(gpt2.GPT2(cfg)).items()}
    out = []
    for r in range(n):
        tp = TensorParallel(None, r, n, cfg)
        total = 0
        for name, shape in shapes.items():
            where = tp.index(name, shape)
            numel = math.prod(shape)
            total += numel if where is None else numel // shape[where[0]] * len(where[1])
        out.append(4 * total)
    return out


def placement_bytes_excess(held, want):
    """Each rank's (param bytes, moment bytes) against the Megatron
    placement's fp32 params ``want[r]`` and their two fp32 moments: the
    bytes over or under, 0 where the rank holds its shards."""
    return [abs(p - w) + abs(m - 2 * w) for (p, m), w in zip(held, want)]


def ring_check(name, recs, want_counts, staged, want_bytes, limits=RING_LIMITS):
    """A ring job of the 4-process launch: rank 0's step against the
    one-process step, every rank's launches, host-staged hops and placement
    bytes, the whole model's bytes and the peak GiB printed beside them."""
    par_check(name, recs[0], limits)
    par_counts(name, recs, want_counts)
    got = [r["host_staged"] for r in recs]
    require(got == [staged] * len(recs),
            f"{name}: host-staged hops a rank {got}, expected {staged}")
    held = [(r["param_bytes"], r["moment_bytes"]) for r in recs]
    excess = placement_bytes_excess(held, want_bytes)
    print(f"  {name}: param + moment bytes a rank "
          + ", ".join(f"{p + m:,}" for p, m in held)
          + f" (Megatron placement {', '.join(f'{3 * w:,}' for w in want_bytes)}; the whole "
          f"model {3 * recs[0]['whole_param_bytes']:,}); host-staged hops a rank {staged}",
          flush=True)
    require(not any(excess), f"{name}: a rank's bytes are not its Megatron shards' ({excess})")


def phase_ring_parallel(torch, np, cfgs, base, paths, work, seconds, out):
    """Phases 34-35e, one launch of 4 processes on cuda:0 over gloo: TP=4 at
    the 1558M width with its norm control; the ring over the model group
    inside Megatron-sharded attention (each rank its shards of the params
    and moments, heads swapped for a T/4 chunk of every head by an all-to-all
    around the ring) at 124M, then at 2 layers with sequence parallelism,
    with the layerwise backward, with sequence parallelism at the 1558M
    width (T=4096), and under FP32_POLICY, with two controls that must fail.
    Returns (each job's records, the ring paths' summed launches)."""
    from gpt2_vision_language_tpu_torch.core.config import GPTConfig
    from gpt2_vision_language_tpu_torch.tools import dist_worker

    vocab = cfgs["gpt"].vocab_size
    for t in {t for _, t in RING_MODELS.values()} - {16384}:  # phase 35's rows are phase 32's
        paths[f"rows_ring_{t}"] = os.path.join(work, f"rows_ring_{t}.npy")
        np.save(paths[f"rows_ring_{t}"],
                np.random.RandomState(t).randint(0, vocab, (1, 2, 1, t + 1)).astype(np.int32))
    paths["rows_ring_16384"] = paths["rows_ring"]
    print("[34-35e] 4 processes on cuda:0 over gloo: TP=4 at the 1558M width (7, 6, 6, 6 "
          "heads), the ring of 4 chunks at T=16384 in the Megatron placement, its "
          "compositions at 2 layers", flush=True)
    wide = {"n_layer": 2, "n_head": 25, "n_embd": 1600}
    jobs = [
        {"tag": "tp4_wide", "mesh": [1, 4], "rows": paths["rows_wide"], "model": wide},
        {"tag": "tp4_norm_counts_replicated", "mesh": [1, 4], "rows": paths["rows_wide"],
         "model": wide, "fault": "count_replicated"},
        {"tag": "ring4", "mesh": [1, 4], "rows": paths["rows_ring"], "ring": True,
         "model": RING_MODELS["ring4"][0]},
    ]
    for tag, (size, extra) in RING_JOBS.items():
        model, t = RING_MODELS[size]
        jobs.append({"tag": tag, "mesh": [1, 4], "ring": True, **extra,
                     "rows": paths[f"rows_ring_{t}"], "model": model})
    t0 = time.perf_counter()
    dist_worker.launch(dict(base, kind="jobs", tag="four", jobs=jobs), 4, timeout=900,
                       workdir=work)
    seconds["four_process_launch"] = time.perf_counter() - t0
    recs4 = {j["tag"]: par_records(work, j["tag"], 4) for j in jobs}
    print("[34] TP=4 at n_embd=1600, n_head=25, 2 layers, 2 x (B=2, T=1024)", flush=True)
    require([r["local_heads"] for r in recs4["tp4_wide"]] == [7, 6, 6, 6],
            "tp4_wide: heads are not 7, 6, 6, 6")
    par_check("tp4_wide", recs4["tp4_wide"][0], PAR_LIMITS)
    par_counts("tp4_wide", recs4["tp4_wide"], {"flash_fwd": 4, "flash_bwd": 4, "adamw": 1,
                                               **ce_train(2)})
    par_check("tp4_norm_counts_replicated (control)", recs4["tp4_norm_counts_replicated"][0],
              PAR_LIMITS, control=True)

    def lse(k_fwd, k_bwd, f32=False, ce_chunks=8):
        """rank r's launches: its own chunk and the r before it, 1 + r pairs
        a layer, each a K2a (k_fwd times) and a D and a K3c (k_bwd times);
        in bf16 K4 and K4b (``ce_chunks`` chunks) on each of the 2
        micro-batches."""
        sfx = "_f32" if f32 else ""
        ce = {} if f32 else ce_train(2, ce_chunks)
        return [{f"flash_lse_fwd{sfx}": k_fwd * (r + 1), f"flash_rowdot{sfx}": k_bwd * (r + 1),
                 f"flash_fused_bwd{sfx}": k_bwd * (r + 1), "adamw": 1, **ce} for r in range(4)]

    # the worker's GPTConfig of each job's model
    want_bytes = {k: megatron_bytes(torch, GPTConfig(**m), 4) for k, (m, _) in RING_MODELS.items()}
    # a micro-batch's staged hops a layer: the ring's 3 K/V hops forward and
    # 3 backward, the 2 swaps forward and 2 backward (the layerwise backward's
    # recompute: 3 hops and 2 swaps more)
    print("[35] the ring over 4 processes in the Megatron placement: GPT-2 124M, 2 x (B=1, "
          "T=16384), a chunk of 4096 a rank, 3 heads a rank", flush=True)
    ring = recs4["ring4"]
    require([r["local_heads"] for r in ring] == [3, 3, 3, 3], "ring4: not 3 heads a rank")
    ring_check("ring4", ring, lse(24, 24), 12 * 2 * 10, want_bytes["ring4"])
    for k in ("flash_lse_fwd", "flash_rowdot", "flash_fused_bwd"):
        require(sum(r["launch_counts"][k] for r in ring) == 240,
                f"the ranks' {k} launches do not sum to the one-process ring's 240")
    print("  the whole model on every rank (the one-process step's placement) against the "
          "bytes check (control): ", end="", flush=True)
    ref = ring[0]["reference"]
    whole_excess = placement_bytes_excess([(ref["param_bytes"], ref["moment_bytes"])] * 4,
                                          want_bytes["ring4"])
    print(", ".join(f"{e:,}" for e in whole_excess) + " bytes over", flush=True)
    require(all(whole_excess), "the bytes check passed the whole-leaf placement: it cannot see it")
    print("[35b] the ring with sequence parallelism, 2 layers of 124M, 2 x (B=1, T=4096)",
          flush=True)
    ring_check("ring4_sp", recs4["ring4_sp"], lse(4, 4), 2 * 2 * 10, want_bytes["two"])
    print("[35c] the ring with the layerwise backward, 2 layers of 124M, 2 x (B=1, T=4096)",
          flush=True)
    ring_check("ring4_layerwise", recs4["ring4_layerwise"], lse(8, 4, ce_chunks=2), 2 * 2 * 15,
               want_bytes["two"])
    print("[35d] the ring with sequence parallelism at the 1558M width (25 heads: 7, 6, 6, 6 "
          "a rank), 2 layers, 2 x (B=1, T=4096), a chunk of 1024 a rank", flush=True)
    require([r["local_heads"] for r in recs4["ring4_sp_wide"]] == [7, 6, 6, 6],
            "ring4_sp_wide: heads are not 7, 6, 6, 6")
    ring_check("ring4_sp_wide", recs4["ring4_sp_wide"], lse(4, 4), 2 * 2 * 10,
               want_bytes["wide"])
    print("[35e] the ring under FP32_POLICY, 2 layers of 124M, 2 x (B=1, T=4096): the fp32 "
          "K2a and K3c (its cooperative grid) with four processes on the card", flush=True)
    ring_check("ring4_f32", recs4["ring4_f32"], lse(4, 4, f32=True), 2 * 2 * 10,
               want_bytes["two"], limits=dict(RING_LIMITS, loss_abs=1e-4, grad_norm_rel=1e-4,
                                               grads_rel_l2=1e-4))
    print("  the controls, as 35b without sequence parallelism:", flush=True)
    for tag in ("ring4_a2a_identity_backward", "ring4_drop_merge_weights"):
        par_check(f"{tag} (control)", recs4[tag][0], RING_LIMITS, control=True)
    for tag, rs in recs4.items():
        out[tag] = {"errors": rs[0]["errors"], "seconds": [r["seconds"] for r in rs],
                    "peak_gib": [r["peak_gib"] for r in rs],
                    "host_staged": [r["host_staged"] for r in rs]}
        if tag.startswith("ring4"):
            out[tag].update(tokens_per_s=rs[0]["tokens_per_step"] / rs[0]["seconds"][-1],
                            param_moment_bytes=[r["param_bytes"] + r["moment_bytes"]
                                                for r in rs],
                            whole_param_moment_bytes=3 * rs[0]["whole_param_bytes"],
                            collectives=rs[0]["collectives"])
    paths_out = {}
    for path, tag in (("process_ring_train_step", "ring4"),
                      ("process_ring_sp_train_step", "ring4_sp"),
                      ("process_ring_layerwise_train_step", "ring4_layerwise"),
                      ("process_ring_sp_wide_train_step", "ring4_sp_wide"),
                      ("process_ring_fp32_train_step", "ring4_f32")):
        rs = recs4[tag]
        paths_out[path] = {k: sum(r["launch_counts"][k] for r in rs)
                           for k in rs[0]["launch_counts"]}
    return recs4, paths_out


# the int8 runs against the one-process int8 run (tools/dist_worker.compare_q8):
# JAX test_pipeline_int8_moments_parity's loss and grad-norm tolerances, its
# params' rtol 2e-4 with one quantization step for atol; the codes equal but
# in a thousandth of them, where fp32 rounding moved a value across a rounding
# boundary or the scale of a block of near-zero gradients (a grid of the
# rank's own moves over a tenth)
Q8_LIMITS = {"loss_rel": 2e-5, "grad_norm_rel": 1e-3, "params_outside": 0, "codes_differ": 1e-3}


def phase_pipeline(torch, np, cfgs, dev):
    """Phases 37-40: the GPipe pipeline and 8-bit moments under TP and PP
    over processes that share cuda:0 over gloo, each step held against the
    one-process step rank 0 runs first from the same state on the same
    rows; the pipelined command line with a resume; the port's
    dryrun_multichip."""
    from gpt2_vision_language_tpu_torch.tools import dist_worker

    work = tempfile.mkdtemp(prefix="chip_pipeline_")
    base = {"device": "cuda:0", "policy": "bf16", "seed": 1337, "out": work, "reference": True,
            "save_whole": False, "step0": cfgs["sched"].warmup_steps, "threads": 2}
    vocab, n_layer = cfgs["gpt"].vocab_size, CUT_LAYERS
    pp_model = {"n_layer": n_layer}
    paths = {}
    for name, a in (("rows_pp", np.random.RandomState(5).randint(0, vocab, (1, 2, 8, 1025))),
                    ("rows_q8", np.random.RandomState(6).randint(0, vocab, (2, 2, 4, 1025)))):
        paths[name] = os.path.join(work, f"{name}.npy")
        np.save(paths[name], a.astype(np.int32))
    out, seconds = {}, {}
    per = n_layer // 2  # layers a stage
    # a rank's step at pp = 2, pp_micro 4, 2 x (B=8, T=1024): its layers on
    # each of 4 sub-batches of each micro-batch, the CE over the whole
    # micro-batch on the last stage; the validation micro-batch once through
    # the forward, K4 on the last stage
    k1 = {"flash_fwd": per * 4 * 2, "flash_bwd": per * 4 * 2, "adamw": 1}
    # the last stage's: K4 over each micro-batch, K4b on its chunks
    train = [k1, {**k1, **ce_train(2)}]
    ev = [{"flash_fwd": per * 4}, {"flash_fwd": per * 4, "ce_fwd": 1}]
    # 4 sub-batches' hops forward and back, 2 micro-batches, and the
    # validation micro-batch's 4 forward
    staged = 4 * 2 * 2 + 4

    print(f"[37, 39] 2 processes on cuda:0 over gloo: pp = 2 ({n_layer} layers of GPT-2 124M, "
          f"{per} a stage, pp_micro 4, 2 x (B=8, T=1024), bf16) and its controls; 8-bit "
          "moments under TP = 2 and pp = 2 (124M width, 2 layers, fp32, 2 steps of 2 x (B=4, "
          "T=1024)) and the per-shard control", flush=True)
    q8 = {"rows": paths["rows_q8"], "model": {"n_layer": 2}, "policy": "fp32",
          "opt_state_dtype": "int8", "step0": 0}
    jobs = [
        {"tag": "pp2", "mesh": [1, 1], "pp": 2, "pp_micro": 4, "rows": paths["rows_pp"],
         "model": pp_model, "eval": True, "repeat": 1},
        {"tag": "pp2_drop_backward_hop", "mesh": [1, 1], "pp": 2, "pp_micro": 4,
         "rows": paths["rows_pp"], "model": pp_model, "fault": "drop_backward_hop"},
        {"tag": "pp2_norm_counts_replicated", "mesh": [1, 1], "pp": 2, "pp_micro": 4,
         "rows": paths["rows_pp"], "model": pp_model, "fault": "count_replicated"},
        dict(q8, tag="int8_tp2", mesh=[1, 2]),
        dict(q8, tag="int8_pp2", mesh=[1, 1], pp=2),
        dict(q8, tag="int8_tp2_per_shard", mesh=[1, 2], fault="per_shard_q8"),
    ]
    t0 = time.perf_counter()
    dist_worker.launch(dict(base, kind="jobs", tag="pipe_two", jobs=jobs), 2, timeout=600,
                       workdir=work)
    seconds["two_process_launch"] = time.perf_counter() - t0
    recs = {j["tag"]: par_records(work, j["tag"], 2) for j in jobs}
    print(f"[37] pp = 2 over 2 processes, layers 0-{per - 1} and {per}-{n_layer - 1}", flush=True)
    require([r["stage_layers"] for r in recs["pp2"]] == [list(range(per)),
                                                          list(range(per, n_layer))],
            "pp2: the stages do not hold their layers")
    par_check("pp2", recs["pp2"][0], PAR_LIMITS)
    par_counts("pp2", recs["pp2"], train)
    for r, rec in enumerate(recs["pp2"]):
        require(rec["eval_counts"] == with_zeros(ev[r]),
                f"pp2 rank {r}: validation launches {rec['eval_counts']}")
    par_check("pp2_drop_backward_hop (control)", recs["pp2_drop_backward_hop"][0], PAR_LIMITS,
              control=True)
    par_check("pp2_norm_counts_replicated (control)", recs["pp2_norm_counts_replicated"][0],
              PAR_LIMITS, control=True)
    print("[39] 8-bit moments, 2 steps, against the one-process int8 run", flush=True)
    f32 = {"flash_fwd_f32": 8, "flash_bwd_f32": 8, "adamw": 2}
    for tag in ("int8_tp2", "int8_pp2"):
        par_check(tag, recs[tag][0], Q8_LIMITS)
        par_counts(tag, recs[tag], f32)
        detail = recs[tag][0]["q8_detail"]
        codes = max((d["max_diff"], k) for k, d in detail.items() if k.endswith(":q"))
        scale = max((d["max_rel"], k) for k, d in detail.items() if k.endswith(":s"))
        print(f"  {tag}: moment bytes a rank {[r['moment_bytes'] for r in recs[tag]]} (one "
              f"process {recs[tag][0]['reference']['moment_bytes']}); collectives a step "
              f"{recs[tag][0]['collectives']}; the largest code difference {codes[0]} "
              f"({codes[1]}), the largest scale difference {scale[0]:.3e} ({scale[1]}, block "
              f"{detail[scale[1]]['at_block']}, scale {detail[scale[1]]['ref_scale']:.3e})",
              flush=True)
    par_check("int8_tp2_per_shard (control)", recs["int8_tp2_per_shard"][0], Q8_LIMITS,
              control=True)

    print(f"[38] pp = 2 x tp = 2 over 4 processes ({n_layer} layers of 124M, {per} layers and 6 "
          "heads a rank, pp_micro 4, 2 x (B=8, T=1024), bf16)", flush=True)
    jobs4 = [{"tag": "pp2xtp2", "mesh": [1, 2], "pp": 2, "pp_micro": 4, "rows": paths["rows_pp"],
              "model": pp_model, "eval": True, "repeat": 1}]
    t0 = time.perf_counter()
    dist_worker.launch(dict(base, kind="jobs", tag="pipe_four", jobs=jobs4), 4, timeout=600,
                       workdir=work)
    seconds["four_process_launch"] = time.perf_counter() - t0
    recs["pp2xtp2"] = par_records(work, "pp2xtp2", 4)
    ptp = recs["pp2xtp2"]
    require([r["local_heads"] for r in ptp] == [6, 6, 6, 6], "pp2xtp2: not 6 heads a rank")
    require([r["stage_layers"] for r in ptp] == [list(range(per))] * 2
            + [list(range(per, n_layer))] * 2, "pp2xtp2: the stages do not hold their layers")
    par_check("pp2xtp2", ptp[0], PAR_LIMITS)
    par_counts("pp2xtp2", ptp, [train[0]] * 2 + [train[1]] * 2)
    for r, rec in enumerate(ptp):
        require(rec["eval_counts"] == with_zeros(ev[r // 2]),
                f"pp2xtp2 rank {r}: validation launches {rec['eval_counts']}")
    for tag in ("pp2", "pp2xtp2"):
        require([r["host_staged"] for r in recs[tag]] == [staged] * len(recs[tag]),
                f"{tag}: host-staged exchanges a rank {[r['host_staged'] for r in recs[tag]]}, "
                f"expected {staged}")
    for tag, rs in recs.items():
        ref = rs[0].get("reference") or {}
        out[tag] = {"errors": rs[0]["errors"], "seconds": [r["seconds"] for r in rs],
                    "peak_gib": [r["peak_gib"] for r in rs],
                    "host_staged": [r["host_staged"] for r in rs],
                    "collectives_a_step": [r["collectives"] for r in rs],
                    "moment_bytes": [r["moment_bytes"] for r in rs],
                    "one_process": ref}
    for tag in ("pp2", "pp2xtp2"):
        # a warm step (the last of `repeat`; the compared first step is cold)
        rec, ref = recs[tag][0], recs[tag][0]["reference"]
        out[tag]["warm_seconds"] = [r["warm_seconds"] for r in recs[tag]]
        out[tag]["tokens_per_s"] = rec["tokens_per_step"] / max(r["warm_seconds"][-1]
                                                                for r in recs[tag])
        out[tag]["one_process_tokens_per_s"] = ref["tokens_per_step"] / ref["warm_seconds"][-1]
        # GPipe's bubble at S = 2, M = 4: (S - 1) / (M + S - 1) of the ticks,
        # against the share of the step the one-process step's time leaves
        out[tag]["bubble_share"] = 1 / (4 + 2 - 1)
        out[tag]["one_process_share_of_step"] = (out[tag]["tokens_per_s"]
                                                 / out[tag]["one_process_tokens_per_s"])

    print("[37b] python -m torch.distributed.run --nproc_per_node 2 -m "
          "gpt2_vision_language_tpu_torch.tools.dist_worker JOB: cli.pretrain --synthetic "
          "--devices 2 --pp 2 --pp-micro 4 --device cuda:0 --total-batch 16384 --val-every 2 "
          f"--save-every 2 --sample-every 2 --steps 1 (2 x (B=8, T=1024), {n_layer} layers of "
          "124M), HellaSwag of 5 examples, then --steps 2 (a resume)", flush=True)
    root = checkout_root(dist_worker)
    hs = write_hellaswag5(work)
    cli_s, cli_counts = {}, {}
    # a step: train; a validation: 20 micro-batches, each 4 sub-batches through a
    # stage's layers and K4 once on the last stage; HellaSwag (the 64-token
    # bucket) and sampling on the gathered stages: no kernel
    val = [{"flash_fwd": per * 4 * 20}, {"flash_fwd": per * 4 * 20, "ce_fwd": 20}]

    def counts(steps, vals):
        return [{k: steps * t.get(k, 0) + vals * v.get(k, 0)
                 for k in ("flash_fwd", "flash_bwd", "ce_fwd", "ce_bwd", "adamw")}
                for t, v in zip(train, val)]

    print("[40] beside 37b, python -m gpt2_vision_language_tpu_torch.tools.dryrun_multichip 4 "
          "--device cuda:0 (its own 4 processes)", flush=True)
    t0 = time.perf_counter()
    dry = subprocess.Popen([sys.executable, "-m", "gpt2_vision_language_tpu_torch.tools."
                            "dryrun_multichip", "4", "--device", "cuda:0"], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, cwd=root)
    try:
        log, text = cli_pair(
            work, root, "cli_pp", ["--synthetic", "--synthetic-shards", "1", "--devices", "2",
                                   "--pp", "2", "--pp-micro", "4", "--device", "cuda:0",
                                   "--total-batch", "16384", "--val-every", "2",
                                   "--save-every", "2", "--sample-every", "2"],
            [(n, counts(1, 1), 16 + 20 * 4) for n in (1, 2)], cli_s,
            cli_counts, hs, pp_model)
        dry_text, _ = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
    seconds["dryrun"] = time.perf_counter() - t0  # beside 37b: its wall, not its own time
    require(sorted(os.listdir(os.path.join(log, "ckpts")))
            == ["model_best.pt", "model_final.pt", "model_last.pt"], "the pp CLI's checkpoints")
    final = torch.load(os.path.join(log, "ckpts", "model_final.pt"), map_location="cpu",
                       weights_only=False)
    require(set(final["model"]) == set(gpt_state_names(cfgs["gpt"].replace(n_layer=n_layer))),
            "the pp checkpoint does not hold the whole model")
    hella = [ln for ln in text.splitlines() if ln.startswith("HellaSwag accuracy:")]
    require(len(hella) == 1 and "/5=" in hella[0], f"the resumed pp run's HellaSwag: {hella}")
    require(any(ln.startswith("sample 0:") for ln in text.splitlines()), "the pp run did not sample")
    gathers = [ln for ln in text.splitlines() if ln.startswith("[pp] stages gathered")]
    print("  " + "; ".join(gathers), flush=True)
    seconds["cli_runs"] = cli_s

    tail = "\n".join(dry_text.splitlines()[-25:])
    require(dry.returncode == 0, f"dryrun_multichip failed:\n{tail}")
    line = [ln for ln in dry_text.strip().splitlines() if ln.startswith("dryrun_multichip(")][-1]
    require(line.startswith("dryrun_multichip(4): ok — ") and "pp(2 stages)" in line
            and "ring step loss" in line, f"dryrun_multichip printed {line!r}")
    print(f"  {line} ({seconds['dryrun']:.1f} s)", flush=True)
    out["dryrun"] = line
    shutil.rmtree(work, ignore_errors=True)
    wall = {tag: max(r["wall_s"] for r in rs) for tag, rs in recs.items()}
    seconds["phases"] = {
        "37": wall["pp2"] + wall["pp2_drop_backward_hop"] + wall["pp2_norm_counts_replicated"]
        + sum(cli_s["cli_pp"]),
        "38": wall["pp2xtp2"],
        "39": wall["int8_tp2"] + wall["int8_pp2"] + wall["int8_tp2_per_shard"],
        "40": seconds["dryrun"]}
    print("  wall seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds["phases"].items())
          + f"; tokens/s: pp2 {out['pp2']['tokens_per_s']:.1f} (one process "
          f"{out['pp2']['one_process_tokens_per_s']:.1f}), pp2xtp2 "
          f"{out['pp2xtp2']['tokens_per_s']:.1f} (host- and gloo-paced, one shared card)",
          flush=True)
    out["seconds"] = seconds
    out["cli_launches"] = cli_counts
    out["readings_are"] = ("host- and gloo-paced on one shared card (ranks on cuda:0 over "
                           "gloo), not a scaling result")
    return out, {"pp_train_step": recs["pp2"][0]["launch_counts"],
                 "pp_tp_train_step": ptp[0]["launch_counts"]}


def gpt_state_names(cfg):
    """The state-dict names of a whole GPT-2 of ``cfg``."""
    import torch

    from gpt2_vision_language_tpu_torch.models import gpt2

    with torch.device("meta"):
        return list(gpt2.GPT2(cfg).state_dict())


def host_us(torch, fn, iters):
    """(host microseconds a call spends enqueueing fn(), microseconds a call
    of the same loop synchronised at its end): when the first is not below
    the kernel's device time, the host sets the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / iters * 1e6, (t2 - t0) / iters * 1e6


def kernel_name(mangled):
    """The kernel's own name in a mangled one: its last <length><name>
    component that ends in ``_kernel`` (the anonymous namespace's component
    holds the source's name and a hash, digits included), else the mangled
    name."""
    found, i = mangled, 0
    while i < len(mangled):
        m = re.compile(r"\d+").match(mangled, i)
        if not m:
            i += 1
            continue
        ident = mangled[m.end():m.end() + int(m.group())]
        if ident.endswith("_kernel"):
            found = ident
        i = m.end() + len(ident)
    return found


def _sass(so):
    """The built library's SASS, by the toolkit's cuobjdump -sass."""
    from gpt2_vision_language_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, timeout=300)
    require(dump.returncode == 0, f"cuobjdump failed: {dump.stderr.strip()[:500]}")
    return dump.stdout


def _sass_functions(so):
    """[(kernel function, [its SASS instruction lines])] of the built library."""
    funcs = []
    for line in _sass(so).splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            funcs.append((kernel_name(fn.group(1)), []))
        elif funcs and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            funcs[-1][1].append(line)
    return funcs


def sass_counts(so):
    """{kernel function: its SASS instructions} in the built library, read
    with the toolkit's cuobjdump -sass: a refactor of a tuned kernel is held
    to its parent's count."""
    counts = {}
    for name, lines in _sass_functions(so):
        while name in counts:
            name += "'"
        counts[name] = len(lines)
    return counts


# SASS opcodes counted in the fp32 pair: tensor-core products (there must be
# none: every product is an FFMA) and atomics or reductions to memory (none in
# the backward: dq, dk, dv are bit-equal run to run), beside the FFMAs, the
# shared-memory reads and the asynchronous copies
F32_OPCODES = ("HMMA", "HGMMA", "RED", "REDG", "REDS", "ATOM", "ATOMG", "ATOMS", "FFMA", "LDS",
               "LDGSTS")


# the fp32 kernels and their entry points that report warps resident per SM
# (a checkout from before the general fp32 kernels lacks that pair)
F32_KERNELS = {"flash_fwd_f32_kernel": "gpt2vl_flash_fwd_f32_warps_per_sm",
               "flash_bwd_f32_kernel": "gpt2vl_flash_bwd_f32_warps_per_sm",
               "rowdot_f32_kernel": None,
               "flash_general_fwd_f32_kernel": "gpt2vl_flash_general_fwd_f32_warps_per_sm",
               "flash_general_bwd_f32_kernel": "gpt2vl_flash_general_bwd_f32_warps_per_sm",
               "flash_lse_fwd_f32_kernel": "gpt2vl_flash_lse_fwd_f32_warps_per_sm",
               "flash_lse_merge_f32_kernel": None,
               "flash_dt_fwd_f32_kernel": "gpt2vl_flash_dt_fwd_f32_warps_per_sm",
               "flash_dt_merge_f32_kernel": None,
               "flash_dt_bwd_f32_kernel": "gpt2vl_flash_dt_bwd_f32_warps_per_sm"}
# the SASS instruction counts of the fp32 self-attention pair when its blocks
# were its own, before the general fp32 kernels shared them (cuobjdump -sass
# of the sm_90a build): the counts printed beside this build's
F32_PAIR_SASS_OWN = {"flash_fwd_f32_kernel": 6488, "flash_bwd_f32_kernel": 7216,
                      "rowdot_f32_kernel": 352}
# the SASS instruction counts of every kernel before the fp32 dt kernels
# joined the fp32 blocks as their third case (cuobjdump -sass of the sm_90a
# build on the H100's machine), but the fp32 general backward's, which is its
# one-pass block's since that block replaced its dk/dv and dq blocks (7336
# before), and the counts of the kernels redesigned since: the fp32 dt
# backward as the one-pass block's DT case (6912 before), the split fp32 lse
# forward and its merge: a refactor of the shared blocks must leave the other
# kernels' code as it was, which --flash-times holds them to
SASS_BEFORE_DT_F32 = {"adamw_kernel": 1976, "ce_fwd_combine_kernel": 376, "ce_fwd_partial_kernel": 1632,
             "flash_bwd_kernel": 3136, "flash_bwd_f32_kernel": 7288, "rowdot_f32_kernel": 352,
             "flash_general_dkv_kernel": 1600, "flash_general_dq_kernel": 2512,
             "flash_dt_bwd_kernel": 3720, "flash_dt_fwd_kernel": 2464,
             "flash_fused_dq_cast_kernel": 48, "flash_fused_bwd_kernel": 1952,
             "flash_fwd_kernel": 2136, "flash_fwd_f32_kernel": 6512, "flash_rowdot_kernel": 272,
             "flash_general_bwd_f32_kernel": 5280, "flash_general_fwd_kernel": 2168,
             "flash_general_fwd_f32_kernel": 6536, "flash_lse_fwd_kernel": 2144,
             "flash_dt_bwd_f32_kernel": 4568, "flash_lse_fwd_f32_kernel": 6960,
             "flash_lse_merge_f32_kernel": 800}


def f32_pair_report(so, lib):
    """{kernel: registers, spill bytes (ptxas -v), SASS instructions, counts of
    F32_OPCODES} for the fp32 kernels (F32_KERNELS) the library holds, and
    the warps each keeps resident on an SM (the occupancy calculator, through
    the library's entry points where the checkout has them)."""
    names = tuple(F32_KERNELS)
    report = {}
    log = so.with_suffix(".log").read_text()
    for part in log.split("Compiling entry function '")[1:]:
        name = kernel_name(part.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if name in names and regs:
            report[name] = {"registers": int(regs.group(1)),
                            "spill_bytes": sum(map(int, spill.groups())) if spill else None}
    for name, lines in _sass_functions(so):
        if name in names:
            ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?", "", ln).split(" ")[0]
                   .split(".")[0] for ln in lines]
            report.setdefault(name, {}).update(
                sass=len(lines), opcodes={op: ops.count(op) for op in F32_OPCODES})
    for name, entry in F32_KERNELS.items():
        fn = getattr(lib, entry, None) if entry else None
        if name in report:
            report[name]["warps_per_sm"] = fn() if fn is not None else None
    return report


def f32_general_times(torch, fa, dev, g, out):
    """The fp32 general and lse kernels (where the checkout has them) into
    ``out``: K2b's function (flash_general_forward_f32), the fp32 D and the
    fp32 general backward (K3a's and K3b's functions in one launch) at B=1,
    T=16384, H=12 causal on fp32 views of one fused projection, K2a's and
    K3c's (flash_lse_forward_f32, flash_fused_backward_f32, on D - dlse) on
    the ring's chunk pair (B=1, Tq=Tk=4096) unmasked and causal; SDPA's
    forward and whole backward on the same fp32 operands beside each (Tq ==
    Tk in all, so SDPA's top-left causal mask is the same mask); each one's
    bound at 67 TFLOP/s of fp32 FFMAs or 3.35 TB/s."""
    import torch.nn.functional as F

    def sdpa(q, k, v, do, causal, key):
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        out[f"sdpa_f32fwd_{key}_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 5)
        leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        dot = do.transpose(1, 2)
        out[f"sdpa_f32bwd_{key}_ms"] = cuda_ms(
            lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True), 3)

    bound = lambda kind, *shape: attention_bound(  # noqa: E731
        kind, *shape, elem_bytes=4, peak=PEAK_FP32_FLOPS)[0]
    q, k, v, do = qkv_inputs(torch, 1, 16384, 16384, 12, dev, g, dtype=torch.float32)
    out["f32_k2b_T16384_causal_ms"] = cuda_ms(
        lambda: fa.flash_general_forward_f32(q, k, v, causal=True), 5)
    o, lse = fa.flash_general_forward_f32(q, k, v, causal=True)
    out["f32_rowdot_T16384_ms"] = cuda_ms(lambda: fa.flash_rowdot(do, o), 20)
    dd = fa.flash_rowdot(do, o)
    out["f32_k3ab_T16384_causal_ms"] = cuda_ms(
        lambda: fa.flash_general_backward_f32(q, k, v, do, lse, dd, causal=True), 3)
    sdpa(q, k, v, do, True, "T16384_causal")
    long_shape = (1, 16384, 16384, 12, 64, True)
    out["f32_bounds_ms"] = {"k2b_T16384": bound("fwd", *long_shape),
                            "k3ab_T16384": bound("fused_bwd", *long_shape)}
    del q, k, v, do, o, lse, dd
    for causal in (False, True):
        key = "causal" if causal else "nomask"
        q, k, v, do, dlse = chunk_views(torch, 1, 4096, 4096, 12, dev, g, dtype=torch.float32)
        out[f"f32_k2a_pair_{key}_ms"] = cuda_ms(
            lambda: fa.flash_lse_forward_f32(q, k, v, causal=causal), 20)
        o, lse = fa.flash_lse_forward_f32(q, k, v, causal=causal)
        dcap = (fa.flash_rowdot(do, o) - dlse).contiguous()
        out[f"f32_k3c_pair_{key}_ms"] = cuda_ms(
            lambda: fa.flash_fused_backward_f32(q, k, v, do, lse, dcap, causal=causal), 10)
        sdpa(q, k, v, do, causal, f"pair_{key}")
        pair = (1, 4096, 4096, 12, 64, causal)
        out["f32_bounds_ms"].update({f"k2a_pair_{key}": bound("fwd", *pair),
                                     f"k3c_pair_{key}": bound("fused_bwd", *pair)})
        del q, k, v, do, dlse, o, lse, dcap


def dt_f32_times(torch, fa, ab, dev, g, out):
    """P1 fp32 and P2 fp32 (csrc/flash_dt_fwd_f32.cu, flash_dt_bwd_f32.cu) at
    the A/B tool's B=8, T=1024 and at B=1, T=8192, H=12 causal, into
    ``out``: beside them, on the same values, the fp32 K1 pair through
    flash_attention (its (B, T, H, hs) views of one fused fp32 projection,
    the side A of ``ab_dt_flash --dtype fp32``; its backward includes its D)
    and SDPA's forward and whole backward on the fp32 operands (a yardstick
    the package never calls); each one's bound at 67 TFLOP/s of fp32 FFMAs."""
    import torch.nn.functional as F

    hs = 64
    out["dt_f32_bounds_ms"] = {}
    for b, t in ((8, 1024), (1, 8192)):
        q, k, v, do = qkv_inputs(torch, b, t, t, 12, dev, g, dtype=torch.float32)
        qd, kd, vd, dod = ab.to_dt(q * hs ** -0.5), ab.to_dt(k), ab.to_dt(v), ab.to_dt(do)
        key, iters = f"B{b}_T{t}_causal", (20, 10) if t == 1024 else (5, 3)
        out[f"p1f32_{key}_ms"] = cuda_ms(
            lambda: ab.flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True), iters[0])
        if hasattr(ab, "dt_f32_parts"):  # P1 fp32 split over its key range
            out[f"p1f32_{key}_parts"] = ab.dt_f32_parts(b * 12, t, t, True,
                                                        ab._dt_f32_slots(dev.index))
        out[f"k1fwd_f32_same_inputs_{key}_ms"] = cuda_ms(
            lambda: fa.flash_attention(q, k, v, causal=True), iters[0])
        o, lse = ab.flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True)
        dcap = ab.dcap_dt(o, dod)
        out[f"p2f32_{key}_ms"] = cuda_ms(
            lambda: ab.flash_bwd_dt_b(qd, kd, vd, dod, lse, dcap, b, t, t, causal=True,
                                      dq_scale=hs ** -0.5), iters[1])
        o1, lse1 = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        out[f"k1bwd_f32_same_inputs_{key}_ms"] = cuda_ms(
            lambda: fa.flash_attention_backward(q, k, v, o1, lse1, do, causal=True), iters[1])
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        out[f"sdpa_f32fwd_dt_{key}_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), iters[0])
        leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
        sdpa_o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        dot = do.transpose(1, 2)
        out[f"sdpa_f32bwd_dt_{key}_ms"] = cuda_ms(
            lambda: torch.autograd.grad(sdpa_o, leaves, dot, retain_graph=True), iters[1])
        out["dt_f32_bounds_ms"].update({
            f"p1f32_{key}": attention_bound("fwd", b, t, t, 12, hs, True, elem_bytes=4,
                                            peak=PEAK_FP32_FLOPS)[0],
            f"p2f32_{key}": attention_bound("fused_bwd", b, t, t, 12, hs, True, elem_bytes=4,
                                            peak=PEAK_FP32_FLOPS)[0]})
        del q, k, v, do, qd, kd, vd, dod, o, lse, dcap, o1, lse1, qt, kt, vt, leaves, sdpa_o, dot
        torch.cuda.empty_cache()
    dt_f32_split_times(torch, fa, ab, dev, g, out)


# (B, H, Tq, Tk, causal) of P1 fp32's parts A/B: phase 19b's shapes, the
# A/B tool's --check shape and its timed B=8, T=1024
DT_F32_SPLIT_SHAPES = ((2, 12, 1024, 1024, True), (3, 12, 1088, 1088, True),
                       (2, 12, 512, 1024, True), (2, 12, 1024, 1024, False),
                       (2, 12, 1024, 512, True), (2, 12, 2048, 1024, True),
                       (2, 3, 1024, 1024, True), (8, 12, 1024, 1024, True),
                       (1, 12, 8192, 8192, True))


def dt_f32_split_times(torch, fa, ab, dev, g, out):
    """P1 fp32 at each of DT_F32_SPLIT_SHAPES through its wrapper as the
    checkout has it, into ``out["p1f32_split_ms"]``; where the checkout
    splits P1 (``ab.dt_f32_parts``), also ``out["p1f32_parts_ab"]``: at each
    shape the rule's pick, the part count that read fastest, and for each
    count from 1 to 8 the rule's cost (``ab.dt_f32_cost``), the list-schedule
    balance and two times with the parts forced (the module's rule replaced
    for the call), in the order 1, 2, ..., 8, 8, ..., 1, each forced o held
    to the unforced o's rows within F32_ROW_TOL."""
    split = hasattr(ab, "dt_f32_parts")
    out["p1f32_split_ms"], ab_out = {}, {}
    for b, h, tq, tk, causal in DT_F32_SPLIT_SHAPES:
        key = f"B{b}_H{h}_Tq{tq}_Tk{tk}_{'causal' if causal else 'nomask'}"
        qd, kd, vd, _ = dt_f32_inputs(torch, ab, b, tq, tk, h, dev, g)
        # about 10 ms a reading: 0.42 ms at B=8, H=12, T=1024 (96 units)
        iters = max(3, min(50, int(2300 / (b * h * tq * tk / 1024 ** 2))))
        run = lambda: ab.flash_fwd_dt_b(qd, kd, vd, b, tq, tk, causal=causal)  # noqa: E731
        out["p1f32_split_ms"][key] = cuda_ms(run, iters)
        if split:
            rule = ab.dt_f32_parts
            pick = rule(b * h, tq, tk, causal, ab._dt_f32_slots(dev.index))
            alts = list(range(1, 9))
            o_ref = ab.from_dt(run()[0], b, tq)
            times = {p: [] for p in alts}
            try:
                for p in alts + alts[::-1]:
                    ab.dt_f32_parts = lambda *a, p=p: p
                    times[p].append(cuda_ms(run, iters))
                    err = f32_fwd_row_err(ab.from_dt(run()[0], b, tq), o_ref)
                    require(err <= F32_ROW_TOL, f"P1 fp32 with {p} parts at {key}: row err {err}")
            finally:
                ab.dt_f32_parts = rule
            visible = ab.dt_f32_visible_tiles(tq, tk, causal)
            slots = ab._dt_f32_slots(dev.index)
            ab_out[key] = {"pick": pick, "fastest": min(times, key=lambda p: sum(times[p])),
                           "ms_by_parts": {str(p): t for p, t in times.items()},
                           "cost_by_parts": {str(p): ab.dt_f32_cost(b * h, tq, tk, causal,
                                                                    slots, p) for p in alts},
                           "balance_by_parts": {str(p): fa.split_balance(
                               b * h, visible, slots, p) for p in alts}}
            print(f"  P1 fp32 parts A/B at {key}: the rule takes {pick}, fastest "
                  f"{ab_out[key]['fastest']}; ms by parts "
                  + ", ".join(f"{p}: {min(t):.4f}" for p, t in times.items()), flush=True)
        del qd, kd, vd
        torch.cuda.empty_cache()
    if split:
        out["p1f32_parts_ab"] = ab_out


def flash_times(torch, fa, fc, ab, dev, so, build_s, card, lib):
    """K1-fwd at B=8, T=1024 and B=2, T=4096 causal and at the fine-tune's
    B=128, T=65 (q, k, v views of one fused projection), and at B=8, T=1024
    the host time of a launch beside the kernel's device time; K1-bwd at
    B=8, T=1024 and B=1, T=8192 causal on K1-fwd's o and lse; P1 at the A/B
    tool's B=8, T=1024 causal (its own inputs, dt layout); K2b, K3a and
    K3b at B=1, T=16384, H=12 causal (K3a's and K3b's lse from K2b, their D
    from the D pre-kernel); the fp32 pair through the same wrappers on fp32
    q/k/v views of one fused projection, the forward at B=32, T=1024 and
    B=1, T=8192, the backward (D and dq, dk, dv) at B=8, T=1024 and B=1,
    T=8192 on the fp32 forward's o and lse, all causal, and SDPA's forward
    at B=32 and whole backward at B=8 on the same fp32 operands (yardsticks
    that the package never calls), with the registers, spills, warps
    resident per SM and SASS opcodes of every fp32 kernel
    (``f32_pair_report``); the fp32 general and lse kernels where the
    checkout has them (``f32_general_times``); the fp32 dt kernels where the
    checkout has them (``dt_f32_times``); K2a, K2b and K3c on one ring chunk pair, B=1,
    Tq=Tk=4096, H=12, unmasked and causal (chunk views; lse and dcap from the
    plain forward); P2 at B=8, T=1024 and B=1, T=8192 causal (dt inputs, lse
    and dcap from the plain forward); K4 at N=8192 and 4096, D=768,
    V=50304, and the logits GEMM alone (``torch.mm`` in bf16, a yardstick
    called by nothing in the package) at N=8192: each the mean device time
    of 20 launches after a warm-up (10 for K3a and K3b, 50 for K1-fwd and
    P1; ``cuda_ms``); and one micro-batch of 124M's scoring forward (B=8,
    T=1024) by kernel class under torch.profiler; in one JSON line
    with the build time, the SASS instruction count of every kernel, those
    that moved from SASS_BEFORE_DT_F32 (the run fails, after its line, if any did)
    and the card. It calls only wrappers that earlier checkouts of the port
    have too, so copied into one it times that checkout's kernels."""
    g = torch.Generator(dev).manual_seed(0)
    out = {"build_s": build_s, "sass": sass_counts(so)}
    # every kernel that was there before the fp32 dt kernels keeps its code
    out["sass_moved"] = {n: [out["sass"].get(n), w] for n, w in SASS_BEFORE_DT_F32.items()
                                      if out["sass"].get(n) != w}
    for b, t in ((8, 1024), (2, 4096), (128, 65)):
        q, k, v, _ = qkv_inputs(torch, b, t, t, 12, dev, g)
        out[f"k1fwd_B{b}_T{t}_causal_ms"] = cuda_ms(
            lambda: fa.flash_attention(q, k, v, causal=True), 50)
        if t == 1024:
            enq, wall = host_us(torch, lambda: fa.flash_attention(q, k, v, causal=True), 200)
            out["k1fwd_B8_T1024_host_us"] = {
                "flash_attention_enqueue": enq, "flash_attention_wall": wall,
                "kernel_device": out["k1fwd_B8_T1024_causal_ms"] * 1e3}
    for b, t in ((8, 1024), (1, 8192)):
        q, k, v, do = qkv_inputs(torch, b, t, t, 12, dev, g)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        out[f"k1bwd_B{b}_T{t}_causal_ms"] = cuda_ms(
            lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True), 20)
    # the fp32 pair (flash_fwd_f32.cu, flash_bwd_f32.cu) through the routing
    # wrappers, SDPA on the same fp32 operands beside it (main turned TF32 off)
    import torch.nn.functional as F

    out["f32_pair"] = f32_pair_report(so, lib)
    for b, t in ((32, 1024), (1, 8192), (8, 1024)):
        qkv = torch.randn(b, t, 3 * 768, device=dev, generator=g)
        q, k, v = (a.view(b, t, 12, 64) for a in qkv.split(768, dim=-1))
        if b != 8:
            out[f"f32fwd_B{b}_T{t}_causal_ms"] = cuda_ms(
                lambda: fa.flash_attention(q, k, v, causal=True), 20)
        if b == 32:
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            out["sdpa_f32fwd_B32_T1024_causal_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
            del qkv, q, k, v, qt, kt, vt
            continue
        do = torch.randn(b, t, 12, 64, device=dev, generator=g)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        out[f"f32bwd_B{b}_T{t}_causal_ms"] = cuda_ms(
            lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True), 10)
        if b == 8:
            leaves = [a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v)]
            sdpa_o = F.scaled_dot_product_attention(*leaves, is_causal=True)
            dot = do.transpose(1, 2)
            out["sdpa_f32bwd_B8_T1024_causal_ms"] = cuda_ms(
                lambda: torch.autograd.grad(sdpa_o, leaves, dot, retain_graph=True), 10)
            del leaves, sdpa_o
        del qkv, q, k, v, do, o, lse
    (qd, kd, vd, _), _, (b, h, t, hs) = dt_inputs(torch, ab, dev, 19)
    out["p1_B8_T1024_causal_ms"] = cuda_ms(
        lambda: ab.flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True), 50)
    q, k, v, do = qkv_inputs(torch, 1, 16384, 16384, 12, dev, g)
    out["k2b_T16384_causal_ms"] = cuda_ms(
        lambda: fa.flash_general_forward(q, k, v, causal=True), 20)
    o, lse = fa.flash_general_forward(q, k, v, causal=True)
    dd = fa.flash_rowdot(do, o)
    out["k3a_T16384_causal_ms"] = cuda_ms(
        lambda: fa.flash_general_dq(q, k, v, do, lse, dd, causal=True), 10)
    out["k3b_T16384_causal_ms"] = cuda_ms(
        lambda: fa.flash_general_dkv(q, k, v, do, lse, dd, causal=True), 10)
    for causal in (False, True):
        q, k, v, do, _ = chunk_views(torch, 1, 4096, 4096, 12, dev, g)
        o, lse = fa.flash_attention_with_lse_reference(q, k, v, causal=causal)
        dcap = fa.rowdot_reference(do, o).contiguous()
        key = "causal" if causal else "nomask"
        out[f"k2a_pair_{key}_ms"] = cuda_ms(
            lambda: fa.flash_lse_forward(q, k, v, causal=causal), 20)
        out[f"k2b_pair_{key}_ms"] = cuda_ms(
            lambda: fa.flash_general_forward(q, k, v, causal=causal), 20)
        out[f"k3c_pair_{key}_ms"] = cuda_ms(
            lambda: fa.flash_fused_backward(q, k, v, do, lse, dcap, causal=causal), 20)
    if hasattr(fa, "flash_general_forward_f32"):
        f32_general_times(torch, fa, dev, g, out)
    if hasattr(ab.flash_fwd_dt_b, "launches_f32"):
        dt_f32_times(torch, fa, ab, dev, g, out)
        # P1 fp32's launches in this run, and those that ran its merge
        out["p1f32_launches"] = {"flash_dt_fwd_f32": ab.flash_fwd_dt_b.launches_f32,
                                 "merge": getattr(ab.flash_fwd_dt_b, "launches_f32_merge",
                                                  None)}
    # P2 at the tool's B=8, T=1024 and at B=1, T=8192, causal, dt inputs;
    # lse and dcap from the plain forward
    (qd, kd, vd, dod), _, (b, h, t, hs) = dt_inputs(torch, ab, dev, 19)
    for b, t in ((8, 1024), (1, 8192)):
        if b == 1:
            qd, kd, vd, dod = (ab.to_dt(torch.randn(1, t, h, hs, device=dev, generator=g)
                                        .to(torch.bfloat16)) for _ in range(4))
            qd = (qd.float() * hs ** -0.5).to(torch.bfloat16)
        o, lse = dt_fwd_by_heads(torch, ab, qd, kd, vd, b, t, t)
        dcap = ab.dcap_dt(o, dod)
        out[f"p2_B{b}_T{t}_causal_ms"] = cuda_ms(
            lambda: ab.flash_bwd_dt_b(qd, kd, vd, dod, lse, dcap, b, t, t, causal=True,
                                      dq_scale=hs ** -0.5), 20)
        del o, lse, dcap
    # K4 at the validation micro-batch of 124M and at the fine-tune's N=4096,
    # and, as a yardstick only, the logits GEMM alone (bf16 logits)
    w = (torch.randn(50304, 768, device=dev, generator=g) * 0.02).to(torch.bfloat16)
    for n in (8192, 4096):
        x = torch.randn(n, 768, device=dev, generator=g).to(torch.bfloat16)
        tg = torch.randint(0, 50304, (n,), device=dev, generator=g, dtype=torch.int32)
        out[f"k4_N{n}_ms"] = cuda_ms(lambda: fc.ce_forward(x, w, tg), 20)
        if n == 8192:
            out["logits_gemm_N8192_ms"] = cuda_ms(lambda: torch.mm(x, w.t()), 20)
    del w, x
    # the scoring forward of 124M (seeded random weights), one micro-batch of
    # B=8, T=1024: device time by kernel class
    from gpt2_vision_language_tpu_torch.core.config import GPTConfig
    from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY
    from gpt2_vision_language_tpu_torch.models import gpt2
    from gpt2_vision_language_tpu_torch.train.step import make_eval_step

    cfg = GPTConfig()
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 8, 1025), device=dev, generator=g)
    one = {"idx": toks[..., :-1], "targets": toks[..., 1:]}
    step = make_eval_step(lambda m, mb: gpt2.loss(m, mb["idx"], cfg, targets=mb["targets"],
                                                  policy=DEFAULT_POLICY))
    ms, by_class, _ = profiled_kernel_ms(torch, lambda: step(model, one))
    out["scoring_micro_batch_device_ms"] = {"total": ms, **by_class}
    out["card"] = card
    print(json.dumps(out), flush=True)
    require(not out["sass_moved"], "a kernel's SASS instruction count moved from "
            f"SASS_BEFORE_DT_F32: {out['sass_moved']}")


T_START = time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import numpy as np

    from gpt2_vision_language_tpu_torch import _build
    from gpt2_vision_language_tpu_torch.cli import bench_decode, pretrain, sample
    from gpt2_vision_language_tpu_torch.core.config import (
        GPTConfig, OptimizerConfig, ScheduleConfig,
    )
    from gpt2_vision_language_tpu_torch.core.precision import (
        DEFAULT_POLICY, FP32_POLICY,
    )
    from gpt2_vision_language_tpu_torch.models import gpt2
    from gpt2_vision_language_tpu_torch.ops import attention, layers
    from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
    from gpt2_vision_language_tpu_torch.ops import fused_adamw as fw
    from gpt2_vision_language_tpu_torch.ops import fused_ce as fc
    from gpt2_vision_language_tpu_torch.ops import ring_attention as ra
    from gpt2_vision_language_tpu_torch.train import schedule
    from gpt2_vision_language_tpu_torch.train.optimizer import (
        adamw_init, adamw_update, global_norm, kernel_leaves,
    )
    from gpt2_vision_language_tpu_torch.train.step import make_eval_step, make_train_step
    from gpt2_vision_language_tpu_torch.tools import ab_dt_flash as ab
    from gpt2_vision_language_tpu_torch.cli import (
        finetune_linear, finetune_qformer, finetune_xattn,
    )
    from gpt2_vision_language_tpu_torch.core import config as port_config
    from gpt2_vision_language_tpu_torch.data import coco
    from gpt2_vision_language_tpu_torch.data.tokenizer import get_tokenizer
    from gpt2_vision_language_tpu_torch.eval.caption_eval import evaluate_captions
    from gpt2_vision_language_tpu_torch.models import bridges
    from gpt2_vision_language_tpu_torch.ops import pooling
    from gpt2_vision_language_tpu_torch.train import finetune
    from gpt2_vision_language_tpu_torch.infer import sampling

    print("[1] build", flush=True)
    so, build_s = _build.build()
    lib = _build.load()
    if sys.argv[1:] == ["--flash-times"]:
        flash_times(torch, fa, fc, ab, dev, so, build_s, card, lib)
        return 0
    print(f"  {so.name}: nvcc {build_s:.2f} s", flush=True)
    # registers and spills of every kernel, from the compiler's report
    report = so.with_suffix(".log").read_text()
    for mangled, regs in re.findall(
            r"Compiling entry function '(\S+)' for 'sm_90a'.*?Used (\d+) registers",
            report, flags=re.S):
        print(f"    {kernel_name(mangled)}: {regs} registers", flush=True)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", report)]
    print(f"    spill stores: {sum(spills)} bytes over {len(spills)} functions", flush=True)
    sass = sass_counts(so)
    print(f"    SASS instructions: {json.dumps(sass)}", flush=True)
    f32_report = f32_pair_report(so, lib)
    print(f"    the fp32 kernels: {json.dumps(f32_report)}", flush=True)
    print("    SASS instructions of the fp32 pair, this build (its blocks' own build): "
          + ", ".join(f"{n} {f32_report[n]['sass']} ({w})" for n, w in F32_PAIR_SASS_OWN.items()),
          flush=True)
    print("    SASS instructions, this build (before the fp32 dt kernels): " + ", ".join(
        f"{n} {sass.get(n)} ({w})" for n, w in SASS_BEFORE_DT_F32.items()), flush=True)
    for name in ("flash_fwd_f32_kernel", "flash_bwd_f32_kernel", "flash_general_fwd_f32_kernel",
                 "flash_general_bwd_f32_kernel", "flash_lse_fwd_f32_kernel",
                 "flash_lse_merge_f32_kernel", "flash_dt_fwd_f32_kernel",
                 "flash_dt_merge_f32_kernel", "flash_dt_bwd_f32_kernel"):
        ops = f32_report[name]["opcodes"]
        require(ops["HMMA"] + ops["HGMMA"] == 0, f"{name} has tensor-core products")
        require(f32_report[name]["spill_bytes"] == 0, f"{name} spills")
    for name in ("flash_bwd_f32_kernel", "flash_general_bwd_f32_kernel",
                 "flash_dt_bwd_f32_kernel"):
        require(sum(f32_report[name]["opcodes"][op]
                    for op in ("RED", "REDG", "REDS", "ATOM", "ATOMG", "ATOMS")) == 0,
                f"{name} has atomics")

    flash_errs, flash_t = phase_flash(torch, fa, dev)
    f32_errs, f32_t = phase_flash_f32(torch, fa, dev)
    torch.cuda.empty_cache()
    f32b_errs, f32b_t = phase_flash_bwd_f32(torch, fa, dev)
    torch.cuda.empty_cache()
    ce_errs, ce_t = phase_ce(torch, fc, dev)
    ce_bwd_errs, ce_bwd_t = phase_ce_bwd(torch, fc, dev)

    print("[4] scoring forward: GPT-2 124M, bf16 policy, 2 x (B=8, T=1024)", flush=True)
    cfg = GPTConfig()
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8, 1025))
    toks = torch.from_numpy(toks).to(dev)
    batch = {"idx": toks[..., :-1], "targets": toks[..., 1:]}

    def make(attn_impl, ce_impl):
        return make_eval_step(lambda m, mb: gpt2.loss(
            m, mb["idx"], cfg, targets=mb["targets"], policy=DEFAULT_POLICY,
            attn_impl=attn_impl, ce_impl=ce_impl,
        ))

    eval_step, eval_plain = make("auto", "auto"), make("xla", "xla")
    eval_step(model, batch)  # warm-up
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    fc.ce_forward.launches = 0
    t0 = time.perf_counter()
    loss = eval_step(model, batch).item()
    dt = time.perf_counter() - t0
    launches = {"flash": fa.flash_attention.launches, "ce": fc.ce_forward.launches}
    n_tok = batch["idx"].numel()
    print(f"  loss {loss:.6f} (ln V = {math.log(cfg.padded_vocab_size):.4f}); "
          f"{n_tok / dt:.1f} tokens/s ({dt * 1e3:.1f} ms); launches {launches}",
          flush=True)
    require(math.isfinite(loss), "scoring loss is not finite")
    require(abs(loss - math.log(cfg.padded_vocab_size)) < 0.5,
            "scoring loss is not near ln(V) for random weights")
    require(launches == {"flash": 2 * cfg.n_layer, "ce": 2},
            f"expected 12 flash and 1 CE launch per micro-batch, got {launches}")
    eval_plain(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_plain = eval_plain(model, batch).item()
    dt_plain = time.perf_counter() - t0
    print(f"  plain paths (attn 'xla', CE 'xla'): loss {loss_plain:.6f}, "
          f"{n_tok / dt_plain:.1f} tokens/s; |diff| {abs(loss - loss_plain):.3e} "
          f"(tol 1e-2)", flush=True)
    require(abs(loss - loss_plain) <= 1e-2, "kernel and plain scoring losses disagree")
    require(fa.flash_attention.launches == launches["flash"]
            and fc.ce_forward.launches == launches["ce"],
            "the plain-path run launched a kernel")
    one = {k_: v_[:1] for k_, v_ in batch.items()}
    score_ms, score_split, _ = profiled_kernel_ms(torch, lambda: eval_step(model, one))
    print(f"  one micro-batch (B=8, T=1024), torch.profiler, kernels only: {score_ms:.4f} ms "
          f"of device time {json.dumps(score_split)}", flush=True)

    print("[5] generation", flush=True)
    out = sample.main(["--num", "4", "--length", "32"])
    require(out.shape[0] == 4 and int(out.min()) >= 0
            and int(out.max()) < cfg.padded_vocab_size, "sampled ids out of range")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))).to(dev)
    with torch.no_grad():
        cache = gpt2.init_cache(cfg, 2, 16, torch.float32, device=dev)
        emb = gpt2.embed_tokens(model, ids, cfg)
        gpt2.forward_cached(model, emb[:, :15], cfg, cache, 0, policy=FP32_POLICY)
        cached, _ = gpt2.forward_cached(model, emb[:, 15:], cfg, cache, 15,
                                        policy=FP32_POLICY)
        full, _ = gpt2.apply(model, ids, cfg, policy=FP32_POLICY)
    e = (cached[:, -1] - full[:, -1]).abs().max().item()
    print(f"  cached vs uncached next-token logits (fp32): max|err| {e:.3e} (tol 1e-3)",
          flush=True)
    require(e <= 1e-3, "cached and uncached logits disagree")
    decode_b50 = bench_decode.main(["--batch", "50", "--new", "24", "--iters", "3"])
    require(decode_b50["value"] > 0 and decode_b50["batch"] == 50, "bench_decode failed")
    phase_matmul_f32(torch, layers, dev)
    del model

    cfgs = {"gpt": cfg, "opt": OptimizerConfig(), "sched": ScheduleConfig()}
    mods = {"fa": fa, "fc": fc, "fw": fw, "ra": ra, "policy": DEFAULT_POLICY,
            "make_train_step": make_train_step, "adamw_init": adamw_init,
            "adamw_update": adamw_update, "global_norm": global_norm, "pretrain": pretrain,
            "attention": attention, "fp32_policy": FP32_POLICY, "kernel_leaves": kernel_leaves}
    bwd_errs, bwd_t = phase_flash_bwd(torch, fa, attention, dev)
    adamw_err, adamw_t, adamw_kernel_ms = phase_adamw(torch, gpt2, fw, schedule, cfgs, dev)
    train = phase_train_step(torch, np, gpt2, mods, cfgs, dev)
    torch.cuda.empty_cache()
    trainer_counts, _ = phase_trainer(torch, mods, cfgs)
    profiler = phase_profiler(torch, mods)

    gen_errs, gen_t = phase_general(torch, fa, dev)
    torch.cuda.empty_cache()
    families = phase_general_vs_self(torch, fa, dev)
    library = phase_library_probes(torch, gpt2, cfgs, dev)
    torch.cuda.empty_cache()
    long_train = phase_long_train_step(torch, np, gpt2, mods, cfgs, dev)
    torch.cuda.empty_cache()
    long_counts, long_tps = phase_long_trainer(torch, np, mods, cfgs)
    torch.cuda.empty_cache()

    lse_errs, lse_t = phase_lse(torch, fa, dev)
    torch.cuda.empty_cache()
    ring_op = phase_ring_op(torch, mods, attention, dev)
    torch.cuda.empty_cache()
    ring_train = phase_ring_train_step(torch, np, gpt2, mods, cfgs, dev, long_train)
    torch.cuda.empty_cache()
    ring_counts, ring_tps = phase_ring_trainer(torch, mods, cfgs)
    torch.cuda.empty_cache()

    t_slice = time.perf_counter()
    gen32_errs, gen32_t = phase_general_f32(torch, fa, dev)
    lse32_errs, lse32_t = phase_lse_f32(torch, fa, dev)
    long32 = phase_fp32_long_train_step(torch, np, gpt2, mods, cfgs, dev)
    ring32 = phase_fp32_ring_train_step(torch, np, gpt2, mods, cfgs, dev, long32)
    trainers32 = phase_fp32_trainers(torch, mods, cfgs)
    fp32_long_s = time.perf_counter() - t_slice

    dt_errs, dt_t = phase_dt_kernels(torch, ab, fa, dev)
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    dt32_errs, dt32_t = phase_dt_kernels_f32(torch, ab, dev)
    dt32_s = time.perf_counter() - t_slice
    dt_counts, dt_bench = phase_dt_tool(ab)
    k1_short = phase_k1_short(torch, fa, attention, dev)
    torch.cuda.empty_cache()
    ft = {"gpt2": gpt2, "bridges": bridges, "pooling": pooling, "policy": DEFAULT_POLICY, "fp32_policy": FP32_POLICY,
          "cli": {"linear": finetune_linear, "qformer": finetune_qformer,
                  "xattn": finetune_xattn},
          "presets": {"linear": port_config.finetune_linear_preset,
                      "qformer": port_config.finetune_qformer_preset,
                      "xattn": port_config.finetune_xattn_preset},
          "finetune": finetune, "coco": coco, "tokenizer": get_tokenizer(),
          "evaluate_captions": evaluate_captions}
    ft_ops = phase_finetune_ops(torch, np, ft, mods, dev)
    ft_counts, ft_runs, linear_ckpt = phase_finetune_clis(torch, ft, mods, dev)
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    sampler = phase_sampler(torch, np, gpt2, sampling, cfg, dev)
    decode = phase_decode(bench_decode, decode_b50, card)
    torch.cuda.empty_cache()
    quality = phase_eval_quality(torch, np, mods, ft, cfg, dev)
    slice_s = {"sampler_decode_eval_quality": time.perf_counter() - t_slice}
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    clip = phase_clip(torch, np, mods, dev)
    torch.cuda.empty_cache()
    clip_clis = phase_clip_clis(torch, np, mods, dev, ft["tokenizer"], linear_ckpt)
    slice_s["clip_and_entry_points"] = time.perf_counter() - t_slice
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    fp32_train = phase_fp32_train_step(torch, np, gpt2, mods, cfgs, dev)
    torch.cuda.empty_cache()
    k1_heads = phase_k1_heads(torch, fa, dev)
    torch.cuda.empty_cache()
    big = phase_big_model(torch, np, gpt2, mods, cfgs, dev)
    slice_s["fp32_step_heads_1558M"] = time.perf_counter() - t_slice
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    parallel, par_paths = phase_parallel(torch, np, cfgs, dev)
    slice_s["parallel_styles"] = time.perf_counter() - t_slice
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    pipeline, pipe_paths = phase_pipeline(torch, np, cfgs, dev)
    par_paths.update(pipe_paths)
    parallel["pipeline"] = pipeline
    slice_s["pipeline_and_int8_moments"] = time.perf_counter() - t_slice
    slice_s["fp32_long_context_and_ring"] = fp32_long_s

    by_path = {"scoring": {"flash_fwd": launches["flash"], "ce_fwd": launches["ce"]},
               "train_step": train["counts"], "trainer": trainer_counts,
               "long_train_step": long_train["counts"], "long_trainer": long_counts,
               "ring_train_step": ring_train["counts"], "ring_trainer": ring_counts,
               "ab_dt_flash": dt_counts,
               **{f"finetune_{kind}": c for kind, c in ft_counts.items()},
               **{f"eval_quality_{name}": quality[name]["launches"]
                  for name in ("reference_pt_bf16", "hf_dir_bf16", "reference_pt_fp32")},
               "fp32_train_step": fp32_train["counts"], "trainer_1558M": big["trainer"]["launches"],
               "fp32_long_train_step": long32["counts"], "fp32_ring_train_step": ring32["counts"],
               "fp32_long_trainer": trainers32["flash"]["counts"],
               "fp32_ring_trainer": trainers32["ring"]["counts"], **par_paths}
    csrc = "gpt2_vision_language_tpu_torch/csrc/"
    jfa = "gpt2_vision_language_tpu/ops/flash_attention.py"
    n_params = 124_475_904
    self_shape, long_shape = (8, 1024, 1024, 12, 64, True), (1, 16384, 16384, 12, 64, True)
    lib_self, lib_long = library["B8_T1024"], library["B1_T16384"]
    chunk_shape = (1, 4096, 4096, 12, 64, False)  # a ring hop onto an earlier chunk
    lib_chunk = library["B1_T4096_nomask"]
    # name, source, the TPU kernel it replaces, the path whose run gives `launches`,
    # max error, (kernel ms, plain ms), bound, the library call's ms
    table = [
        ("flash_fwd", "flash_fwd.cu", f"{jfa}:841", "trainer", flash_errs["o"], flash_t,
         attention_bound("fwd", *self_shape), lib_self["fwd"]),
        # K1-fwd's function on fp32 operands: the fp32 HellaSwag run of phase 26
        ("flash_fwd_f32", "flash_fwd_f32.cu", f"{jfa}:841", "eval_quality_reference_pt_fp32",
         f32_errs["o"], f32_t["f32"],
         attention_bound("fwd", 32, 1024, 1024, 12, 64, True, elem_bytes=4,
                         peak=PEAK_FP32_FLOPS), f32_t["sdpa_ms"]),
        ("flash_bwd", "flash_bwd.cu", f"{jfa}:887", "trainer", bwd_errs["max_rel"],
         bwd_t["B8_T1024"],
         attention_bound("bwd", *self_shape), lib_self["bwd"]),
        # K1-bwd's function on fp32 operands: the fp32 train step of phase 29
        ("flash_bwd_f32", "flash_bwd_f32.cu", f"{jfa}:887", "fp32_train_step",
         f32b_errs["max_rel"], f32b_t["f32"],
         attention_bound("bwd", *self_shape, elem_bytes=4, peak=PEAK_FP32_FLOPS),
         f32b_t["sdpa_ms"]),
        ("ce_fwd", "ce_fwd.cu", "gpt2_vision_language_tpu/ops/fused_ce.py:93", "trainer",
         ce_errs["max"], ce_t, bound_ms(2 * 8192 * 768 * 50304,
                                2 * (8192 * 768 + 50304 * 768) + 3 * 4 * 8192), None),
        # replaces no TPU kernel: the JAX backward of the fused CE is XLA
        ("ce_bwd", "ce_bwd.cu", "none (XLA: gpt2_vision_language_tpu/ops/fused_ce.py:331)",
         "trainer", ce_bwd_errs["max_rel"], ce_bwd_t,
         bound_ms(2 * 2048 * 768 * 50304,
                  2 * (2048 * 768 + 50304 * 768 + 2048 * 50304) + 3 * 4 * 2048), None),
        ("adamw", "adamw.cu", "gpt2_vision_language_tpu/ops/fused_adamw.py:36", "trainer",
         adamw_err, adamw_t, bound_ms(0, 7 * 4 * n_params), library["adamw_fused"]),
        ("flash_general_fwd", "flash_general_fwd.cu", f"{jfa}:221", "long_trainer",
         gen_errs["o"], gen_t["fwd"], attention_bound("fwd", *long_shape), lib_long["fwd"]),
        ("flash_general_dq", "flash_dq_bwd.cu", f"{jfa}:369", "long_trainer",
         gen_errs["dq"], gen_t["dq"], attention_bound("dq", *long_shape), None),
        ("flash_general_dkv", "flash_dkv_bwd.cu", f"{jfa}:509", "long_trainer",
         gen_errs["dkv"], gen_t["dkv"], attention_bound("dkv", *long_shape), None),
        # the D pre-kernel of the general backward: XLA code in the JAX package
        ("flash_rowdot", "flash_general_bwd.cu", f"{jfa}:573", "long_trainer",
         gen_errs["dd"], gen_t["rowdot"],
         bound_ms(2 * 16384 * 768, 2 * 2 * 16384 * 768 + 4 * 16384 * 12), None),
        ("flash_lse_fwd", "flash_lse_fwd.cu", f"{jfa}:197", "ring_trainer", lse_errs["o"],
         lse_t["nomask"]["fwd"], attention_bound("fwd", *chunk_shape), lib_chunk["fwd"]),
        ("flash_fused_bwd", "flash_fused_bwd.cu", f"{jfa}:396", "ring_trainer", lse_errs["bwd"],
         lse_t["nomask"]["bwd"], attention_bound("fused_bwd", *chunk_shape), lib_chunk["bwd"]),
        # the fp32 cases of the general and lse families (FFMAs, no TF32):
        # the fp32 trainer runs of phase 18b, --attn-impl flash and ring
        ("flash_general_fwd_f32", "flash_general_fwd_f32.cu", f"{jfa}:221", "fp32_long_trainer",
         gen32_errs["o"], gen32_t["fwd"],
         attention_bound("fwd", *long_shape, elem_bytes=4, peak=PEAK_FP32_FLOPS),
         gen32_t["sdpa_fwd_ms"]),
        # K3a's and K3b's functions in one launch (also :509, K3b)
        ("flash_general_bwd_f32", "flash_general_bwd_f32.cu", f"{jfa}:369", "fp32_long_trainer",
         gen32_errs["max_rel"], gen32_t["bwd"],
         attention_bound("fused_bwd", *long_shape, elem_bytes=4, peak=PEAK_FP32_FLOPS),
         gen32_t["sdpa_bwd_ms"]),
        ("flash_rowdot_f32", "flash_bwd_f32.cu", f"{jfa}:573", "fp32_long_trainer",
         gen32_errs["dd"], gen32_t["dd"],
         bound_ms(2 * 16384 * 768, 4 * 2 * 16384 * 768 + 4 * 16384 * 12, PEAK_FP32_FLOPS), None),
        ("flash_lse_fwd_f32", "flash_lse_fwd_f32.cu", f"{jfa}:197", "fp32_ring_trainer",
         lse32_errs["o"], lse32_t["nomask"]["fwd"],
         attention_bound("fwd", *chunk_shape, elem_bytes=4, peak=PEAK_FP32_FLOPS),
         lse32_t["nomask"]["sdpa_fwd_ms"]),
        ("flash_fused_bwd_f32", "flash_general_bwd_f32.cu", f"{jfa}:396", "fp32_ring_trainer",
         lse32_errs["max_rel"], lse32_t["nomask"]["bwd"],
         attention_bound("fused_bwd", *chunk_shape, elem_bytes=4, peak=PEAK_FP32_FLOPS),
         lse32_t["nomask"]["sdpa_bwd_ms"]),
        # the dt-layout pair: the A/B tool's own path (its main, phase 20)
        ("flash_dt_fwd", "flash_dt_fwd.cu", "tools/ab_dt_flash.py:48", "ab_dt_flash",
         dt_errs["o"], dt_t["fwd"], attention_bound("fwd", *self_shape), lib_self["fwd"]),
        ("flash_dt_bwd", "flash_dt_bwd.cu", "tools/ab_dt_flash.py:132", "ab_dt_flash",
         dt_errs["bwd"], dt_t["bwd"], attention_bound("fused_bwd", *self_shape),
         lib_self["bwd"]),
        # the dt-layout pair on fp32 operands (FFMAs, no TF32): the tool's
        # fp32 checks and benches in its main (phase 20)
        ("flash_dt_fwd_f32", "flash_dt_fwd_f32.cu", "tools/ab_dt_flash.py:48", "ab_dt_flash",
         dt32_errs["o"], dt32_t["fwd"],
         attention_bound("fwd", *self_shape, elem_bytes=4, peak=PEAK_FP32_FLOPS),
         dt32_t["sdpa_fwd_ms"]),
        ("flash_dt_bwd_f32", "flash_dt_bwd_f32.cu", "tools/ab_dt_flash.py:132", "ab_dt_flash",
         dt32_errs["max_rel"], dt32_t["bwd"],
         attention_bound("fused_bwd", *self_shape, elem_bytes=4, peak=PEAK_FP32_FLOPS),
         dt32_t["sdpa_bwd_ms"]),
    ]
    kernels = []
    for name, src, replaces, path, err, (ms, plain_ms), (b_ms, b_by), lib_ms in table:
        count = by_path[path][name]
        require(count > 0, f"{name} was not launched by the {path} run")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": count, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms,
            "launches_by_path": {p: c[name] for p, c in by_path.items() if name in c},
        })
    notes = {
        "flash_fwd": {"lse_max_abs_err": flash_errs["lse"], "row_err": flash_errs["o_row"],
                      "row_control_excess": flash_errs["o_control"],
                      "row_control_elementwise_excess": flash_errs["o_control_elementwise"],
                      "shape": "B=8 T=1024 H=12 causal",
                      "library_is": "F.scaled_dot_product_attention"},
        "flash_fwd_f32": {"lse_max_abs_err": f32_errs["lse"], "row_err": f32_errs["o_row"],
                          "row_control": f32_errs["o_control_row"],
                          "row_control_elementwise": f32_errs["o_control_elementwise"],
                          "row_control_diagonal": f32_errs["o_control_diagonal_row"],
                          "build": f32_report["flash_fwd_f32_kernel"],
                          "tol": {"o": F32_TOL, "lse": F32_TOL, "row": F32_ROW_TOL},
                          "bit_equal_twice": True, "shape": "B=32 T=1024 H=12 causal fp32",
                          "bound_peak": "67 TFLOP/s fp32 outside the tensor cores",
                          "bf16_flash_fwd_ms": f32_t["bf16_ms"],
                          "library_is": "F.scaled_dot_product_attention on fp32 operands"},
        "flash_bwd_f32": {"err_is": "max|err| / max|ref|", "row_err": f32b_errs["row"],
                          "row_controls": f32b_errs["controls"],
                          "build": f32_report["flash_bwd_f32_kernel"],
                          "tol": {"max_rel": F32_TOL, "row": F32_ROW_TOL},
                          "bit_equal_twice": True, "shape": "B=8 T=1024 H=12 causal fp32",
                          "bound_peak": "67 TFLOP/s fp32 outside the tensor cores",
                          "library_is": "autograd.grad of q, k and v through SDPA on fp32 "
                                        "operands"},
        "flash_bwd": {"err_is": "max|err| / max|ref|", "dq_row_err": bwd_errs["dq_row"],
                      "dkv_row_err": bwd_errs["dkv_row"], "bit_equal_twice": True,
                      "dkv_row_control_excess": bwd_errs["dkv_control"],
                      "dkv_row_control_max_rel": bwd_errs["dkv_control_max_rel"],
                      "dq_row_control_excess": bwd_errs["dq_control"],
                      "dq_row_control_max_rel": bwd_errs["dq_control_max_rel"],
                      "shape": "B=8 T=1024 H=12 causal",
                      "B1_T8192": {
                          "ms": bwd_t["B1_T8192"][0], "plain_ms": bwd_t["B1_T8192"][1],
                          "bound_ms": attention_bound("bwd", 1, 8192, 8192, 12, 64, True)[0],
                          "library_ms": library["B1_T8192"]["bwd"]},
                      "library_is": "autograd.grad of q, k and v through SDPA"},
        "ce_fwd": {"shape": "N=8192 D=768 V=50304", "nll_max_abs_err": ce_errs["nll"],
                   "lse_max_abs_err": ce_errs["lse"], "tol": CE_TOL, "bit_equal_twice": True,
                   "control_drop64_max_abs_err": ce_errs["control_drop64"],
                   "control_pad_max_abs_err": ce_errs["control_pad"],
                   "logits_gemm_ms": ce_errs["logits_gemm_ms"],
                   "library_is": "none; logits_gemm_ms is torch.mm(x, w.t()) alone, bf16"},
        "ce_bwd": {"err_is": "max over the elements of |err| / |ref|, against the plain "
                          "version's fp32 P", "shape": "N=2048 D=768 V=50304",
                   "tol": CE_BWD_TOL, "bit_equal_twice": True,
                   "control_no_onehot": ce_bwd_errs["control_no_onehot"],
                   "logits_gemm_ms": ce_bwd_errs["logits_gemm_ms"],
                   "dx_ms": ce_bwd_errs["dx_ms"], "dw_ms": ce_bwd_errs["dw_ms"],
                   "plain_is": "the plain version with bf16 logits (the plain route's P)",
                   "library_is": "none; logits_gemm_ms is torch.mm(x, w.t()) alone, bf16"},
        "adamw": {"err_is": "max|err| / max|ref|", "shape": "148 leaves, 124,475,904 params",
                  "library_is": "torch.optim.AdamW(fused=True).step()",
                  # device time of the kernels alone (torch.profiler): ms and
                  # library_ms hold the call's wait for its pageable table copy
                  "profiler_kernel_ms": adamw_kernel_ms,
                  "library_profiler_kernel_ms": library["adamw_fused_kernel_ms"]},
        "flash_general_fwd": {"lse_max_abs_err": gen_errs["lse"], "row_err": gen_errs["o_row"],
                              "library_is": "F.scaled_dot_product_attention"},
        "flash_general_dq": {"err_is": "max|err| / max|ref|", "row_err": gen_errs["dq_row"],
                             "row_control_excess": gen_errs["dq_control"],
                             "row_control_max_rel": gen_errs["dq_control_max_rel"],
                             "bit_equal_twice": True,
                             "plain_is": "the plain backward computes dq, dk and dv together",
                             "library_is": "none: SDPA's backward forms dq, dk and dv in one "
                                           "kernel"},
        "flash_general_dkv": {"err_is": "max|err| / max|ref|",
                              "row_err": gen_errs["dkv_row"],
                              "plain_is": "the plain backward computes dq, dk and dv together",
                              "library_is": "none: SDPA's backward forms dq, dk and dv in one "
                                            "kernel"},
        "flash_rowdot": {"err_is": "max|err| / max|ref|",
                         # the general backward as a whole against the one
                         # library call that computes the same function
                         "general_backward": {
                             "is": "D + dq + dk/dv kernels",
                             "ms": gen_t["rowdot"][0] + gen_t["dq"][0] + gen_t["dkv"][0],
                             "library_ms": lib_long["bwd"],
                             "library_is": "autograd.grad of q, k and v through SDPA"}},
        "flash_lse_fwd": {"lse_max_abs_err": lse_errs["lse"], "row_err": lse_errs["o_row"],
                          "library_is": "F.scaled_dot_product_attention"},
        "flash_fused_bwd": {"err_is": "max|err| / max|ref|, with a random lse cotangent",
                            "dq_row_err": lse_errs["dq_row"], "dkv_row_err": lse_errs["dkv_row"],
                            "dq_two_runs_max_diff_over_max": lse_errs["rerun"],
                            "library_is": "autograd.grad of q, k and v through SDPA"},
        "flash_general_fwd_f32": {
            "lse_max_abs_err": gen32_errs["lse"], "row_err": gen32_errs["o_row"],
            "controls": gen32_errs["controls"], "build": f32_report["flash_general_fwd_f32_kernel"],
            "tol": {"o": F32_TOL, "lse": F32_TOL, "row": F32_ROW_TOL}, "bit_equal_twice": True,
            "bound_peak": "67 TFLOP/s fp32 outside the tensor cores",
            "library_is": "F.scaled_dot_product_attention on fp32 operands"},
        "flash_general_bwd_f32": {
            "err_is": "max|err| / max|ref|", "row_err": gen32_errs["row"],
            "also_replaces": f"{jfa}:509", "controls": gen32_errs["controls"],
            "build": f32_report["flash_general_bwd_f32_kernel"],
            "tol": {"max_rel": F32_TOL, "row": F32_ROW_TOL}, "bit_equal_runs": F32_BWD_RUNS,
            "bound_peak": "67 TFLOP/s fp32 outside the tensor cores",
            "plain_is": "the plain backward on the kernel's D",
            "library_is": "autograd.grad of q, k and v through SDPA on fp32 operands (D "
                          "included; flash_rowdot_f32 launches it here)"},
        "flash_rowdot_f32": {"err_is": "max|err| / max|ref|",
                             "general_backward": {
                                 "is": "D + the fp32 general backward",
                                 "ms": gen32_t["dd"][0] + gen32_t["bwd"][0],
                                 "library_ms": gen32_t["sdpa_bwd_ms"]}},
        "flash_lse_fwd_f32": {
            "lse_max_abs_err": lse32_errs["lse"], "row_err": lse32_errs["o_row"],
            "tol": {"o": F32_TOL, "lse": F32_TOL, "row": F32_ROW_TOL},
            "bit_equal_runs": F32_BWD_RUNS, "parts": lse32_errs["parts"],
            "controls": {n: c for n, c in lse32_errs["controls"].items() if "merge" in n},
            "build": f32_report["flash_lse_fwd_f32_kernel"],
            "merge_build": f32_report["flash_lse_merge_f32_kernel"],
            "shape": "B=1 Tq=Tk=4096 H=12 no mask, chunk views",
            "causal_pair": {"ms": lse32_t["causal"]["fwd"][0],
                            "plain_ms": lse32_t["causal"]["fwd"][1],
                            "bound_ms": attention_bound("fwd", *chunk_shape[:5], True,
                                                        elem_bytes=4, peak=PEAK_FP32_FLOPS)[0],
                            "library_ms": lse32_t["causal"]["sdpa_fwd_ms"]},
            "library_is": "F.scaled_dot_product_attention on fp32 operands"},
        "flash_fused_bwd_f32": {
            "err_is": "max|err| / max|ref|, with a random lse cotangent",
            "row_err": lse32_errs["row"],
            "controls": {n: c for n, c in lse32_errs["controls"].items() if "dlse" in n},
            "tol": {"max_rel": F32_TOL, "row": F32_ROW_TOL}, "bit_equal_runs": F32_BWD_RUNS,
            "shape": "B=1 Tq=Tk=4096 H=12 no mask, chunk views",
            "causal_pair": {"ms": lse32_t["causal"]["bwd"][0],
                            "plain_ms": lse32_t["causal"]["bwd"][1],
                            "bound_ms": attention_bound("fused_bwd", *chunk_shape[:5], True,
                                                        elem_bytes=4, peak=PEAK_FP32_FLOPS)[0],
                            "library_ms": lse32_t["causal"]["sdpa_bwd_ms"]},
            "library_is": "autograd.grad of q, k and v through SDPA on fp32 operands"},
        "flash_dt_fwd": {"lse_max_abs_err": dt_errs["lse"], "row_err": dt_errs["o_row"],
                         "row_control_excess": dt_errs["o_control"],
                         "row_control_elementwise_excess": dt_errs["o_control_elementwise"],
                         "vs_flash_fwd_max_abs_err": dt_errs["vs_k1"],
                         "shape": "B=8 T=1024 H=12 causal, dt layout (H, hs, B*T)",
                         "library_is": "F.scaled_dot_product_attention"},
        "flash_dt_fwd_f32": {
            "lse_max_abs_err": dt32_errs["lse"], "row_err": dt32_errs["o_row"],
            "controls": dt32_errs["controls"], "build": f32_report["flash_dt_fwd_f32_kernel"],
            "merge_build": f32_report["flash_dt_merge_f32_kernel"],
            "parts": dt32_errs["parts"], "merge_launches": dt_counts["flash_dt_fwd_f32_merge"],
            "tol": {"o": F32_TOL, "lse": F32_TOL, "row": F32_ROW_TOL},
            "bit_equal_runs": F32_BWD_RUNS,
            "shape": "B=8 T=1024 H=12 causal fp32, dt layout (H, hs, B*T)",
            "bound_peak": "67 TFLOP/s fp32 outside the tensor cores",
            "library_is": "F.scaled_dot_product_attention on the fp32 operands"},
        "flash_dt_bwd_f32": {
            "err_is": "max|err| / max|ref|", "row_err": dt32_errs["row"],
            "controls": dt32_errs["controls"], "build": f32_report["flash_dt_bwd_f32_kernel"],
            "tol": {"max_rel": F32_TOL, "row": F32_ROW_TOL}, "bit_equal_runs": F32_BWD_RUNS,
            "shape": "B=8 T=1024 H=12 causal fp32, dt layout (H, hs, B*T)",
            "bound_peak": "67 TFLOP/s fp32 outside the tensor cores",
            "library_is": "autograd.grad of q, k and v through SDPA on the fp32 operands"},
        "flash_dt_bwd": {"err_is": "max|err| / max|ref|", "dq_row_err": dt_errs["dq_row"],
                         "dkv_row_err": dt_errs["dkv_row"], "bit_equal_twice": True,
                         "dkv_row_control_excess": dt_errs["dkv_control"],
                         "dkv_row_control_max_rel": dt_errs["dkv_control_max_rel"],
                         "dq_row_control_excess": dt_errs["dq_control"],
                         "dq_row_control_max_rel": dt_errs["dq_control_max_rel"],
                         "shape": "B=8 T=1024 H=12 causal, dt layout (H, hs, B*T)",
                         "library_is": "autograd.grad of q, k and v through SDPA"},
    }
    causal_shape = (*chunk_shape[:5], True)
    lib_causal = library["B1_T4096"]
    for k in kernels:
        k.update(notes[k["name"]])
        if k["name"].startswith("flash_general") or k["name"].startswith("flash_rowdot"):
            k["shape"] = "B=1 T=16384 H=12 causal"
        if k["name"] in ("flash_lse_fwd", "flash_fused_bwd"):
            # the row is the ring's unmasked chunk pair (6 of its 10 launches at 4
            # chunks); the causal pair (the other 4) beside it
            bound_kind, key = (("fwd", "fwd") if k["name"] == "flash_lse_fwd"
                               else ("fused_bwd", "bwd"))
            ms, plain_ms = lse_t["causal"][key]
            k["shape"] = "B=1 Tq=Tk=4096 H=12 no mask"
            b_ms = attention_bound(bound_kind, *causal_shape)[0]
            k["causal_pair"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_share": b_ms / ms, "library_ms": lib_causal[key]}
            k["general_kernels_ms"] = {m: lse_t[m][f"general_{key}_ms"]
                                       for m in ("nomask", "causal")}
    print(json.dumps({"long_context": {"train_step_tokens_per_s": long_train["tps"],
                                       "peak_gib": long_train["peak_gib"],
                                       "trainer_tokens_per_s": long_tps,
                                       "general_vs_self": families,
                                       "sdpa_ms": {"B8_T1024": lib_self, "B1_T16384": lib_long}}}))
    print(json.dumps({"ring": {"train_step_tokens_per_s": ring_train["tps"],
                               "peak_gib": ring_train["peak_gib"],
                               "trainer_tokens_per_s": ring_tps, "op_T16384": ring_op,
                               "sdpa_ms": {"B1_T4096": lib_causal,
                                           "B1_T4096_nomask": lib_chunk}}}))
    print(json.dumps({"ab_dt_flash": dt_bench, "dt_f32_seconds": dt32_s,
                      "k1_at_finetune_shape": k1_short, "profiler_hook": profiler, "card": card}))
    print(json.dumps({"scoring": {"tokens_per_s": n_tok / dt, "plain_tokens_per_s":
                                  n_tok / dt_plain, "micro_batch_device_ms": score_ms,
                                  "micro_batch_device_ms_by_class": score_split}}))
    print(json.dumps({"finetune": ft_runs, "finetune_ops": ft_ops}))
    print(json.dumps({"fp32_long_context": {
        "train_step": long32, "ring_train_step": ring32, "trainers": trainers32,
        "general_f32_ms": gen32_t, "lse_f32_ms": lse32_t, "seconds": fp32_long_s},
        "card": card}))
    print(json.dumps({"fp32_train_step": fp32_train, "k1_big_heads": k1_heads,
                      "gpt2_1558M": big, "card": card}))
    print(json.dumps({"sampler": sampler, "decode": decode, "eval_quality": quality,
                      "clip": clip, "clip_entry_points": clip_clis, "seconds": slice_s,
                      "card": card}))
    print(f"whole run: {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"train_step_tokens_per_s": {"kernel": train["kernel_tps"],
                                                  "plain": train["plain_tps"]}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"parallel": parallel, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
