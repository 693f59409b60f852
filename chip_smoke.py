#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. build   — compile every CUDA kernel of the serve and train paths from
             csrc/ (one nvcc per source, all at once) and print the
             seconds it took.
2. kernels — at full width, on seeded inputs with ragged lengths and one
             all-masked row, hold each kernel against its plain PyTorch
             version (forward outputs and residuals: max abs error <= 1e-4
             in float32, TF32 off; gradients against autograd of the plain
             version: <= 1e-4 * max(1, max |plain|)) and time both with
             CUDA events from a cold L2. GRU kernels 1-3 also run with
             (act_in, act_gate) = (relu, sigmoid), (linear, tanh),
             (tanh, relu) and (sigmoid, linear), each of the four
             activations in each slot, held to 1e-4 of max(1, max |plain|)
             (with a ReLU candidate activation, LSTM kernel 8's gradients
             against the plain version's at kernel 7b's own ReLU gates: a
             gate that opens on one side only lies within GATE_EPS of 0).
             Kernels 5 and 6 (the persistent attention-GRU training grids)
             also at Te = 128, m (a residual of 5) against h_prev . wa + ba,
             two launches of each bit-equal, and the grid barrier timed.
             Kernel 4 (kernel 5's grid without residuals) at Td = 1 and 8,
             two launches bit-equal, with an empty cooperative launch on
             its grid and its weight-slice load timed apart; kernel 3 (the
             persistent GRU backward, dW in the launch) and kernel 2 (the
             persistent GRU training forward) two launches bit-equal, each
             with the barrier timed on its own grid. Kernel 1 (kernel 2's
             body without residuals) at the prefill's T = 32, H = 512 for
             B = 64, 512 (the beam path's), 8 and 1 (the first rows of
             the full admission, extended past 64 with rows of the same
             law), two launches bit-equal and its ys bit-equal to kernel
             2's, timed
             with and without the wrapper's host work, its grid, barrier
             and design bound, and the wrapper's host time back to back.
3. serve   — a main path: the seqToseq NMT generation model at full
             width (vocab 30000, dim 512, random weights from seed 1)
             behind build_engine(slots=64, prompt_tokens=32,
             fused_step=True), answering 128 seeded requests. The kernel
             launch counters are zeroed just before the requests and read
             just after (no decode step may take the plain step: 0 eager
             routes). The same requests then go through the unfused
             decode step, and a small prefill is checked against the CPU;
             one more serve runs under torch.profiler, with kernel 4's
             device ms per micro-step and kernel 1's per prefill.
3a. serve_surface — the rest of the serving surface at the serve phase's
             width, --serve_fused_step on throughout: the JAX chaos tests'
             seqToseq config (gru_encoder_decoder, is_generating, beam 1)
             at vocab 30000, dim 512, max length 32, parsed by the port,
             init_params(seed=1) saved as pass-00000 and seed 2 as
             pass-00001. In this process, the same 128 requests: plain
             decode (the reference); speculation ("2,4") equal to it on
             128 of 128; bf16 slot state within parity_tol (0.05) of it
             and its stored slot bytes under 0.62x, speculation ("2") over
             bf16 equal to bf16 plain on 128 of 128, peak memory of f32 at
             64 slots, bf16 at 64 and at 128; a WeightReloader that swaps
             in pass-00001 once it lands in the watched dir, the next 16
             requests equal to a fresh engine's on it and no request
             dropped. Kernel 1 twice a prefill, kernel 4 at least once a
             micro-step, 0 eager routes in every run. Then through the
             command line (python -m paddle_tpu_torch, subprocesses on the
             card): serve with a journal, a health file and telemetry
             (answers in order, equal to the in-process reference, 128
             accepts and 128 done marks, serve-status and serve-report
             exit 0, TTFT and request latency p50/p99 from the request
             records), serve-fleet over 2 replicas (the same answers), and
             supervise --supervise_job=serve with a stall injected into
             the last cohort (the first 80 requests, so that it holds 16):
             the hangwatch exits 19, the restart answers the journal, rc 0
             after exactly two attempts.
3b. beam   — the third: beam search at the generation model's full width
             (vocab 30000, dim 512, beam_size 3, max_length 32: bench.py's
             bench_nmt_gen), random weights from seed 1, through
             api.GradientMachine(...).asSequenceGenerator().generate on
             nmt_gen_batch(B=64, T=32, seed=1) and at B = 512, each timed
             over 3 calls between zeroed counts (exactly 2 kernel-1
             launches a forward, no other kernel, 0 eager routes): best-beam
             tokens per wall second, decode steps, peak memory; one call
             more at each B under torch.profiler (kernel 1's, the top-K's
             and the products' device ms and shares);
             Trainer.generate on the same batch into a result file, read
             back against the generator's beams. Then, at the same weights
             with the embeddings at unit scale and the output layer's
             weights times 8 (nmt_gen_spread_params: log-probabilities
             that spread as a trained model's, where at init_params' scale
             any choice of tokens scores alike), B = 8 against the CPU
             (every beam's ids equal and its score within 1e-4 relative,
             or at the first step where the two devices' beams differ a
             near tie: the chosen candidates within 1e-4 of each other),
             and beam_size=1 over the 64 prompts against the fused and
             unfused greedy engines: >= 95% of the streams identical.
3c. cli    — the fourth: the seqToseq demo through the port's command
             line (paddle_tpu_torch.cli.main, in this process, on the
             card): demo/seqToseq/{dataprovider,seqToseq_net}.py and its
             train.conf and gen.conf at width 512 (vocab 30000) and
             batch_size 64, in the provider's real mode over a 30,000-word
             dict and corpora from numpy seed 1 (2,048 train and 500 test
             pairs, lengths uniform in 5-50, words Zipf(1.1)): `train` for
             2 passes from a checkpoint of init_params(seed=1) with a log
             line a batch, a test pass and a save each pass; `test` of the
             saved passes; `gen` (beam 3, 32 steps) over 128 sources from
             the last pass. Between zeroed counters: no eager route,
             kernels 2 and 3 twice a step and 5 and 6 once (kernel 1 of the
             test passes and of gen as counted; their decoders run the
             group's loop, as the JAX package's: its decoder template
             matches in training only); every cost finite, pass
             1's test cost below pass 0's, the test job's costs the train
             run's, both checkpoints verified, 128 blocks of 3 beams whose
             words are the dict's; the first batch's cost within 1e-3 of the
             CPU's at the same parameters. Reports target tokens/s
             (valid tokens, the first step left out), the median and p90
             wall ms a batch, the host ms a batch in the feeder (provider
             and pool; packers) and in the transfer to the card, peak
             device memory, and the test and gen walls.
3c'. pass_loop — the pass loop's resilience and telemetry on the cli
             phase's workspace and width, through paddle_tpu_torch.cli.main
             in this process and `python -m paddle_tpu_torch` children,
             from the same checkpoint of init_params(seed=1). Launch groups:
             `train` 1 pass at batches_per_launch=4 against 1, over 2,048
             pairs of 32 source and 32 target words (32 batches of 64, so
             8 groups): every batch's cost within 1e-6 relative, the
             parameters within 1e-5 of scale, 8 loss reads a pass against
             32, the mean batch walls, and the groups that form on the
             cli phase's variable-length corpus. Accumulation through
             Trainer: nmt_batch(B=64, T=32, seed=1) as 4 batches of 16 with
             num_batches_per_send_parameter=4 against the 64 rows at once,
             momentum-SGD parameters within rtol 2e-4 / atol 2e-5 and
             kernels 2, 3, 5 and 6 launched 8, 8, 4 and 4 times; Adam's
             parameters and the mean gradient by parameter reported (Adam's
             first step and a cancelling gradient amplify float32 sum
             order). Non-finite, on the first 256 pairs: a poisoned loss
             under skip finishes; a NaN planted in the first encoder GRU
             layer is blamed (params phase) under skip (which cannot undo
             a poisoned weight: the run dies after --max_nonfinite_steps),
             under abort (the error names it) and under rollback with
             --saving_period_by_batches (restored, learning rate tempered,
             fast-forwarded, completed). Exit codes, as children: a
             supervised child stalled in pass 1 exits 19 with
             hang_report.json and its restart from --init_model_path=auto
             completes (rc 0); a child SIGTERM'd mid-run exits 18 with a
             checkpoint that verifies; trainer.oom=raise@2 returns 20 with
             oom_report.json. Telemetry: the single-launch run again with
             the records, --numerics_log_period=8 and a profiler window
             over batches 2-3 (every record validates, pass_end carries
             model TFLOP/s and MFU, the first step's FLOP count equals the
             CPU's for the same batch within 1e-6, the Chrome trace names
             kernels 2, 3, 5 and 6, `paddle metrics` renders one row a
             pass, one StatSet dump a pass), the numerics' ms a batch
             against the run without them; one line with every number.
3d. layers — the layer library's tail on the card against the port on
             the CPU (the same code, float32, TF32 off), one line a part:
             quick_start's text CNN (demo/quick_start/trainer_config.cnn.py
             at its own widths: embedding 32, context 3, hidden 64, batch
             128) through the port's command line on the demo's synthetic
             provider, 2 passes from a checkpoint of init_params(seed=1):
             the first batch's cost within 1e-3 of the CPU's, pass 1's test
             cost below pass 0's, samples/s and the median and p90 ms a
             batch; then its is_predict=1 config (maxid) on the first test
             batch at the trained pass: the card's ids the CPU's wherever
             the CPU's top-2 margin exceeds 1e-5. The model_zoo embedding
             demo (hsigmoid, dim 32, batch 256) for 2 passes: every cost
             finite and the test cost falling, then its test's own check on
             the trained table (within-cluster cosine above across-cluster)
             and samples/s. The layer zoo (paddle_tpu_torch/tools/layer_zoo.py):
             every layer type, projection, operator and activation of the
             tail at public sizes, forward and gradients by autograd on
             both devices (values 1e-5 of scale, gradients 1e-4 of scale,
             ids equal off ties), each output on the card, forward +
             backward timed with CUDA events (median of 20); the nce
             layer's own draws on the card, and sampling_id's 10^5 draws
             on the card against its distribution (chi-square, p > 1e-3).
4. train   — the other main path: Trainer(nmt_config(vocab=30000,
             dim=512, batch_size=64)) on the card, random weights from
             seed 1, 8 Adam steps on nmt_batch(B=64, T=32, seed=1), the
             launch counters zeroed just before and read just after (2, 2,
             1 and 1 launches per step of the four training kernels); the
             loss must fall. Then one B = 4 step against the same step on
             the CPU (loss and every gradient within 1e-3 * max(1,
             max |grad|)), a pass-00000 save restored into a fresh Trainer
             (parameters and Adam slots equal), one step on a batch of
             sources and targets 128 long (Te = 128, through kernels 5 and 6),
             and one step under torch.profiler.
4a. bf16   — the train path in bf16 mixed precision: Trainer(nmt_config(
             vocab=30000, dim=512, dtype="bfloat16", batch_size=64)) from
             the train phase's seed (so its parameters), 8 Adam steps on
             the same batch between zeroed counts: 16, 16, 8 and 8
             launches of the bf16 instances of kernels 2, 3 and 5 and of
             kernel 6's bf16 body for Hopper (attention_gru_bwd_bf16_sm90),
             none of the float32 ones, 0 eager routes; the master
             parameters, the Adam slots and a step's gradients float32,
             every embedding output bf16; the losses finite, falling, and
             within rtol 0.05 / atol 0.02 of the train phase's float32
             losses. One test pass (2 launches of kernel 1's bf16
             instance). Then 2 steps at dim 384, which the Hopper body does
             not take (D no multiple of 256): the persistent body of kernel 6
             (attention_gru_bwd_bf16) on a main path, held to the same
             steps in float32. Kernels 1, 2, 3, 5 and both bodies of 6 in
             bf16 at their main paths' shapes (6's persistent body at dim
             384, through the route; by name at dim 512 too, beside the
             Hopper body: at_main_shape) against their bf16 plain versions
             (the same rounding points): every output within 1e-2 of the
             plain output's max |.|, the worst error of each printed, two
             launches of 6 bit-equal, its dWa in bf16 spacings of the plain
             version through the body's own d_din beside the one-piece
             control (the Hopper body's within 2); each timed as in phase 2
             (6 and 5 also with the host's enqueue hidden), with its bound
             at 2-byte operands and the bf16 tensor-core rate (bound_ms)
             and its design's (design_bound_ms: the float32 FMA rate the
             persistent bodies multiply at; for the Hopper body its bytes and
             bf16 products plus its barriers). The step's median wall time,
             a profiled step's device time and the peak memory, beside the
             float32 step's.
5. lstm_kernels — kernels 7a, 7b and 8 at the LSTM classifier's full
             width (T = 64, B = 256, H = 512), forward and reversed, with
             the default activations and with (relu, sigmoid, tanh), held
             to their plain versions as in phase 2 and timed the same way;
             two launches of each bit-equal. The forwards 7a and 7b (one
             persistent body in row groups, w's columns resident) also
             timed with 1, 2 and 4 row groups; kernel 8 (the persistent LSTM backward, dW
             and dpeep in the launch) with one row group and with its
             activation codes read at run time; both with their phase
             clocks and the barrier timed on their own grid.
6. lstm_train — the third main path: Trainer(flagship_config(
             dict_dim=10000, emb_dim=256, hidden=512, classes=2)) with
             batch size 256, random weights from seed 1, 8 Adam steps on
             example_batch(B=256, T=64, seed=1); the counters zeroed just
             before and read just after (1 lstm_fwd_train and 1 lstm_bwd
             per step, no lstm_fwd); the loss must fall. Then a B = 4 step
             against the CPU and one step under torch.profiler.
7. lstm_test — the fourth: Trainer.test over 4 seeded batches of 256
             between zeroed counters (4 lstm_fwd, no training kernel), one
             batch more under torch.profiler (its device time); the
             test cost and classification_error of a B = 4 batch against
             the CPU's, and classification_error on the training batch no
             higher after the 8 steps than before them.
7a. lstm_bf16 — the LSTM classifier in bf16 mixed precision: the same
             Trainer with dtype="bfloat16" from the same seed (so the
             float32 phase's initial parameters), 8 Adam steps on its batch
             between zeroed counts (8 launches each of lstm_fwd_train_bf16
             and lstm_bwd_bf16_sm90, kernel 8's bf16 body for Hopper, no
             other kernel, 0 eager routes), the
             losses finite, falling and within rtol 0.05 / atol 0.02 of
             the float32 phase's, the master parameters and Adam slots
             float32; Trainer.test over the 4 test batches (4 launches of
             lstm_fwd_bf16, nothing else); a B = 4 bf16 step against the
             CPU's bf16 plain versions (loss and every gradient within 1e-2
             of scale). Then 2 steps at hidden 480, which the Hopper body
             does not take (H no multiple of 64): the persistent body of kernel 8
             (lstm_bwd_bf16) on a main path, held to the same steps in
             float32. Kernels 7a, 7b and both bodies of 8 in bf16 at their
             main paths' shapes (8's persistent body at hidden 480, through
             the route; by name at hidden 512 too, beside the Hopper body:
             at_main_shape) against their bf16 plain versions (every output
             within 1e-2 of scale, two launches bit-equal; 8's dW in bf16
             spacings of the plain version through the body's own dx4
             beside the one-piece control, the Hopper body's within 2),
             timed as in phase 5, with
             their bound at 2-byte operands and the bf16 tensor-core rate
             and their design's bound. The step's median wall time, a
             profiled step's device time, the step's device time from
             events with the host's enqueue hidden (step_device_ms),
             tokens/s and the peak memory, beside the float32 step's.
7b. lstm_remat — 3 float32 steps of the classifier with remat="full" from
             the float32 phase's parameters and batch: losses equal to its
             first three (1e-6 relative), exactly 2 lstm_fwd_train and 1
             lstm_bwd a step (the backward's recompute launches the
             training forward again), the peak memory beside the plain
             steps'.

8. conv_kernels — kernel 9 at the nine distinct (M, K, N) of ResNet-50's
             1x1 stride-1 convs at B = 64, 224² (taken from the model
             config), with and without a bias: y within 1e-4 of the plain
             version, s and q within 1e-5 of Σ|y| and Σy² per channel, the
             gradients of all three (random cotangents on y, s and q)
             within 1e-4 * max(1, max |plain|) of autograd through the
             plain version; kernel, plain version and torch.addmm (the
             product alone) timed from a cold L2, each shape's ratio to
             addmm and to its tensor-core bound, and the same summed over
             a train step's 30 launches.
9. resnet_train — the fifth: Trainer(resnet_config(50, 224, 1000)) with
             conv_stats_mode="pallas", random weights from seed 1, 8
             Momentum steps on make_image_batch(64, 224, 1000, seed=1); the
             counters zeroed just before and read just after (exactly 30
             conv1x1_stats per step, no other kernel); the loss must fall.
             One step under torch.profiler (copy and transpose kernels
             counted). The same 8 steps again, untimed, on cuDNN's
             deterministic algorithms, whose parameters the checks from
             here on read (resnet_test's and resnet_bf16's too). A B = 2
             step against the CPU: in float64 (the plain path)
             loss, every gradient and every state update within 1e-9 of
             scale; in float32 ("pallas") loss and state updates within
             1e-3 of scale, and the gradients no further from the CPU's
             float64 ones than 3x the CPU's own float32 gradients are,
             plus 1e-3 (the model's gradients jump at the scale of
             float32 rounding, see phase_resnet_train). Then the
             same 8 steps with conv_stats_mode="" (no kernel 9),
             again with "" and again with "pallas" (the A/B in turns; one
             "" step profiled).
10. resnet_test — the sixth: Trainer.test over 2 batches of 64 with no
             kernel 9 launch; a B = 2 batch's cost (1e-4 relative) and
             classification_error (equal) against the CPU.
10a. resnet_bf16 — ResNet-50 in bf16 mixed precision: the same Trainer
             with dtype="bfloat16" and "pallas" from the same seed (the
             float32 phase's initial parameters). First 8 bf16 steps at a
             cut batch of 8 on the card and on the CPU (its bf16 plain
             versions) from those parameters: the two curves within rtol
             0.05 / atol 0.02. Then 8 Momentum steps on the float32 phase's
             batch between zeroed counts (240 launches of
             conv1x1_stats_bf16, no other kernel, 0 eager routes), the
             losses finite and falling, the first (no update yet) within
             rtol 0.05 / atol 0.02 of float32's and the curve reported
             beside float32's (ResNet-50's bf16 curve leaves its float32
             one in the JAX package too: its gradients at these
             parameters move by O(1) of their norm under bf16 rounding),
             the master parameters and slots float32; a
             test pass at the float32 test's parameters and batches (no
             launch, the cost within the same bound of float32's); a B = 2
             bf16 step at those parameters against the CPU's bf16 plain
             versions: the loss within 1e-2, each gradient no further from
             the CPU's float64 one (phase 9's) than 3x the CPU's own bf16
             gradient is, plus 1e-2 of scale. Kernel 9's bf16 body at
             the nine shapes against its bf16 plain version (y within 1e-2
             of max |plain|, s and q within 1e-3 of Σ|y| and Σy², two
             launches bit-equal), timed with bf16 addmm, its bound at
             2-byte operands and the bf16 rate, per shape and over a
             step's 30 launches. The step's median wall
             time, a profiled step's device time, images/s and the peak
             memory, beside the float32 step's.
11. attn_kernels — kernels 10, 11 and 12 (flash attention, dQ, dK/dV) on
             strided views of a fused [B, T, 3, H, D] qkv tensor: the main
             path's shape (B = 8, H = 8, T = 2048, D = 64) causal with full
             lengths, the same non-causal with ragged lengths (one of them
             1, one 0), T = 1000 (a ragged last tile), D = 32, D = 128,
             D = 256 (the accumulator features split across warps) and
             D = 40 (4-byte copies, a zero-padded k-step).
             out and the gradients within 1e-4 * max(1, max |plain|), lse
             within 1e-4 on rows that see a key and -1e30 on the others;
             two launches of 11 and of 12 bit-equal; kernel, plain version
             and torch's scaled_dot_product_attention (forward, and its
             backward by autograd against 11 + 12) timed from a cold L2 at
             the main path's shape; kernel 10's ratio to SDPA's forward and
             to its tensor-core bound.
12. lm_train — the seventh: Trainer(long_context_config(vocab=500,
             seq_len=2048, dim=512, heads=8, blocks=2, batch_size=8)),
             random weights from seed 1, 8 Adam steps on lm_batch(500, 8,
             2048, seed=1); the counters zeroed just before and read just
             after (exactly 2 launches of each of kernels 10, 11 and 12 per
             step, no other kernel); the loss must fall. Then a B = 2,
             T = 256 step against the CPU: the loss within 1e-3; ReLU gates
             on which the card and the CPU in float64 disagree all within
             1e-6 of 0 (of the largest |pre-activation|), and every gradient
             within 1e-3 of scale of the CPU's float64 step taken with the
             card's gates (see lm_cpu_step). One step under torch.profiler,
             its device time summed by kernel family.
13. lm_test — the eighth: Trainer.test over 2 batches of 8 x 2048 between
             zeroed counters (2 launches of kernel 10 a batch, none of 11
             or 12); a B = 2, T = 256 batch's cost (1e-4 relative) and
             classification_error (equal) against the CPU.
13a. lm_bf16 — the LM in bf16 mixed precision: long_context_config(...,
             dtype="bfloat16") from the same seed, 8 Adam steps on its
             batch between zeroed counts (16 launches each of
             flash_attn_fwd_bf16_sm90, flash_attn_dq_bf16_sm90 and
             flash_attn_dkv_bf16_sm90, the Hopper bodies of 10, 11 and 12;
             no other kernel, 0 eager routes), the
             losses finite, falling and within rtol 0.05 / atol 0.02 of the
             float32 phase's, the master parameters and Adam slots float32;
             2 steps of the same LM at head dim 40 (dim 320), which the
             Hopper bodies do not take: 4 launches each of the float32
             body's bf16 instances of 10, 11 and 12, nothing else, the
             losses falling and within the same bound of the same 2 steps
             in float32; a test
             pass at the float32 test's parameters (4 launches of
             flash_attn_fwd_bf16_sm90, nothing else; the cost within the
             same bound); a B = 2, T = 256 bf16 step against the CPU's bf16
             plain versions: the loss within 1e-2, every gradient within
             5e-2 of scale of the CPU's step taken at the card's ReLU gates
             (the gates that differ reported with their largest
             |pre-activation|, see lm_bf16_cpu_step). The bf16 bodies
             against their bf16 plain versions at the LM's shape (causal,
             full lengths; non-causal, ragged), T = 1000, D = 128, the
             D = 40 LM's shape (causal, full lengths) and a ragged D = 40
             (each case launching the bodies the route picks: out and
             gradients within 1e-2 of max |plain|, lse within 1e-4, 11 and
             12 bit-equal over two launches; the Hopper bodies' out, dq and
             dv within 1 bf16 spacing and dk within 16, taken at no less
             than 2^-11 of max |plain|, where the plain versions with p and
             ds in one bf16 piece must not be). Each body timed at its main
             path's shape (D = 64 for the Hopper bodies, D = 40 for the
             float32 body's instances) with bf16 SDPA and its
             backward, their bound at 2-byte operands and the bf16 rate
             and their design's (the float32 body's instances: TF32
             passes, fewer for exact bf16 factors; the Hopper bodies: 1.5
             bf16 passes a product, 4/3 for dQ); at the LM's shape the
             float32 body's instances, launched by name, timed beside the
             Hopper bodies.
             The step's wall, device time by family, tokens/s and peak
             memory, beside the float32 step's.
14. nested — the ninth and tenth: the hierarchical document classifier
             over nested sequences (flagship.hierarchical_config(vocab=30000,
             emb_dim=128, hidden=512, lstm_size=128): an outer recurrent
             group over each document's sentences whose step runs
             gru_group(size=512) over the sentence's words, the group form,
             inside the nested loop, and keeps the last; then an fc of 512
             and a ReLU lstmemory of 128 over the sentences), random
             weights: a B = 4 batch (an empty sentence in it) against the
             CPU at the CPU's init_params(seed=1) (cost 1e-4 relative, every
             gradient 1e-3 of scale); 8 Adam steps on nested_doc_batch(B=64,
             seed=1) (1-8 sentences of 3-32 Zipf(1.1) words) between zeroed
             counts (exactly one launch of kernels 7b and 8 a step, no
             other kernel; the loss must fall), the median step, documents
             and words a second, one step under torch.profiler; then
             Trainer.test over 4 batches (one kernel 7a each).
15. demos  — the eleventh to thirteenth: the last demos through
             paddle_tpu_torch.cli.main on the card, each in a workspace of
             its own, from a checkpoint of the CPU's init_params(seed=1):
             demo/sentiment at its own widths on its band's corpus (1,600 /
             800 reviews, 3 passes; 3 launches of 7b and 8 a step, 3 of 7a
             a test batch), demo/image_classification/vgg_16_cifar.py
             small=1 on its lists through image_provider.py and the port's
             image_util (3 passes, no kernel), demo/long_context at the
             lm phases' widths (2 passes over 64 samples of 2048 tokens;
             10, 11 and 12 twice a step, 10 twice a test batch; then `test`
             of the last pass, 10 only). Each: the first batch's cost
             within 1e-3 of the CPU's, pass 1's test cost below pass 0's,
             samples (tokens) a second with the first step left out; the
             test costs beside the JAX package's pinned CPU bands
             (reported, not asserted: the port draws other initial
             parameters than the JAX package for the same seed).
16. sparse — sparse training, which launches none of the kernels (0 of
             each asserted): demo/ctr through paddle_tpu_torch.cli.main at
             num_users=10,000,000 and num_ads=1,000,000 (its emb_dim 16,
             batch 32, AdaGrad) over 4 list entries (128 batches a pass), 2
             passes with --save_dir: samples a wall second (the first step
             left out), the bytes of the tables and slots, the allocator's
             peak over the steps after the first < 8 MB above what was
             allocated after it (a [V] int32 t_last copy would be 40 MB, a
             [V, 16] gradient 640 MB), both checkpoints verified, one
             kind=sparse record a pass with rows_touched = 2 x samples. The
             step in this process at 10 M and at 100 k users (32 steps under
             torch.profiler each): device ms a step, the ratio 10 M / 100 k
             <= 1.25; the row scan (the dense gradient, as accumulation takes
             it) at 10 M over 4 steps: device ms and peak bytes. At the
             demo's default size (120 users) with decay_rate 0.01 and
             decay_rate_l1 0.001 on the tables, 32 AdaGrad steps from one set
             of parameters: the indexed path against the row scan on the
             card (every parameter and slot <= 1e-5 of scale, t_last
             equal), and the card against the CPU from the CPU's
             init_params(seed=1): the first batch's cost <= 1e-5 relative,
             t_last equal, every parameter and slot <= 1e-5 of scale or
             within the CPU's own float32 distance from the same steps in
             float64 (AdaGrad's epsilon of 1e-6 at lr 0.1 passes a gradient
             element's absolute rounding on x1e5 where |g| < 1e-6). A 50%
             pruning mask on ctr's first fc weight: every pruned weight 0
             after a pass. sparse.gather_fault=raise@3 ends a `train` child
             with the named fault and a nonzero exit code. demo/recommendation
             through the command line at its widths on seed1 / seed2, 2
             passes: the first batch's cost within 1e-3 of the CPU's, pass 1's
             test cost below pass 0's, samples a second.

Every main path (3, 3b, 3c, 3c', 4, 4a, 6, 7, 7a, 9, 10, 10a, 12, 13, 13a, 14, 15, 16) runs
between zeroed counts of
the layers' eager routes too (gated_recurrent, lstmemory, full_attention,
the attention decoder group's loop, and the 1x1 convs whose shape kernel 9
refuses: the EAGER_ROUTES of the ops modules) and fails if any layer took
its eager computation instead of a kernel.

Then the per-kernel line ({"kernels": [...]}, 28 rows: 13 float32, the
12 bf16 instances and the Hopper bodies of 10, 11 and 12 after them with
bound_ms at 2-byte operands and the bf16 rate and their design_bound_ms;
rows 9-12, the kernels on
the tensor cores, also carry bound_tc_ms, the bound of their design: three
TF32 products per product at 495 TFLOP/s, or the bytes; rows 1-8, the
persistent grids, carry design_bound_ms, bound_ms plus their grid
barriers at the measured barrier time, and their grid), the card's name
and power
limit as nvidia-smi reports them, and as the last line
{"ok": true, "device": {...}}. Any failure raises, so the exit code is not
0 and no result line is printed; without a CUDA device, or without the
package beside this script, it fails the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate,
# and the float32 rate outside the tensor cores (the kernels' arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the dense TF32 tensor-core rate: kernels 9-12 run each product as three
# TF32 products (the float32-accurate split)
PEAK_TF32_FLOPS = 495e12
# the dense bf16 tensor-core rate (float32 accumulation): the least time of
# the bf16 instances' products, whatever units their design runs them on
PEAK_BF16_FLOPS = 989e12
TOL = 1e-4                 # f32, sums over K of 512..1536 terms in another order
TRAIN_TOL = 1e-3           # a whole train step: the card against the CPU plain versions
FULL = dict(vocab=30000, dim=512, max_length=32, slots=64, prompt_tokens=32)
TRAIN = dict(batch=64, T=32, steps=8, cpu_batch=4)
TRAIN_KERNELS = ("gru_fwd_train", "gru_bwd", "attention_gru_fwd_train", "attention_gru_bwd")
LSTM_KERNELS = ("lstm_fwd", "lstm_fwd_train", "lstm_bwd")
# the LSTM classifier as bench.py trains it (bench_lstm_classifier)
LSTM = dict(dict_dim=10000, emb_dim=256, hidden=512, classes=2, batch=256, T=64,
            steps=8, cpu_batch=4, test_batches=4, remat_steps=3)
LSTM_BF16_KERNELS = ("lstm_fwd_bf16", "lstm_fwd_train_bf16", "lstm_bwd_bf16",
                     "lstm_bwd_bf16_sm90")
# the bf16 classifier at a width kernel 8's Hopper body does not take (H no
# multiple of 64): the persistent body on a main path, held to the float32 steps
LSTM_H480 = dict(hidden=480, steps=2)
REMAT_TOL = 1e-6           # relative: remat recomputes the same forward
# ResNet-50 as bench.py trains it (bench_resnet50), with the demo's batch
RESNET = dict(layer_num=50, img_size=224, classes=1000, batch=64, steps=8, cpu_batch=2,
              test_batches=2, launches_per_step=30, curve_batch=8)
CONV_STATS_TOL = 1e-5      # s and q against Σ|y| and Σy²: sums over up to 207,936 rows
F64_TOL = 1e-9             # a float64 step: the card's convolutions against the CPU's
ATTN_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")
TC_KERNELS = ("conv1x1_stats",) + ATTN_KERNELS     # on the tensor cores
GATE_EPS = 1e-6            # a ReLU gate within float32 rounding of 0 may flip (lm_cpu_step)
# the long-context LM of demo/long_context at its documented 2048-token
# context, with the head dim (64) of benchmarks/attn_bench.py
LM = dict(vocab=500, seq_len=2048, dim=512, heads=8, blocks=2, batch=8, steps=8,
          cpu_batch=2, cpu_T=256, test_batches=2)
N_REQUESTS = 128
# beam search as bench.py's bench_nmt_gen runs it (the seqToseq gen.conf
# workload: beam_size=3), at its 64 and its leading 512 sources of 32 tokens
BEAM = dict(vocab=30000, dim=512, beam_size=3, max_length=32, T=32, batches=(64, 512),
            reps=3, cpu_batch=8)
BEAM_TOL = 1e-4            # scores, relative: sums of 32 log-probabilities on two devices
# the JAX package's allowance for argmax near-ties between two decode
# paths (SLOT_PARITY_TOL in paddle_tpu/graph/decode_step.py)
PARITY_TOL = 0.05
# traces taken of one profiled call where a trace lacks a launch that the
# wrappers counted (profiled's ``complete``)
PROFILE_TRIES = 3
# the layers phase: passes of each demo, and sampling_id's draws on the card
LAYERS_PASSES = 2
SAMPLING_DRAWS = 100_000
# the nested phase: the hierarchical document classifier at the sentiment
# demo's widths (embedding 128, its first stacked ReLU LSTM of 128) with a
# GRU of 512 over each sentence, over documents of 1-8 sentences of 3-32
# Zipf(1.1) words
NESTED = dict(vocab=30000, emb_dim=128, hidden=512, lstm_size=128, batch=64, max_sents=8,
              min_words=3, max_words=32, zipf=1.1, steps=8, test_batches=4, cpu_batch=4)
NESTED_LOSS_TOL = 1e-4     # the B = 4 batch's cost, card against CPU, relative
# the demos phase: the last demos through the command line. sentiment on
# its band's corpus (tests/test_quality_curves.py: 1,600 / 800 reviews, 3
# passes), vgg_16_cifar small=1 on its own lists, long_context at the lm
# phases' widths over one list entry (64 samples, 8 batches) each way
DEMOS = dict(sentiment_train=("seed-train-1", "seed-train-2"), sentiment_test=("seed-test-1",),
             sentiment_passes=3, vgg_passes=3, lm_train=("seed-train-1",),
             lm_test=("seed-test-1",), lm_passes=2)
# the CPU bands the JAX package pins (tests/test_quality_curves.py), reported beside the card's
PINNED_SENTIMENT_COST = [0.29417, 0.14709, 0.10738]
PINNED_VGG_COST = [0.04350, 0.00809, 0.00707]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_bf16(nbytes: float, flops: float):
    """The bound of bf16 work: the bytes, or the products at the card's bf16
    tensor-core rate (the bf16 instances of kernels 1, 2, 3, 5 and 6)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_tc(nbytes: float, flops: float) -> float:
    """The bound of a tensor-core design: the bytes, or three TF32 products
    per float32 product at the TF32 rate (kernels 9-12)."""
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S, 3.0 * flops / PEAK_TF32_FLOPS)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, hide_host: bool = False) -> float:
    """Median of per-call CUDA-event timings after warmup, each call
    starting from a cold L2: on the serve path the 61 MB output projection
    runs between two decode steps and evicts the 50 MB L2. The events
    bracket the wrapper's host work too, which the card waits for where it
    outlasts the flush; ``hide_host`` keeps the card busy ~0.6 ms longer
    (torch.cuda._sleep) while the host enqueues, so that only device time
    is counted."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def step_device_ms(torch, fn, reps: int = 5, sleep_cycles: int = 100_000_000):
    """The device time of a whole step ``fn`` in ms, the median of ``reps``
    calls with the host's enqueue hidden: the card sleeps ``sleep_cycles``
    (~50 ms) while the host enqueues all of ``fn``, so that the events
    bracket device work only (L2 warm). Returns (ms, hidden): ``hidden``
    says whether the host got through every call before the card reached
    its first event; where it did not (``fn`` waited for the card), the
    times hold host time too."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times, hidden = [], True
    for _ in range(reps):
        torch.cuda._sleep(sleep_cycles)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        hidden = hidden and not a.query()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), hidden


def zero_counts(kernels):
    """Set every kernel's launch count and every layer family's eager-route
    count to 0: just before a main path runs."""
    from paddle_tpu_torch.ops import (
        flash_attention, fused_attention_gru, fused_conv1x1_bn, fused_gru, fused_lstm)

    for k in kernels:
        k.launches = 0
    for family in (fused_gru, fused_lstm, flash_attention, fused_attention_gru,
                   fused_conv1x1_bn):
        family.EAGER_ROUTES = 0


def read_counts(kernels):
    """Launches by kernel and eager routes by layer family, just after a main
    path ran: every path of this script runs configs the kernels take, so a
    layer that took its eager computation fails the run."""
    from paddle_tpu_torch.ops import (
        flash_attention, fused_attention_gru, fused_conv1x1_bn, fused_gru, fused_lstm)

    routes = {"gated_recurrent": fused_gru.EAGER_ROUTES, "lstmemory": fused_lstm.EAGER_ROUTES,
              "full_attention": flash_attention.EAGER_ROUTES,
              "attention_decoder": fused_attention_gru.EAGER_ROUTES,
              "conv1x1_stats": fused_conv1x1_bn.EAGER_ROUTES}
    assert not any(routes.values()), ("eager routes on a main path", routes)
    return {k.symbol: k.launches for k in kernels}, routes


def phase_build(kernels):
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_source = _build.build(kernels)
    ptxas = {k.source: [l.strip() for l in k.build_log.splitlines()
                        if "registers" in l or "spill" in l]
             for k in kernels}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": ptxas})


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the serve path's widths."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops.fused_attention_gru import (
        attention_gru_reference, fused_attention_gru)

    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    D, E, Te, B = FULL["dim"], 2 * FULL["dim"], FULL["prompt_tokens"], FULL["slots"]

    def lengths(T):
        lens = rng.randint(1, T + 1, B)
        lens[3] = 0                                   # one all-masked row
        return lens

    results = {}
    # kernel 1: the encoder GRU at prefill, T = prompt_tokens, H = dim
    T, H = Te, D
    x3 = t(rng.randn(T, B, 3 * H) * 0.5)
    w = t(rng.randn(H, 3 * H) / np.sqrt(H))
    mask = t((np.arange(T)[:, None] < lengths(T)[None, :]))
    results["gru_fwd"] = kernel1_cases(torch, dev, x3, mask, w)

    # kernel 4: the attention-GRU decode step, Td = 1 (serving) and Td = 8,
    # ep and ev as transposed views of batch-major buffers, as the serve
    # step passes its slot state
    ep = t(rng.randn(B, Te, D) * 0.3).transpose(0, 1)
    ev = t(rng.randn(B, Te, E) * 0.3).transpose(0, 1)
    em = t((np.arange(Te)[:, None] < lengths(Te)[None, :])[:, :, None])
    h0 = t(rng.randn(B, D) * 0.3)
    wa, ba, v = t(rng.randn(D, D) / np.sqrt(D)), t(rng.randn(1, D) * 0.1), t(rng.randn(1, D) * 0.1)
    wctx, wg = t(rng.randn(E, 3 * D) / np.sqrt(E)), t(rng.randn(D, 3 * D) / np.sqrt(D))
    plan = fa.grid_plan(B, Te, D, E, fa.card_sms(dev))
    cases = []
    for Td in (1, 8):
        xw = t(rng.randn(Td, B, 3 * D) * 0.5)
        dmask = t(rng.rand(Td, B, 1) > 0.2)
        args = (ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg)
        got = fused_attention_gru(*args)
        again = fused_attention_gru(*args)
        ref = attention_gru_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        assert torch.isfinite(got).all() and err <= TOL, ("attention_gru_fwd", Td, err)
        assert torch.equal(got, again), ("attention_gru_fwd", Td)
        ms = time_ms(torch, lambda: fused_attention_gru(*args))
        cases.append({"Td": Td, "max_abs_err": err, "ms": ms,
                      "device_ms": time_ms(torch, lambda: fused_attention_gru(*args),
                                           hide_host=True),
                      "plain_ms": time_ms(torch, lambda: attention_gru_reference(*args)),
                      "per_step_us": 1e3 * ms / Td, "grid_barriers": fa.grid_barriers(Td)[0],
                      "blocks": plan["blocks"], "smem_bytes_per_block": plan["fwd_smem_bytes"]})
        if Td == 1:
            step_args = args
    # what every launch pays: an empty cooperative launch on the same grid,
    # and the same launch loading the weight slices and stopping
    empty = barrier_bench(torch, dev, plan["blocks"], plan["fwd_smem_bytes"])
    empty_ms = time_ms(torch, lambda: empty(0), hide_host=True)
    slices_ms = time_ms(torch, lambda: fa._launch_fwd(
        *step_args, fa.KERNEL_ACTS, False, kernel=fa.ATTENTION_GRU_FWD_SLICES), hide_host=True)
    # the wrapper's host time a launch, back to back (the serve step pays it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fused_attention_gru(*step_args)
    torch.cuda.synchronize()
    back_to_back_ms = (time.perf_counter() - t0) * 10.0
    barrier_us = grid_barrier_us(torch, dev, plan["blocks"], plan["fwd_smem_bytes"])
    Td = 1
    nbytes = 4.0 * (Te * B * (D + E + 1) + Td * B * (3 * D + 1 + D) + B * D
                    + D * D + 2 * D + E * 3 * D + D * 3 * D)
    flops = Td * (2.0 * B * D * D + 4.0 * B * Te * D + 2.0 * B * Te * E
                  + 2.0 * B * E * 3 * D + 6.0 * B * D * D)  # pallas_attention_gru._flops
    results["attention_gru_fwd"] = dict(
        cases=cases, shape=dict(Td=1, Te=Te, B=B, D=D, E=E), bytes=nbytes, flops=flops,
        barrier_us=barrier_us,
        design_bound_ms=bound(nbytes, flops)[0] + fa.grid_barriers(Td)[0] * barrier_us * 1e-3,
        empty_launch_ms=empty_ms, launch_and_slice_load_ms=slices_ms,
        slice_load_ms=slices_ms - empty_ms, back_to_back_ms=back_to_back_ms)
    phase_train_kernels(torch, dev, rng, t, lengths, results)
    phase_gru_acts(torch, dev, rng, t, lengths, results)
    emit({"phase": "kernels", "cases": {k: r["cases"] for k, r in results.items()}})
    return results


# the batches kernel 1 runs at: the full admission (and the serve's
# warm-up), the beam path's larger batch, and two smaller ones (a serve
# admits whatever is waiting, and the first design used only B SMs); the
# first is the serve's main path
KERNEL1_BATCHES = (FULL["slots"], BEAM["batches"][1], 8, 1)
# kernel 1's symbol as the profiler names it: the body's instance without
# residuals, in float32 (kernel 2 is gru_fwd_kernel<true, float>, kernel
# 4 attention_gru_fwd_kernel<false, float>; the bf16 instances end in
# __nv_bfloat16)
KERNEL1_SYMBOL = re.compile(r"(?<!\w)gru_fwd_kernel<false,\s*float>")


def gru_fwd_work(T, B, H):
    """Bytes (x3, mask, w, ys, each once) and float32 operations
    (kernel_flops.gru_fwd_flops) of kernel 1."""
    return (4.0 * (T * B * 3 * H + T * B + H * 3 * H + T * B * H),
            T * (6.0 * B * H * H + 14.0 * B * H))


def kernel1_cases(torch, dev, x3, mask, w):
    """Kernel 1 against its plain version on the full admission's first B
    rows (past them, rows of the same law from seed 5), for each B of
    KERNEL1_BATCHES, forward and reversed: ys within
    TOL, two launches bit-equal, and equal bit for bit to kernel 2's ys on
    the same inputs (one body). Each case is timed with the wrapper (ms)
    and without its host work (device_ms, which also gives the µs a step),
    with its grid (blocks, shared memory a block, w_in_smem, 2 T - 1
    barriers), its bound and its design bound (the bound plus its barriers
    at the barrier's time on the full admission's grid). The wrapper's
    host time a launch, back to back, at the full admission."""
    from paddle_tpu_torch.ops import fused_gru as fg

    T, _, H3 = x3.shape
    H = H3 // 3
    sms = fg.card_sms(dev)
    more = max(KERNEL1_BATCHES) - x3.shape[1]
    rng = np.random.RandomState(5)
    x3_all = torch.cat([x3, torch.from_numpy(
        rng.randn(T, more, H3).astype(np.float32) * 0.5).to(dev)], dim=1)
    lens = rng.randint(1, T + 1, more)
    mask_all = torch.cat([mask, torch.from_numpy(
        (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(dev)], dim=1)
    cases = []
    for B in KERNEL1_BATCHES:
        xb, mb = x3_all[:, :B], mask_all[:, :B]
        plan = fg.fwd_plan(B, H, sms)
        for reverse in (False, True):
            run = lambda: fg.fused_gru(xb, mb, w, reverse=reverse)
            got, again = run(), run()
            ys2 = fg._launch_fwd(xb, mb, w, reverse, fg.KERNEL_ACTS, residuals=True)[0]
            ref = fg.gru_forward_reference(xb, mb, w, reverse=reverse)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            key = ("gru_fwd", B, reverse)
            assert torch.isfinite(got).all() and err <= TOL, (key, err)
            assert torch.equal(got, again), (key, "two launches differ")
            assert torch.equal(got, ys2), (key, "ys differ from gru_fwd_train's")
            device_ms = time_ms(torch, run, hide_host=True)
            cases.append({"B": B, "reverse": reverse, "max_abs_err": err,
                          "ms": time_ms(torch, run), "device_ms": device_ms,
                          "plain_ms": time_ms(torch, lambda: fg.gru_forward_reference(
                              xb, mb, w, reverse=reverse), reps=5),
                          "per_step_us": 1e3 * device_ms / T, "grid_barriers": fg.fwd_barriers(T),
                          "blocks": plan["blocks"], "smem_bytes_per_block": plan["smem_bytes"],
                          "w_in_smem": bool(plan["w_in_smem"]),
                          "bound_ms": bound(*gru_fwd_work(T, B, H))[0]})
    main = fg.fwd_plan(KERNEL1_BATCHES[0], H, sms)
    barrier_us = grid_barrier_us(torch, dev, main["blocks"], main["smem_bytes"])
    for c in cases:
        c["design_bound_ms"] = c["bound_ms"] + c["grid_barriers"] * barrier_us * 1e-3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fg.fused_gru(x3, mask, w)
    torch.cuda.synchronize()
    back_to_back_ms = (time.perf_counter() - t0) * 10.0
    nbytes, flops = gru_fwd_work(T, KERNEL1_BATCHES[0], H)
    return dict(cases=cases, shape=dict(T=T, B=KERNEL1_BATCHES[0], H=H), bytes=nbytes,
                flops=flops, barrier_us=barrier_us, design_bound_ms=cases[0]["design_bound_ms"],
                back_to_back_ms=back_to_back_ms)


# (act_in, act_gate) beyond the default: each of the four activations in
# each slot of kernels 1-3
GRU_ACTS = (("relu", "sigmoid"), ("linear", "tanh"), ("tanh", "relu"), ("sigmoid", "linear"))


def phase_gru_acts(torch, dev, rng, t, lengths, results):
    """Kernels 1, 2 and 3 at the train path's width (T = 32, B = 64,
    H = 512, reversed) with the other activation pairs: ys, the residuals
    and the gradients within 1e-4 of max(1, max |plain|). Inputs are a fifth
    of the default cases' scale: a relu or linear update gate can exceed 1,
    and h' = u h + (1 - u) c then grows step by step."""
    from paddle_tpu_torch.ops import fused_gru as fg

    T, B, H = TRAIN["T"], TRAIN["batch"], FULL["dim"]
    x3 = t(rng.randn(B, T, 3 * H) * 0.1).transpose(0, 1)
    w = t(rng.randn(H, 3 * H) * 0.2 / np.sqrt(H))
    mask = t((np.arange(T)[:, None] < lengths(T)[None, :]))
    dy = t(rng.randn(T, B, H))
    for acts in GRU_ACTS:
        key = {"acts": list(acts), "reverse": True}
        light = fg.fused_gru(x3, mask, w, True, acts)
        got = fg._launch_fwd(x3, mask, w, True, acts, residuals=True)
        ref = fg.gru_forward_reference(x3, mask, w, True, acts, residuals=True)
        torch.cuda.synchronize()
        for name, out, want in (("gru_fwd", [light], ref[:1]), ("gru_fwd_train", got, ref)):
            err, rel = _err(out, want), _grad_err(out, want)
            assert all(torch.isfinite(a).all() for a in out) and rel <= TOL, (name, key, rel)
            results[name]["cases"].append({**key, "max_abs_err": err, "err_over_scale": rel})
        leaves = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
        kg = torch.autograd.grad(fg.fused_gru(leaves[0], mask, leaves[1], True, acts), leaves, dy)
        plain = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
        pg = torch.autograd.grad(fg.gru_forward_reference(plain[0], mask, plain[1], True, acts),
                                 plain, dy)
        torch.cuda.synchronize()
        err, rel = _err(kg, pg), _grad_err(kg, pg)
        assert all(torch.isfinite(g).all() for g in kg) and rel <= TOL, ("gru_bwd", key, rel)
        results["gru_bwd"]["cases"].append({**key, "max_abs_err": err, "err_over_scale": rel})


def _err(got, ref):
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def _grad_err(got, ref):
    """Largest gradient error over its tolerance scale max(1, max |plain|)."""
    return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(got, ref))


def phase_train_kernels(torch, dev, rng, t, lengths, results):
    """Kernels 2, 3, 5 and 6 at the train path's full widths: GRU T = 32,
    B = 64, H = 512 (forward and reversed); attention-GRU Td = Te = 32,
    B = 64, D = 512, E = 1024, and the same at Te = 128. Kernels 3, 5 and 6
    also report their grid (blocks, shared memory a block, grid barriers a
    launch), their time per step and the grid barrier's own time on their
    grid, and their design bound: the bound plus their barriers; two of
    their launches give the same bits."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_gru as fg

    T, B, H = TRAIN["T"], TRAIN["batch"], FULL["dim"]
    x3 = t(rng.randn(B, T, 3 * H) * 0.5).transpose(0, 1)   # as the layer passes it
    w = t(rng.randn(H, 3 * H) / np.sqrt(H))
    mask = t((np.arange(T)[:, None] < lengths(T)[None, :]))
    dy = t(rng.randn(T, B, H))
    gplan = fg.grid_plan(B, H, fa.card_sms(dev))
    fplan = fg.fwd_plan(B, H, fa.card_sms(dev))
    fwd_cases, bwd_cases = [], []
    for reverse in (False, True):
        got = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
        again = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
        ref = fg.gru_forward_reference(x3, mask, w, reverse, residuals=True)
        torch.cuda.synchronize()
        err = _err(got, ref)
        assert all(torch.isfinite(a).all() for a in got) and err <= TOL, ("gru_fwd_train", reverse, err)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), ("gru_fwd_train", reverse)
        run_fwd = lambda: fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
        ms = time_ms(torch, run_fwd)
        fwd_cases.append({"reverse": reverse, "max_abs_err": err, "ms": ms,
                          "device_ms": time_ms(torch, run_fwd, hide_host=True),
                          "plain_ms": time_ms(torch, lambda: fg.gru_forward_reference(
                              x3, mask, w, reverse, residuals=True), reps=5),
                          "per_step_us": 1e3 * ms / T, "grid_barriers": fg.fwd_barriers(T),
                          "blocks": fplan["blocks"], "smem_bytes_per_block": fplan["smem_bytes"],
                          "w_in_smem": bool(fplan["w_in_smem"])})
        _, saved, hprev = got
        leaves = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
        kg = torch.autograd.grad(fg.fused_gru(leaves[0], mask, leaves[1], reverse), leaves, dy)
        plain = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
        ys_plain = fg.gru_forward_reference(plain[0], mask, plain[1], reverse)
        pg = torch.autograd.grad(ys_plain, plain, dy, retain_graph=True)
        torch.cuda.synchronize()
        err, rel = _err(kg, pg), _grad_err(kg, pg)
        assert all(torch.isfinite(g).all() for g in kg) and rel <= TOL, ("gru_bwd", reverse, rel)
        one = fg._launch_bwd(dy, saved, hprev, mask, w, reverse, fg.KERNEL_ACTS)
        two = fg._launch_bwd(dy, saved, hprev, mask, w, reverse, fg.KERNEL_ACTS)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(one, two)), ("gru_bwd", reverse)
        run_bwd = lambda: fg._launch_bwd(dy, saved, hprev, mask, w, reverse, fg.KERNEL_ACTS)
        ms = time_ms(torch, run_bwd)
        bwd_cases.append({"reverse": reverse, "max_abs_err": err, "err_over_scale": rel,
                          "ms": ms, "device_ms": time_ms(torch, run_bwd, hide_host=True),
                          "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
                              ys_plain, plain, dy, retain_graph=True), reps=5),
                          "per_step_us": 1e3 * ms / T, "grid_barriers": fg.grid_barriers(T),
                          "blocks": gplan["blocks"], "smem_bytes_per_block": gplan["smem_bytes"],
                          "w_in_smem": bool(gplan["w_in_smem"]),
                          "dw_in_smem": bool(gplan["dw_in_smem"])})
    fwd_bytes, fwd_flops = gru_fwd_work(T, B, H)
    fwd_bytes += 4.0 * (T * B * 3 * H + T * B * H)                      # acts, hprev
    fwd_barrier_us = grid_barrier_us(torch, dev, fplan["blocks"], fplan["smem_bytes"])
    results["gru_fwd_train"] = dict(
        cases=fwd_cases, shape=dict(T=T, B=B, H=H), bytes=fwd_bytes, flops=fwd_flops,
        barrier_us=fwd_barrier_us,
        design_bound_ms=(bound(fwd_bytes, fwd_flops)[0]
                         + fg.fwd_barriers(T) * fwd_barrier_us * 1e-3))
    gru_bwd_bytes = 4.0 * (T * B * H + T * B * 3 * H + T * B * H + T * B + H * 3 * H  # dy, acts, hprev, mask, w
                           + T * B * 3 * H + H * 3 * H)                              # dx3, dw
    gru_bwd_flops = T * (12.0 * B * H * H + 25.0 * B * H)   # kernel_flops.gru_bwd_flops
    gru_barrier_us = grid_barrier_us(torch, dev, gplan["blocks"], gplan["smem_bytes"])
    # where a step of kernel 3 goes: block 0's clock at its phases' ends
    clocks = torch.zeros((T, 4), dtype=torch.int64, device=dev)
    fg._launch_bwd(dy, saved, hprev, mask, w, True, fg.KERNEL_ACTS, phase_ns=clocks)
    torch.cuda.synchronize()
    spans = (clocks[:, 1:] - clocks[:, :-1]).double().mean(0).cpu().tolist()
    phase_us = dict(zip(("phase1_and_barrier", "phase2_and_barrier", "phase3"),
                        (x / 1e3 for x in spans)))
    results["gru_bwd"] = dict(
        cases=bwd_cases, shape=dict(T=T, B=B, H=H), bytes=gru_bwd_bytes, flops=gru_bwd_flops,
        barrier_us=gru_barrier_us, phase_us_per_step=phase_us,
        design_bound_ms=(bound(gru_bwd_bytes, gru_bwd_flops)[0]
                         + fg.grid_barriers(T) * gru_barrier_us * 1e-3))

    Td, Te, D, E = TRAIN["T"], FULL["prompt_tokens"], FULL["dim"], 2 * FULL["dim"]
    plan5 = fa.grid_plan(B, Te, D, E, fa.card_sms(dev))
    barrier_us = grid_barrier_us(torch, dev, plan5["blocks"], plan5["fwd_smem_bytes"])
    cases = [attention_train_case(torch, fa, rng, t, lengths, Td, te, B, D, E, barrier_us)
             for te in (Te, LONG_TE)]
    weights = D * D + 2 * D + E * 3 * D + D * 3 * D
    att = 2.0 * B * D * D + 4.0 * B * Te * D + 2.0 * B * Te * E
    step_fwd = att + 2.0 * B * E * 3 * D + 6.0 * B * D * D   # pallas_attention_gru._flops
    fwd_bytes = 4.0 * (Te * B * (D + E + 1) + Td * B * (3 * D + 1) + B * D + weights
                       + Td * B * (D + D + 3 * D + Te + E + D))   # ys, hprev, acts, alpha, ctx, m
    # the backward kernel's own work per step: the GRU backward (drh, dh_prev:
    # 6 B D^2), d_ctx (6 B D E), dalpha (2 B Te E), the tanh backward (about
    # 8 B Te D), d_m . wa^T (2 B D^2) and dWa's share (2 B D^2).
    # pallas_attention_gru._flops(bwd=True), three forwards, also counts
    # dW_ctx, dW_gru and d_enc_vec, which run outside the kernel.
    step_bwd = B * (10.0 * D * D + 6.0 * D * E + 2.0 * Te * E + 8.0 * Te * D)
    bwd_bytes = 4.0 * (Td * B * D + Te * B * (D + E) + Td * B + weights   # dy, ep, ev, dmask, weights
                       + Td * B * (D + 3 * D + Te + D)                     # hprev, acts, alpha, m
                       + Td * B * (3 * D + E) + B * D + Te * B * D + D * D + 2 * D)  # outputs
    n_fwd, n_bwd = fa.grid_barriers(Td)
    for name, i, nbytes, flops, n_bar in (
            ("attention_gru_fwd_train", 0, fwd_bytes, Td * step_fwd, n_fwd),
            ("attention_gru_bwd", 1, bwd_bytes, Td * step_bwd, n_bwd)):
        bound_ms = bound(nbytes, flops)[0]
        results[name] = dict(
            cases=[c[i] for c in cases], shape=dict(Td=Td, Te=Te, B=B, D=D, E=E),
            bytes=nbytes, flops=flops, barrier_us=barrier_us,
            design_bound_ms=bound_ms + n_bar * barrier_us * 1e-3)
    results["attention_gru_bwd"]["flops_jax_count"] = 3.0 * Td * step_fwd


# a training batch whose longest source is 128 tokens: past the first
# design's backward (its shared memory held Te x D floats per row)
LONG_TE = 128


def barrier_bench(torch, dev, blocks, smem):
    """``run(iters)``: one cooperative launch of ``iters`` grid barriers on
    ``blocks`` blocks holding ``smem`` bytes of shared memory each (so that
    they sit one to an SM, as the persistent kernels do); iters = 0 is an
    empty cooperative launch."""
    from paddle_tpu_torch.ops._build import I32, PTR, CudaKernel

    bench = CudaKernel("attention_gru_fwd_train.cu", "grid_barrier_bench", [PTR, I32, I32, I32])
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    return lambda iters: bench.launch(dev, counter.data_ptr(), iters, blocks, smem)


def grid_barrier_us(torch, dev, blocks, smem) -> float:
    """One grid barrier in µs on a persistent kernel's grid: the median over
    three launches of 10,000 barriers."""
    run = barrier_bench(torch, dev, blocks, smem)
    run(1000)
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(10000)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / 10000)
    return statistics.median(times)


def attention_train_case(torch, fa, rng, t, lengths, Td, Te, B, D, E, barrier_us):
    """Kernels 5 and 6 at one shape against their plain versions (the
    residuals and the gradients), two launches of each bit-equal, both
    timed, with the grid each launches."""
    r = lambda *shape: t(rng.randn(*shape) * 0.3)
    em = t((np.arange(Te)[:, None] < lengths(Te)[None, :])[:, :, None])
    args = [r(B, Te, D).transpose(0, 1), r(B, Te, E).transpose(0, 1), em,
            r(Td, B, 3 * D), t((np.arange(Td)[:, None] < lengths(Td)[None, :])[:, :, None]),
            r(B, D), t(rng.randn(D, D) / np.sqrt(D)), r(1, D), r(1, D),
            t(rng.randn(E, 3 * D) / np.sqrt(E)), t(rng.randn(D, 3 * D) / np.sqrt(D))]
    dy = t(rng.randn(Td, B, D))
    key = {"Td": Td, "Te": Te, "B": B, "D": D, "E": E}
    got = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    again = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    ref = fa.attention_gru_reference(*args, residuals=True)
    torch.cuda.synchronize()
    err = _err(got, ref)
    assert all(torch.isfinite(a).all() for a in got) and err <= TOL, ("attention_gru_fwd_train", key, err)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), ("attention_gru_fwd_train", key)
    ep, ev, _, _, dmask, _, wa, ba, v, wctx, wg = args
    _, hprev, saved, alpha, _, m = got
    m_err = float((m - (hprev @ wa + ba)).abs().max())
    assert m_err <= TOL, ("attention_gru_fwd_train m", key, m_err)
    plan = fa.grid_plan(B, Te, D, E, fa.card_sms(args[0].device))
    n_fwd, n_bwd = fa.grid_barriers(Td)
    fwd_ms = time_ms(torch, lambda: fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True))
    fwd_case = {**key, "max_abs_err": max(err, m_err), "ms": fwd_ms,
                "plain_ms": time_ms(torch, lambda: fa.attention_gru_reference(
                    *args, residuals=True), reps=5),
                "per_step_us": 1e3 * fwd_ms / Td, "grid_barriers": n_fwd,
                "blocks": plan["blocks"], "smem_bytes_per_block": plan["fwd_smem_bytes"],
                "barrier_us": barrier_us}
    diff = (0, 1, 3, 5, 6, 7, 8, 9, 10)                   # not the masks

    def kernel_grads():
        leaves = [a.detach().requires_grad_(i in diff) for i, a in enumerate(args)]
        return torch.autograd.grad(fa.fused_attention_gru(*leaves), [leaves[i] for i in diff], dy)

    kg, kg2 = kernel_grads(), kernel_grads()
    plain = [a.detach().requires_grad_(i in diff) for i, a in enumerate(args)]
    ys_plain = fa.attention_gru_reference(*plain)
    pg = torch.autograd.grad(ys_plain, [plain[i] for i in diff], dy, retain_graph=True)
    torch.cuda.synchronize()
    err, rel = _err(kg, pg), _grad_err(kg, pg)
    assert all(torch.isfinite(g).all() for g in kg) and rel <= TOL, ("attention_gru_bwd", key, rel)
    assert all(torch.equal(a, b) for a, b in zip(kg, kg2)), ("attention_gru_bwd", key)
    bwd_ms = time_ms(torch, lambda: fa._launch_bwd(
        dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg))
    bwd_case = {**key, "max_abs_err": err, "err_over_scale": rel, "ms": bwd_ms,
                "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
                    ys_plain, [plain[i] for i in diff], dy, retain_graph=True), reps=5),
                "per_step_us": 1e3 * bwd_ms / Td, "grid_barriers": n_bwd,
                "blocks": plan["blocks"], "smem_bytes_per_block": plan["bwd_smem_bytes"],
                "dep_in_smem": bool(plan["bwd_dep_in_smem"]), "barrier_us": barrier_us}
    return fwd_case, bwd_case


def run_requests(engine, prompts):
    futs = [engine.submit(p, rid=f"r{i}") for i, p in enumerate(prompts)]
    out = [f.result(timeout=600.0) for f in futs]
    assert engine.drain(timeout=120.0), "engine did not drain"
    return out


def phase_serve(torch, dev, kernels):
    from paddle_tpu_torch.flagship import nmt_gen_config
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.serving.frontend import build_engine

    tc = nmt_gen_config(vocab=FULL["vocab"], dim=FULL["dim"], beam_size=1,
                        max_length=FULL["max_length"])
    machine = GradientMachine(tc.model_config)            # device=None: the card
    params = machine.init_params(seed=1)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, FULL["vocab"], size=rng.randint(8, 33)).tolist()
               for _ in range(N_REQUESTS)]
    engine = build_engine(machine, params, slots=FULL["slots"],
                          prompt_tokens=FULL["prompt_tokens"], fused_step=True).start()
    backend = engine._backend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    backend.prefill_launches = backend.decode_microsteps = 0
    t0 = time.perf_counter()
    fused = run_requests(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts(kernels)
    prefills, microsteps = backend.prefill_launches, backend.decode_microsteps
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(r.outcome == "ok" and len(r.tokens) >= 1 for r in fused), \
        [(r.rid, r.outcome, r.error) for r in fused if r.outcome != "ok" or not r.tokens]
    assert prefills > 0 and launches["gru_fwd"] == 2 * prefills, (launches, prefills)
    assert launches["attention_gru_fwd"] >= microsteps > 0, (launches, microsteps)
    assert routes["attention_decoder"] == 0, routes       # every decode step took kernel 4
    assert not any(launches[n] for n in TRAIN_KERNELS + LSTM_KERNELS), launches
    tokens = sum(len(r.tokens) for r in fused)

    unfused_engine = build_engine(machine, params, slots=FULL["slots"],
                                  prompt_tokens=FULL["prompt_tokens"],
                                  fused_step=False).start()
    t0 = time.perf_counter()
    unfused = run_requests(unfused_engine, prompts)
    unfused_wall = time.perf_counter() - t0
    same = sum(a.tokens == b.tokens for a, b in zip(fused, unfused))
    assert same >= (1.0 - PARITY_TOL) * N_REQUESTS, (same, N_REQUESTS)

    # a small prefill on the card against the plain versions on the CPU
    from paddle_tpu_torch.flagship import nmt_gen_batch
    from paddle_tpu_torch.graph.decode_step import capture_prefill, plan_of

    plan, _ = plan_of(machine)
    cpu = GradientMachine(tc.model_config, device="cpu")
    cpu_params = {n: p.cpu() for n, p in params.items()}
    feed = nmt_gen_batch(vocab=FULL["vocab"], B=3, T=8, seed=2, device=dev)
    feed_cpu = nmt_gen_batch(vocab=FULL["vocab"], B=3, T=8, seed=2, device="cpu")
    st_gpu, boots_gpu = capture_prefill(machine, plan, params, feed)
    st_cpu, boots_cpu = capture_prefill(cpu, plan, cpu_params, feed_cpu)
    prefill_err = max(float((st_gpu[n]["value"].cpu() - st_cpu[n]["value"]).abs().max())
                      for n in st_cpu)
    prefill_err = max([prefill_err] + [float((a.cpu() - b).abs().max())
                                       for a, b in zip(boots_gpu, boots_cpu)])
    assert prefill_err <= TOL, prefill_err

    serve = {"phase": "serve", "params": n_params, "requests": N_REQUESTS,
             "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
             "peak_memory_bytes": peak, "prefill_launches": prefills,
             "decode_microsteps": microsteps, "kernel_launches": launches, "eager_routes": routes,
             "unfused_identical": same, "unfused_wall_s": unfused_wall,
             "unfused_tokens_per_s": sum(len(r.tokens) for r in unfused) / unfused_wall,
             "prefill_max_abs_err_vs_cpu": prefill_err,
             "eager_decode_steps": routes["attention_decoder"]}
    emit(serve)
    phase_profile(torch, machine, params, prompts)
    return serve


def phase_profile(torch, machine, params, prompts):
    """Where the serve time goes: the same requests once more under
    torch.profiler, with kernel 4's device time per decode micro-step and
    kernel 1's per prefill (two launches, the encoder's two directions),
    each kernel found by its own symbol."""
    from paddle_tpu_torch.serving.frontend import build_engine

    engine = build_engine(machine, params, slots=FULL["slots"],
                          prompt_tokens=FULL["prompt_tokens"], fused_step=True).start()
    backend = engine._backend

    def serve():
        backend.decode_microsteps = backend.prefill_launches = 0
        run_requests(engine, prompts)

    def kernel1(rows):
        return [(ms, c) for n, ms, c in rows if KERNEL1_SYMBOL.search(n)]

    rows, summary = profiled(
        torch, "profile", serve,
        complete=lambda rows: sum(c for _, c in kernel1(rows)) == 2 * backend.prefill_launches)
    k4 = [(ms, c) for n, ms, c in rows if "attention_gru_fwd_kernel" in n]
    k1 = kernel1(rows)
    k4_ms, k1_ms = sum(ms for ms, _ in k4), sum(ms for ms, _ in k1)
    prefills = backend.prefill_launches
    assert sum(c for _, c in k1) == 2 * prefills > 0, (k1, prefills)
    emit({"phase": "profile_serve_kernels", "decode_microsteps": backend.decode_microsteps,
          "launches": sum(c for _, c in k4), "device_ms": k4_ms,
          "device_ms_per_microstep": (k4_ms / backend.decode_microsteps
                                      if k4 and backend.decode_microsteps else None),
          "prefills": prefills, "kernel1_launches": sum(c for _, c in k1),
          "kernel1_device_ms": k1_ms, "kernel1_device_ms_per_prefill": k1_ms / prefills,
          "kernel1_share_of_device_ms": k1_ms / summary["device_ms"],
          "kernel4_share_of_device_ms": k4_ms / summary["device_ms"]})


# the rest of the serving surface (the serve_surface phase): the JAX chaos
# tests' seqToseq config (tests/test_serve_resilience.py SERVE_CONFIG) at
# the serve phase's full width
SURFACE_CONFIG = """
import sys
sys.path.insert(0, {demo!r})
from paddle.trainer_config_helpers import *
from seqToseq_net import gru_encoder_decoder

settings(batch_size=2, learning_rate=1e-3, learning_method=AdamOptimizer())
gru_encoder_decoder(source_dict_dim={vocab}, target_dict_dim={vocab},
                    is_generating=True, word_vector_dim={dim},
                    encoder_size={dim}, decoder_size={dim}, beam_size=1,
                    max_length={max_length})
"""
SURFACE = dict(spec="2,4", spec_bf16="2", reload_requests=16, reload_poll_s=0.05,
               hang_timeout=3, supervised_requests=80, stall_at=56, cli_timeout=300)


def surface_engine(torch, dev, kernels, machine, params, prompts, name, slots=None, **kw):
    """One in-process serve of ``prompts`` between zeroed counts: every
    request ok, kernel 1 twice a prefill, kernel 4 at least once a
    micro-step, 0 eager routes. Returns the streams, the run's line and
    the engine."""
    from paddle_tpu_torch.serving.frontend import build_engine

    engine = build_engine(machine, params, slots=slots or FULL["slots"],
                          prompt_tokens=FULL["prompt_tokens"], fused_step=True, **kw).start()
    backend = engine._backend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    backend.prefill_launches = backend.decode_microsteps = backend.verify_launches = 0
    t0 = time.perf_counter()
    out = run_requests(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts(kernels)
    assert all(r.outcome == "ok" and r.tokens for r in out), \
        [(r.rid, r.outcome, r.error) for r in out if r.outcome != "ok" or not r.tokens]
    prefills, microsteps = backend.prefill_launches, backend.decode_microsteps
    assert prefills > 0 and launches["gru_fwd"] == 2 * prefills, (name, launches, prefills)
    assert launches["attention_gru_fwd"] >= microsteps > 0, (name, launches, microsteps)
    assert not any(launches[n] for n in TRAIN_KERNELS + LSTM_KERNELS), launches
    tokens = sum(len(r.tokens) for r in out)
    line = {"run": name, "slots": backend.slots, "slot_dtype": backend.slot_dtype,
            "spec": ",".join(map(str, backend.spec_blocks)) or "0", "wall_s": wall,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "slot_state_bytes": backend.slot_state_bytes(), "prefill_launches": prefills,
            "decode_microsteps": microsteps, "verify_launches": backend.verify_launches,
            "kernel1_launches": launches["gru_fwd"],
            "kernel4_launches": launches["attention_gru_fwd"], "spec_ema": engine._spec_ema}
    window = engine.window_roll()                      # the run's serve_window record
    line.update({k: window.get(k) for k in ("spec_proposed", "spec_accepted", "accept_rate",
                                            "queue_wait_share")})
    line.update({f"{k}_ms": {q: 1e3 * window[k][q] for q in ("p50", "p99")}
                 for k in ("ttft", "latency")})
    return [r.tokens for r in out], line, engine


def verify_drive(torch, dev, kernels, machine, params, prompts, ref, slot_dtype, k=4):
    """The verify launch over one full admission of the first ``slots``
    prompts: each launch, every live slot drafts the next ``k`` tokens of
    its reference stream ``ref``, wrong at position (slot + launch) mod
    (k + 1) (k: nowhere), until every slot has finished. Every slot's
    emitted stream must equal its reference; kernel 4 at least once a
    micro-step, 0 eager routes."""
    from paddle_tpu_torch.observability.serving import Request
    from paddle_tpu_torch.serving.torch_backend import TorchDecodeBackend

    S, vocab = FULL["slots"], FULL["vocab"]
    backend = TorchDecodeBackend(machine, params, slots=S, prompt_tokens=FULL["prompt_tokens"],
                                 fused_step=True, spec_tokens=str(k), slot_dtype=slot_dtype)
    zero_counts(kernels)
    t0 = time.perf_counter()
    backend.admit(list(range(S)), [Request(rid=f"v{b}", t_enqueue=0.0, prompt=prompts[b])
                                   for b in range(S)], [FULL["max_length"]] * S)
    got, done = [[] for _ in range(S)], [False] * S
    proposed = accepted = 0
    while not all(done):
        draft = {}
        for b in range(S):
            want = ref[b][len(got[b]):len(got[b]) + k]
            if done[b] or not want:
                continue
            d = list(want)
            wrong = (b + backend.verify_launches) % (k + 1)
            if wrong < len(d):
                d[wrong] = (d[wrong] + 1) % vocab
            draft[b] = d
        out = backend.step(draft=draft)
        for b in range(S):
            emitted = [int(out.tokens[u, b]) for u in range(out.tokens.shape[0])
                       if out.live[u, b]]
            if b in draft:
                proposed += len(draft[b])
                accepted += next((i for i, (x, y) in enumerate(zip(emitted, draft[b])) if x != y),
                                 min(len(emitted), len(draft[b])))
            got[b] += emitted
            done[b] = done[b] or bool(out.finished[b])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = read_counts(kernels)
    assert launches["attention_gru_fwd"] >= backend.decode_microsteps > 0, launches
    assert launches["gru_fwd"] == 2, launches
    return {"run": f"verify_drive_{slot_dtype}", "slots": S, "k": k, "wall_s": wall,
            "verify_launches": backend.verify_launches,
            "decode_microsteps": backend.decode_microsteps,
            "kernel4_launches": launches["attention_gru_fwd"], "drafted": proposed,
            "accepted": accepted, "tokens": sum(map(len, got)),
            "identical": sum(g == r for g, r in zip(got, ref)),
            "first_difference": first_difference(got, ref[:S])}


def first_difference(a, b):
    """(request, token) of the first place two sets of streams part, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, next((j for j, (u, v) in enumerate(zip(x, y)) if u != v), min(len(x), len(y)))
    return None


def cli_child(argv, cwd, stdin="", timeout=None):
    """One ``python -m paddle_tpu_torch`` process on the card; returns
    (completed process, wall seconds)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", *argv], input=stdin,
                         capture_output=True, text=True, cwd=cwd, env=env,
                         timeout=timeout or SURFACE["cli_timeout"])
    return out, time.perf_counter() - t0


def cli_answers(stdout):
    return [d for d in (json.loads(l) for l in stdout.splitlines() if l.strip().startswith("{"))
            if "outcome" in d]


def cli_serve(argv, cwd, stdin, ids, ref):
    """A serve or serve-fleet process over ``stdin``: rc 0, one ok answer per
    id in submission order. Returns its line, with how many streams equal
    ``ref``, the in-process reference."""
    out, wall = cli_child(argv, cwd, stdin)
    assert out.returncode == 0, (argv[0], out.returncode, out.stderr[-3000:])
    got = cli_answers(out.stdout)
    assert [d["id"] for d in got] == ids, [d["id"] for d in got][:8]
    assert all(d["outcome"] == "ok" for d in got), got[:2]
    streams = [d["tokens"] for d in got]
    tokens = sum(map(len, streams))
    return {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "identical_to_in_process": sum(a == b for a, b in zip(streams, ref)),
            "first_difference": first_difference(streams, ref)}


def request_latency_ms(run_dir):
    """TTFT and request latency, p50 and p99 in ms, over a run's ok
    ``kind=request`` records."""
    from paddle_tpu_torch.observability.analyze import load_run

    recs = [r for rs in load_run(run_dir).values() for r in rs
            if r.get("kind") == "request" and r.get("outcome") == "ok"]

    def ms(key):
        v = 1e3 * np.asarray([r[key] for r in recs], dtype=np.float64)
        return {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99))}

    return {"requests_recorded": len(recs), "ttft_ms": ms("ttft_s"), "latency_ms": ms("e2e_s")}


def phase_serve_surface(torch, dev, kernels):
    """The rest of the serving surface at full width: speculation, bf16
    slot state and hot reload in this process, then serve, serve-fleet,
    serve-status, serve-report and a supervised stall through the
    command line, each held to the in-process reference."""
    import shutil
    import tempfile

    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.flagship import nmt_gen_spread_params
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.observability import metrics as obsm
    from paddle_tpu_torch.observability import serving as slog
    from paddle_tpu_torch.observability.analyze import load_run
    from paddle_tpu_torch.serving.frontend import build_engine
    from paddle_tpu_torch.serving.resilience import SERVE_HANG_REPORT, WeightReloader
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    t_phase = time.perf_counter()
    ws = tempfile.mkdtemp(prefix="serve_surface_")
    demo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo", "seqToseq")
    conf = os.path.join(ws, "serve_full.conf")
    with open(conf, "w") as f:
        f.write(SURFACE_CONFIG.format(demo=demo, vocab=FULL["vocab"], dim=FULL["dim"],
                                      max_length=FULL["max_length"]))
    config = parse_config(conf)
    machine = GradientMachine(config.model_config)                 # the card
    params0 = machine.init_params(seed=1)
    params1 = machine.init_params(seed=2)
    pass0 = ckpt.save_checkpoint(os.path.join(ws, "ckpt0"), 0, params0)
    pass1 = ckpt.save_checkpoint(os.path.join(ws, "ckpt1"), 1, params1)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, FULL["vocab"], size=rng.randint(8, 33)).tolist()
               for _ in range(N_REQUESTS)]
    runs = {}

    # ---- in process: the reference, speculation, bf16 slot state
    ref, runs["plain_f32"], _ = surface_engine(torch, dev, kernels, machine, params0, prompts,
                                               "plain_f32")
    # the same serve with the request telemetry on (a record appended to
    # the run dir per request): what the command line's --metrics_path costs
    tel_dir = os.path.join(ws, "telemetry_run")
    obsm.configure(tel_dir)
    try:
        tel, runs["plain_f32_telemetry"], _ = surface_engine(torch, dev, kernels, machine,
                                                             params0, prompts,
                                                             "plain_f32_telemetry")
    finally:
        obsm.flush()
        obsm.configure("")
    runs["plain_f32_telemetry"]["identical"] = sum(a == b for a, b in zip(tel, ref))
    # speculation as a server starts it, with its draft table cold; its
    # telemetry feeds serve-report
    run_dir = os.path.join(ws, "spec_run")
    obsm.configure(run_dir)
    try:
        spec, runs["spec_f32"], _ = surface_engine(torch, dev, kernels, machine, params0,
                                                   prompts, "spec_f32",
                                                   spec_tokens=SURFACE["spec"])
    finally:
        obsm.flush()
        obsm.configure("")
    runs["spec_f32"]["serve_report"] = [
        l for l in slog.format_report(slog.serve_doc(load_run(run_dir))).splitlines()
        if "accept" in l or l.strip().startswith("0 ")]
    bf16, runs["plain_bf16"], _ = surface_engine(torch, dev, kernels, machine, params0, prompts,
                                                 "plain_bf16", slot_dtype="bf16")
    spec16, runs["spec_bf16"], _ = surface_engine(torch, dev, kernels, machine, params0, prompts,
                                                  "spec_bf16", slot_dtype="bf16",
                                                  spec_tokens=SURFACE["spec_bf16"])
    # the engine turns speculation off once its drafts miss (at these
    # weights after one verify launch), so the verify launch is also driven
    # directly over a full admission: every slot drafts its own reference
    # continuation, wrong at a position that moves from slot to slot and
    # launch to launch
    runs["verify_drive_f32"] = verify_drive(torch, dev, kernels, machine, params0, prompts, ref,
                                            "f32")
    runs["verify_drive_bf16"] = verify_drive(torch, dev, kernels, machine, params0, prompts,
                                             bf16, "bf16")
    _, runs["plain_bf16_128_slots"], _ = surface_engine(torch, dev, kernels, machine, params0,
                                                        prompts, "plain_bf16_128_slots",
                                                        slots=2 * FULL["slots"],
                                                        slot_dtype="bf16")
    for name, got, want in (("spec_f32", spec, ref), ("spec_bf16", spec16, bf16)):
        runs[name].update(identical=sum(a == b for a, b in zip(got, want)),
                          first_difference=first_difference(got, want))

    def differing(a, b):
        """Tokens of ``a`` that differ from ``b``, stream by stream: the
        positions that differ, and the tokens one stream has past the
        other's end (eos can end two streams at other lengths)."""
        return sum(sum(x != y for x, y in zip(u, v)) + abs(len(u) - len(v))
                   for u, v in zip(a, b))

    # bf16 against f32 storage: at init_params' scale every log-probability
    # lies within ~2e-5 of -ln(vocab), so the carry's rounding flips argmax
    # near-ties and a flipped stream parts for good (as for beam search,
    # phase 3b); measured here, and held to parity_tol at
    # nmt_gen_spread_params' weights, whose log-probabilities spread as a
    # trained model's
    spread = nmt_gen_spread_params(params0, config.model_config)
    ref_s, runs["plain_f32_spread"], _ = surface_engine(torch, dev, kernels, machine, spread,
                                                        prompts, "plain_f32_spread")
    bf16_s, runs["plain_bf16_spread"], _ = surface_engine(torch, dev, kernels, machine, spread,
                                                          prompts, "plain_bf16_spread",
                                                          slot_dtype="bf16")
    n_tokens = runs["plain_f32"]["tokens"]
    bf16_check = {"parity_tol": PARITY_TOL,
                  "init_params": {"tokens_differing": differing(bf16, ref), "tokens": n_tokens,
                                  "share": differing(bf16, ref) / n_tokens,
                                  "streams_identical": sum(a == b for a, b in zip(bf16, ref))},
                  "spread_params": {"tokens_differing": differing(bf16_s, ref_s),
                                    "tokens": runs["plain_f32_spread"]["tokens"],
                                    "share": (differing(bf16_s, ref_s)
                                              / runs["plain_f32_spread"]["tokens"]),
                                    "streams_identical": sum(a == b for a, b in
                                                             zip(bf16_s, ref_s))},
                  "slot_state_bytes_f32": runs["plain_f32"]["slot_state_bytes"],
                  "slot_state_bytes_bf16": runs["plain_bf16"]["slot_state_bytes"],
                  "slot_bytes_ratio": (runs["plain_bf16"]["slot_state_bytes"]
                                       / runs["plain_f32"]["slot_state_bytes"]),
                  "peak_memory_bytes": {"f32_64_slots": runs["plain_f32"]["peak_memory_bytes"],
                                        "bf16_64_slots": runs["plain_bf16"]["peak_memory_bytes"],
                                        "bf16_128_slots":
                                            runs["plain_bf16_128_slots"]["peak_memory_bytes"]}}
    emit({"phase": "serve_surface_engine", "runs": runs, "bf16": bf16_check})
    assert runs["plain_f32_telemetry"]["identical"] == N_REQUESTS, runs["plain_f32_telemetry"]
    for name in ("spec_f32", "spec_bf16"):
        assert runs[name]["identical"] == N_REQUESTS, (name, runs[name]["first_difference"])
        assert runs[name]["verify_launches"] > 0, name
    for name in ("verify_drive_f32", "verify_drive_bf16"):
        assert runs[name]["identical"] == FULL["slots"], (name, runs[name]["first_difference"])
    assert bf16_check["spread_params"]["share"] <= PARITY_TOL, bf16_check
    assert bf16_check["slot_bytes_ratio"] < 0.62, bf16_check
    same_spec, same_spec16 = runs["spec_f32"]["identical"], runs["spec_bf16"]["identical"]
    bf16_diff = bf16_check["init_params"]["tokens_differing"]

    # ---- in process: hot reload of pass-00001 from a watched dir
    from paddle_tpu_torch import api

    n_new = SURFACE["reload_requests"]
    fresh, runs["fresh_pass1"], _ = surface_engine(torch, dev, kernels, machine, params1,
                                                   prompts[:n_new], "fresh_pass1")
    engine = build_engine(machine, params0, slots=FULL["slots"],
                          prompt_tokens=FULL["prompt_tokens"], fused_step=True).start()
    loader = api.GradientMachine(config.model_config, device=dev)

    def load(path):
        loader.loadParameters(path)
        return loader.params

    watch = os.path.join(ws, "watch")
    os.makedirs(watch)
    reloader = WeightReloader(watch, engine, load, interval_s=SURFACE["reload_poll_s"]).start()
    backend = engine._backend
    zero_counts(kernels)
    backend.prefill_launches = backend.decode_microsteps = 0
    t0 = time.perf_counter()
    staged = os.path.join(ws, "staged")
    shutil.copytree(pass1, staged)
    os.rename(staged, os.path.join(watch, os.path.basename(pass1)))   # lands at once
    # requests keep arriving until the swap has landed, topped up to two
    # waves of slots in flight, so that some are in flight across it
    before, deadline = [], time.perf_counter() + 120.0
    while engine.status()["reloads"] < 1:
        assert time.perf_counter() < deadline, "the reload never landed"
        waiting = sum(not f.done() for f in before[-4 * FULL["slots"]:])
        before += [engine.submit(prompts[(len(before) + j) % N_REQUESTS],
                                 rid=f"pre{len(before) + j}")
                   for j in range(max(2 * FULL["slots"] - waiting, 0))]
        time.sleep(0.005)
    t_swap = time.perf_counter() - t0
    in_flight_at_swap = sum(not f.done() for f in before)
    after = [engine.submit(p, rid=f"post{i}") for i, p in enumerate(prompts[:n_new])]
    pre = [f.result(timeout=600.0) for f in before]
    post = [f.result(timeout=600.0) for f in after]
    reloader.stop()
    assert engine.drain(timeout=120.0)
    launches, routes = read_counts(kernels)
    assert launches["gru_fwd"] == 2 * backend.prefill_launches > 0, launches
    assert launches["attention_gru_fwd"] >= backend.decode_microsteps > 0, launches
    reload_line = {"swap_s": t_swap, "submitted_before_swap": len(before),
                   "in_flight_at_swap": in_flight_at_swap,
                   "pre_ok": sum(r.outcome == "ok" and bool(r.tokens) for r in pre),
                   "post_identical_to_fresh": sum(r.tokens == t for r, t in zip(post, fresh)),
                   "reloads": engine.status()["reloads"], "reload_tag": engine.status()["reload_tag"],
                   "kernel1_launches": launches["gru_fwd"],
                   "kernel4_launches": launches["attention_gru_fwd"]}
    emit({"phase": "serve_surface_reload", **reload_line})
    assert reload_line["pre_ok"] == len(before) and in_flight_at_swap > 0, reload_line
    assert all(r.outcome == "ok" for r in post), [r.outcome for r in post]
    assert reload_line["post_identical_to_fresh"] == n_new, reload_line
    assert reload_line["reloads"] == 1, reload_line

    # ---- through the command line, on the card
    stdin = "".join(json.dumps({"id": f"r{i}", "prompt": p}) + "\n"
                    for i, p in enumerate(prompts))
    ids = [f"r{i}" for i in range(N_REQUESTS)]
    model = ["--use_tpu=true", "--config=serve_full.conf", f"--init_model_path={pass0}",
             f"--serve_slots={FULL['slots']}", f"--serve_prompt_tokens={FULL['prompt_tokens']}",
             "--serve_fused_step=true"]
    journal = os.path.join(ws, "journal.jsonl")
    status = os.path.join(ws, "status.json")
    metrics = os.path.join(ws, "serve_run")
    serve_line = cli_serve(["serve", *model, f"--serve_journal_path={journal}",
                            f"--status_path={status}", f"--metrics_path={metrics}"],
                           ws, stdin, ids, ref)
    recs = [json.loads(l) for l in open(journal) if l.strip()]
    st_out, _ = cli_child(["serve-status", status], ws)
    rep_out, _ = cli_child(["serve-report", metrics], ws)
    serve_line.update(journal_accepts=sum(r.get("op") == "accept" for r in recs),
                      journal_done=sum(r.get("op") == "done" for r in recs),
                      serve_status_rc=st_out.returncode, serve_report_rc=rep_out.returncode,
                      serve_report=rep_out.stdout.splitlines()[:4], **request_latency_ms(metrics))
    emit({"phase": "serve_surface_cli_serve", **serve_line})
    assert serve_line["identical_to_in_process"] == N_REQUESTS, serve_line
    assert serve_line["journal_accepts"] == serve_line["journal_done"] == N_REQUESTS, serve_line
    assert st_out.returncode == 0 and rep_out.returncode == 0, (st_out.stderr[-2000:],
                                                               rep_out.stderr[-2000:])
    assert serve_line["requests_recorded"] == N_REQUESTS, serve_line

    # the same serve with the telemetry alone (no journal, no health file):
    # what the journal's durable appends cost the latency
    metrics_nj = os.path.join(ws, "serve_run_no_journal")
    nj_line = cli_serve(["serve", *model, f"--metrics_path={metrics_nj}"], ws, stdin, ids, ref)
    nj_line.update(request_latency_ms(metrics_nj))
    emit({"phase": "serve_surface_cli_serve_no_journal", **nj_line})
    assert nj_line["identical_to_in_process"] == N_REQUESTS, nj_line

    fleet_line = cli_serve(["serve-fleet", *model, "--fleet_replicas=2",
                            f"--fleet_status_dir={os.path.join(ws, 'fleet')}"],
                           ws, stdin, ids, ref)
    fleet_line.update(replicas=2, serve_wall_s=serve_line["wall_s"])
    emit({"phase": "serve_surface_cli_fleet", **fleet_line})
    assert fleet_line["identical_to_in_process"] == N_REQUESTS, fleet_line

    n_sup = SURFACE["supervised_requests"]
    sup_ids = ids[:n_sup]
    save_dir, sup_dir = os.path.join(ws, "sup_out"), os.path.join(ws, "sup")
    out, sup_wall = cli_child(
        ["supervise", "--supervise_job=serve", *model, f"--save_dir={save_dir}",
         f"--supervise_dir={sup_dir}",
         f"--serve_journal_path={os.path.join(ws, 'sup_journal.jsonl')}",
         f"--serve_hang_timeout={SURFACE['hang_timeout']}", "--restart_base_delay=0.01",
         f"--fault_spec=serve.stall=sleep:3600@{SURFACE['stall_at']}"],
        ws, "".join(stdin.splitlines(keepends=True)[:n_sup]))
    assert out.returncode == 0, ("supervise", out.returncode, out.stderr[-3000:])
    report = json.load(open(os.path.join(save_dir, SERVE_HANG_REPORT)))
    wedged = [s["rid"] for s in report["inflight"]["slots"] if s]
    logs = sorted(n for n in os.listdir(sup_dir) if n.startswith("attempt-"))
    by_attempt = []
    for name in logs:
        answered = {}
        for d in cli_answers(open(os.path.join(sup_dir, name)).read()):
            if d["id"] in sup_ids:
                assert d["id"] not in answered, (d["id"], "answered twice in", name)
                answered[d["id"]] = d["outcome"]
        by_attempt.append(answered)
    first = by_attempt[0]
    second = by_attempt[1] if len(by_attempt) > 1 else {}
    unanswered = set(sup_ids) - set(first)
    sup_line = {"wall_s": sup_wall, "attempts": len(logs), "requests": n_sup,
                "stall_at_boundary": SURFACE["stall_at"], "hang_reason": report["reason"],
                "wedged": len(wedged), "wedged_in_last_cohort": set(wedged) <= set(sup_ids[-16:]),
                "first_attempt": {o: list(first.values()).count(o) for o in set(first.values())},
                "left_unanswered": len(unanswered),
                "second_attempt": {o: list(second.values()).count(o) for o in set(second.values())}}
    emit({"phase": "serve_surface_cli_supervise", **sup_line})
    assert logs == ["attempt-000.log", "attempt-001.log"], logs
    assert report["reason"] == "serve_hang" and wedged, report.get("inflight")
    assert set(wedged) <= set(sup_ids), wedged
    assert set(first) | set(second) == set(sup_ids), (len(first), len(second))
    assert unanswered <= set(second) and all(second[r] == "ok" for r in unanswered), sup_line
    assert all(o in ("ok", "error") for o in first.values()), sup_line
    assert all(first[r] == "error" for r in wedged if r in first), sup_line

    shutil.rmtree(ws, ignore_errors=True)
    surface = {"phase": "serve_surface", "phase_s": time.perf_counter() - t_phase,
               "spec_identical": same_spec, "spec_bf16_identical": same_spec16,
               "verify_drive_launches": [runs["verify_drive_f32"]["verify_launches"],
                                         runs["verify_drive_bf16"]["verify_launches"]],
               "bf16_tokens_differing_at_init_params": bf16_diff,
               "bf16_tokens_differing_at_spread_params":
                   bf16_check["spread_params"]["tokens_differing"], "reload": reload_line,
               "cli_serve_wall_s": serve_line["wall_s"], "cli_fleet_wall_s": fleet_line["wall_s"],
               "cli_supervise_wall_s": sup_wall, "ttft_ms": serve_line["ttft_ms"],
               "latency_ms": serve_line["latency_ms"],
               "ttft_ms_without_journal": nj_line["ttft_ms"],
               "latency_ms_without_journal": nj_line["latency_ms"]}
    emit(surface)
    return surface


def profiled(torch, phase, fn, top: int = 12, complete=None):
    """Run ``fn`` once under torch.profiler and emit the device time summed
    by kernel and the device's busy share of the wall time (kernel time
    over wall; copies are listed too). Returns the (name, ms, count) rows.

    ``complete(rows)``, where given, says whether the trace holds every
    launch that the wrappers' counts say ``fn`` made. The profiler on the
    card has now and then dropped one kernel's event from a trace (one of
    kernel 1's two in a beam forward), which would also leave that
    launch's time out of the summary; such a trace is taken again, up to
    PROFILE_TRIES times in all, and the last one is returned, so that the
    caller's own assertion still fails where no trace was whole."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels, copies): the CPU ops that
            # launched them carry the same device time again
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                dev_us = getattr(e, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(e, "self_cuda_time_total", 0.0)
                rows.append((e.key, dev_us / 1e3, e.count))
        if complete is None or complete(rows):
            break
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows) if rows else None   # None: not measured
    summary = {"phase": phase, "wall_s": wall, "device_ms": busy_ms,
               "device_busy_share": busy_ms / 1e3 / wall if rows else None,
               "device_events": sum(c for _, _, c in rows), "attempts": attempt}
    emit({**summary,
          "top": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:top]]})
    return rows, summary


def beam_config(batch_size):
    from paddle_tpu_torch.flagship import nmt_gen_config

    return nmt_gen_config(vocab=BEAM["vocab"], dim=BEAM["dim"], beam_size=BEAM["beam_size"],
                          max_length=BEAM["max_length"], batch_size=batch_size)


def phase_beam(torch, dev, kernels):
    """Beam search, the main path of seqToseq's gen.conf: the generation
    model at full width (random weights from seed 1) through
    api.GradientMachine(...).asSequenceGenerator() and Trainer.generate on
    the card, at B = 64 and 512 sources of 32 tokens (nmt_gen_batch seed
    1), each timed over BEAM["reps"] calls between zeroed counts (kernel 1
    twice a forward: the encoder's two directions, at B rows before the
    beams' expansion; no other kernel, no eager route) and one call more
    under torch.profiler. Then, at the same weights with their
    log-probabilities spread (nmt_gen_spread_params; at init_params' scale
    every word is about as likely as any other, and any choice of tokens
    scores alike), B = 8 against the CPU (beam_parity) and beam 1 against
    the fused and unfused greedy engines over the same 64 prompts, at
    least 1 - PARITY_TOL of the streams identical."""
    import tempfile

    from paddle_tpu_torch import api
    from paddle_tpu_torch.flagship import nmt_gen_batch, nmt_gen_spread_params
    from paddle_tpu_torch.graph import recurrent_group as rg
    from paddle_tpu_torch.serving.frontend import build_engine
    from paddle_tpu_torch.tools.beam_parity import beam_parity
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer.trainer import read_result_file

    machine = api.GradientMachine(beam_config(BEAM["batches"][0]).model_config)  # the card
    gen = machine.asSequenceGenerator()
    reps = BEAM["reps"]
    runs = {}
    for B in BEAM["batches"]:
        feed = nmt_gen_batch(vocab=BEAM["vocab"], B=B, T=BEAM["T"], seed=1, device=dev)
        gen.generate(feed)                               # first call: allocator, cuBLAS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(kernels)
        rg.BEAM_STEPS = 0
        t0 = time.perf_counter()
        tokens = 0
        for _ in range(reps):
            results = gen.generate(feed)
            tokens += sum(len(sample[0]["ids"]) for sample in results)
        wall = time.perf_counter() - t0
        launches, routes = read_counts(kernels)
        steps = rg.BEAM_STEPS
        assert launches["gru_fwd"] == 2 * reps, launches
        assert not any(n for name, n in launches.items() if name != "gru_fwd"), launches
        assert all(len(sample) == BEAM["beam_size"] for sample in results)
        assert 0 < steps <= reps * BEAM["max_length"] and tokens > 0, (steps, tokens)
        runs[B] = {"B": B, "forwards": reps, "best_beam_tokens": tokens, "wall_s": wall,
                   "tokens_per_s": tokens / wall, "ms_per_forward": 1e3 * wall / reps,
                   "decode_steps": steps, "decode_steps_per_forward": steps / reps,
                   "ms_per_decode_step": 1e3 * wall / steps,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                   "kernel_launches": launches, "eager_routes": routes}
        emit({"phase": "beam", **runs[B]})
        # one forward under the profiler: where its device time goes
        def forward():
            rg.BEAM_STEPS = 0
            gen.generate(feed)

        def kernel1(rows):
            return [(ms, c) for n, ms, c in rows if KERNEL1_SYMBOL.search(n)]

        rows, summary = profiled(torch, f"profile_beam_B{B}", forward,
                                 complete=lambda rows: sum(c for _, c in kernel1(rows)) == 2)
        k1 = kernel1(rows)
        k1_ms = sum(ms for ms, _ in k1)
        topk_ms = sum(ms for n, ms, _ in rows if "topk" in n.lower())
        gemm_ms = sum(ms for n, ms, _ in rows if "gemm" in n.lower())
        assert sum(c for _, c in k1) == 2, k1
        emit({"phase": "profile_beam_kernels", "B": B, "decode_steps": rg.BEAM_STEPS,
              "device_ms_per_decode_step": summary["device_ms"] / rg.BEAM_STEPS,
              "kernel1_launches": 2, "kernel1_device_ms": k1_ms,
              "kernel1_share_of_device_ms": k1_ms / summary["device_ms"],
              "top_k_device_ms": topk_ms, "top_k_share_of_device_ms": topk_ms / summary["device_ms"],
              "gemm_device_ms": gemm_ms, "gemm_share_of_device_ms": gemm_ms / summary["device_ms"]})
        if B == BEAM["batches"][0]:
            feed64 = feed
            best64 = [[e["ids"] for e in sample] for sample in results]

    # Trainer.generate on the same batch into a result file
    trainer = Trainer(beam_config(BEAM["batches"][0]))
    trainer.params = machine.params
    zero_counts(kernels)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gen_result.txt")
        batches = trainer.generate_batches([feed64], result_file=path)
        blocks = read_result_file(path)
    launches, _ = read_counts(kernels)
    assert launches["gru_fwd"] == 2, launches
    n_keep = min(max(int(gen.sub.generator.num_results_per_sample), 1), BEAM["beam_size"])
    assert [idx for idx, _ in blocks] == [str(b) for b in range(len(best64))], blocks[:2]
    assert all([ids for _, ids in beams] == best64[b][:n_keep]
               for b, (_, beams) in enumerate(blocks)), "Trainer.generate != SequenceGenerator"
    assert batches[0][1].shape == (len(best64), BEAM["beam_size"], BEAM["max_length"])
    del trainer

    # B = 8 against the CPU's plain versions, at spread log-probabilities
    spread = api.GradientMachine(
        machine.model_config, params=nmt_gen_spread_params(machine.params, machine.model_config))
    cpu = api.GradientMachine(machine.model_config, device="cpu",
                              params={n: p.cpu() for n, p in spread.params.items()})
    Bc = BEAM["cpu_batch"]
    differ, ties, worst = beam_parity(
        spread, cpu, nmt_gen_batch(vocab=BEAM["vocab"], B=Bc, T=BEAM["T"], seed=2, device=dev),
        nmt_gen_batch(vocab=BEAM["vocab"], B=Bc, T=BEAM["T"], seed=2, device="cpu"),
        BEAM["max_length"], BEAM_TOL)
    del cpu

    # beam 1 against the greedy engines, over the same 64 prompts
    ids, lens = feed64["source_language_word"].ids.cpu(), feed64["source_language_word"].seq_lengths
    prompts = [ids[i, : int(n)].tolist() for i, n in enumerate(lens.cpu())]
    greedy = [sample[0]["ids"] for sample in
              spread.asSequenceGenerator(beam_size=1).generate(feed64)]
    engines = {}
    for fused in (True, False):
        engine = build_engine(spread._core, spread.params, slots=FULL["slots"],
                              prompt_tokens=FULL["prompt_tokens"], fused_step=fused).start()
        streams = [r.tokens for r in run_requests(engine, prompts)]
        same = sum(a == b for a, b in zip(streams, greedy))
        assert same >= (1.0 - PARITY_TOL) * len(prompts), (fused, same)
        engines["fused" if fused else "unfused"] = {
            "identical": same, "tokens": sum(len(x) for x in streams)}
    beam = {"phase": "beam_checks", "result_file_samples": len(blocks),
            "result_file_beams_per_sample": n_keep,
            "parity_weights": "nmt_gen_spread_params",
            "cpu_batch": Bc, "cpu_samples_differ": len(differ), "cpu_near_ties": ties,
            "cpu_worst_score_gap_where_equal": worst,
            "beam1_streams": len(prompts), "beam1_vs_engine": engines,
            "parity_tol": PARITY_TOL}
    emit(beam)
    return {"kernel_launches": runs[BEAM["batches"][0]]["kernel_launches"], "runs": runs}


# the seqToseq demo through the port's command line (the cli phase), at the
# train phase's full width: demo/seqToseq/{train,gen}.conf with their widths
# (32) set to 512 and batch_size 64, in the provider's real mode over a
# 30,000-word dict and corpora drawn from numpy seed 1
CLI = dict(vocab=30000, dim=512, batch=64, train_pairs=2048, test_pairs=500, gen_sources=128,
           min_len=5, max_len=50, zipf=1.1, passes=2, beam_size=3, max_length=32)
CLI_WIDTHS = ("word_vector_dim=32,\n    encoder_size=32,\n    decoder_size=32,",
              "word_vector_dim={dim},\n    encoder_size={dim},\n    decoder_size={dim},")


def cli_workspace(ws):
    """The demo's provider and net, the two configs at full width, the dict
    and corpora; returns --config_args."""
    import shutil

    demo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo", "seqToseq")
    for name in ("dataprovider.py", "seqToseq_net.py"):
        shutil.copy(os.path.join(demo, name), ws)
    edits = {"train": [CLI_WIDTHS, ("batch_size=16", f"batch_size={CLI['batch']}")],
             "gen": [CLI_WIDTHS, ("batch_size=16", f"batch_size={CLI['batch']}"),
                     ("max_length=12", f"max_length={CLI['max_length']}"),
                     ('test_list="test.list"', 'test_list="gen.list"')]}
    for conf, pairs in edits.items():
        with open(os.path.join(demo, f"{conf}.conf")) as f:
            text = f.read()
        assert f"beam_size={CLI['beam_size']}" in text or conf == "train"
        for old, new in pairs:
            assert text.count(old) == 1, (conf, old)
            text = text.replace(old, new.format(dim=CLI["dim"]))
        with open(os.path.join(ws, f"{conf}_full.conf"), "w") as f:
            f.write(text)
    rng = np.random.RandomState(1)
    words = ["<s>", "<e>", "<unk>"] + [f"w{i}" for i in range(3, CLI["vocab"])]
    with open(os.path.join(ws, "dict.txt"), "w") as f:
        f.write("\n".join(words) + "\n")

    def sentence():
        n = rng.randint(CLI["min_len"], CLI["max_len"] + 1)
        ids = np.minimum(rng.zipf(CLI["zipf"], size=n) + 2, CLI["vocab"] - 1)
        return " ".join(words[i] for i in ids)

    for name, n in (("train", CLI["train_pairs"]), ("test", CLI["test_pairs"])):
        with open(os.path.join(ws, f"{name}.txt"), "w") as f:
            f.writelines(f"{sentence()}\t{sentence()}\n" for _ in range(n))
        with open(os.path.join(ws, f"{name}.list"), "w") as f:
            f.write(f"{name}.txt\n")
    with open(os.path.join(ws, "test.txt")) as src, open(os.path.join(ws, "gen.txt"), "w") as f:
        f.writelines(line for _, line in zip(range(CLI["gen_sources"]), src))
    with open(os.path.join(ws, "gen.list"), "w") as f:
        f.write("gen.txt\n")
    return "--config_args=src_dict=dict.txt,trg_dict=dict.txt", words


def run_cli(argv):
    """One call of the port's command line, from the flags' defaults as a
    new process would start; the flags are put back afterwards. Returns
    its wall seconds."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.utils.flags import FLAGS, _Flags

    saved = dict(vars(FLAGS))
    vars(FLAGS).update(vars(_Flags()))
    t0 = time.perf_counter()
    try:
        assert cli.main(argv) == 0, argv
    finally:
        vars(FLAGS).update(saved)
    return time.perf_counter() - t0


class CliProbe:
    """Watches the command line's run from outside: the losses and the
    start and end of every train step's enqueue (Trainer._step), the end of
    every pass, each test pass's results and wall time, the host seconds of
    the feeder's provider and pool (DataProvider._batch_lists_from, its
    dispatcher thread), of its packers (BatchAssembler.assemble) and of the
    pinned transfer to the card (Trainer._to_device), train and test apart,
    and in training the evaluators' copy of their layers off the card
    (Trainer._host_outputs, which waits for the step first: float(loss)
    already did) and their host work (EvaluatorChain.eval_batch). It adds
    no synchronisation: the losses are read after the run."""

    def __init__(self):
        from paddle_tpu_torch.data.feeder import BatchAssembler, DataProvider
        from paddle_tpu_torch.trainer import Trainer
        from paddle_tpu_torch.trainer.evaluators import EvaluatorChain

        self.patches = []
        self.losses, self.step_t, self.pass_end, self.tests = [], [], [], []
        # per train step: enqueue end, copy-off start and end, evaluator seconds
        self.step_end, self.copy_t, self.eval_s = [], [], []
        self.host = {k: {"provider_s": 0.0, "assemble_s": 0.0, "transfer_s": 0.0, "batches": 0}
                     for k in ("train", "test")}
        owner, probe = {}, self
        in_train = [False]

        def patch(cls, name, fn):
            self.patches.append((cls, name, getattr(cls, name)))
            setattr(cls, name, fn)

        step, one_pass, test = Trainer._step, Trainer.train_one_pass, Trainer.test
        to_device, lists, assemble = (Trainer._to_device, DataProvider._batch_lists_from,
                                      BatchAssembler.assemble)
        host_outputs, eval_batch = Trainer._host_outputs, EvaluatorChain.eval_batch

        def _step(trainer, batch, seed):
            probe.step_t.append(time.perf_counter())
            loss, outputs = step(trainer, batch, seed)
            probe.losses.append(loss.detach())
            probe.step_end.append(time.perf_counter())
            return loss, outputs

        def _host_outputs(trainer, outputs, evaluators):
            t0 = time.perf_counter()
            out = host_outputs(trainer, outputs, evaluators)
            if in_train[0]:
                probe.copy_t.append((t0, time.perf_counter()))
            return out

        def _eval_batch(chain, outputs, only=None):
            t0 = time.perf_counter()
            eval_batch(chain, outputs, only)
            if in_train[0]:
                probe.eval_s.append(time.perf_counter() - t0)

        def train_one_pass(trainer, pass_id, provider):
            in_train[0] = True
            try:
                one_pass(trainer, pass_id, provider)
            finally:
                in_train[0] = False
            probe.pass_end.append(time.perf_counter())

        def _test(trainer, pass_id=-1):
            t0 = time.perf_counter()
            results = test(trainer, pass_id=pass_id)
            probe.tests.append(dict(results, pass_id=pass_id, wall_s=time.perf_counter() - t0))
            return results

        def _to_device(trainer, batch):
            t0 = time.perf_counter()
            out = to_device(trainer, batch)
            probe.host["train" if in_train[0] else "test"]["transfer_s"] += \
                time.perf_counter() - t0
            return out

        def _batch_lists_from(dp, samples):
            key = "train" if dp.shuffle else "test"
            owner[id(dp.assembler)] = key
            it = lists(dp, samples)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                probe.host[key]["provider_s"] += time.perf_counter() - t0
                probe.host[key]["batches"] += 1
                yield item

        def _assemble(assembler, samples):
            t0 = time.perf_counter()
            out = assemble(assembler, samples)
            key = owner.get(id(assembler))
            if key is not None:
                probe.host[key]["assemble_s"] += time.perf_counter() - t0
            return out

        patch(Trainer, "_step", _step)
        patch(Trainer, "train_one_pass", train_one_pass)
        patch(Trainer, "test", _test)
        patch(Trainer, "_to_device", _to_device)
        patch(DataProvider, "_batch_lists_from", _batch_lists_from)
        patch(BatchAssembler, "assemble", _assemble)
        patch(Trainer, "_host_outputs", _host_outputs)
        patch(EvaluatorChain, "eval_batch", _eval_batch)

    def close(self):
        for cls, name, fn in reversed(self.patches):
            setattr(cls, name, fn)


def phase_cli(torch, dev, kernels):
    """The seqToseq demo through the port's command line on the card, in
    the provider's real mode: train 2 passes from init_params(seed=1),
    test the saved passes, generate from the last; checked and timed."""
    import tempfile

    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.data.feeder import create_data_provider
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as ws:
        os.chdir(ws)
        try:
            args, words = cli_workspace(ws)
            cfg = parse_config("train_full.conf", args[len("--config_args="):])
            # the parameters both devices start from: init_params(seed=1),
            # drawn on the CPU, as a checkpoint of parameters only
            cpu = GradientMachine(cfg.model_config, device="cpu")
            params0 = cpu.init_params(seed=1)
            init = ckpt.save_checkpoint(os.path.join(ws, "init"), 0, params0)
            # the train provider's batches, replayed on the host from the same
            # seed: the first batch for the CPU, the target tokens of each
            replay = create_data_provider(cfg.data_config, cfg.opt_config.batch_size,
                                          cfg.model_config.input_layer_names, seed=1)
            replayed = [list(replay.batches()) for _ in range(CLI["passes"])]
            tokens = [[int(b["target_language_next_word"].seq_lengths.sum()) for b in p]
                      for p in replayed]
            shapes = sorted({(b["source_language_word"].batch_size,
                              b["source_language_word"].max_len,
                              b["target_language_word"].max_len) for p in replayed for b in p})
            first = replayed[0][0]
            del replayed

            probe = CliProbe()
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                zero_counts(kernels)
                train_s = run_cli(["train", "--config=train_full.conf", args, "--save_dir=out",
                                   f"--num_passes={CLI['passes']}", "--log_period=1",
                                   "--saving_period=1", f"--init_model_path={init}"])
                torch.cuda.synchronize()
                train_launches, routes = read_counts(kernels)
                peak = torch.cuda.max_memory_allocated(dev)
                losses = [float(x) for x in probe.losses]
                train_tests = list(probe.tests)
                host = {k: dict(v) for k, v in probe.host.items()}
                step_t, pass_end = list(probe.step_t), list(probe.pass_end)
                step_end, copy_t, eval_s = (list(probe.step_end), list(probe.copy_t),
                                            list(probe.eval_s))

                probe.tests.clear()
                zero_counts(kernels)
                test_s = run_cli(["test", "--config=train_full.conf", args, "--save_dir=out",
                                  "--test_pass=0", f"--num_passes={CLI['passes']}"])
                test_launches, _ = read_counts(kernels)
                tests = list(probe.tests)

                zero_counts(kernels)
                last = os.path.join("out", ckpt.PASS_FMT % (CLI["passes"] - 1))
                gen_s = run_cli(["gen", "--config=gen_full.conf", args,
                                 f"--init_model_path={last}", "--gen_result=gen_result.txt"])
                gen_launches, _ = read_counts(kernels)
            finally:
                probe.close()
            blocks = read_result_file_words("gen_result.txt")
            problems = {p: ckpt.verify_checkpoint(os.path.join("out", ckpt.PASS_FMT % p))
                        for p in range(CLI["passes"])}

            # the first batch on the CPU, at the same parameters
            with torch.no_grad():
                cpu_loss = float(cpu.loss_fn(params0, first)[0])
        finally:
            os.chdir(cwd)

    n_batches = CLI["train_pairs"] // CLI["batch"]
    steps = CLI["passes"] * n_batches
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    # the training kernels once or twice a step; the in-train test passes'
    # kernel 1 (and 4, which the test pass's decoder loop does not reach) as
    # counted; no other kernel
    want = {k.symbol: 0 for k in kernels}
    want.update(gru_fwd_train=2 * steps, gru_bwd=2 * steps, attention_gru_fwd_train=steps,
                attention_gru_bwd=steps, gru_fwd=train_launches["gru_fwd"],
                attention_gru_fwd=train_launches["attention_gru_fwd"])
    assert train_launches == want, (train_launches, want)
    costs = [t["cost"] for t in train_tests]
    assert len(costs) == CLI["passes"] and all(np.isfinite(costs)) and costs[1] < costs[0], costs
    # the test job over the saved passes: the costs the train run's test passes saw
    assert len(tests) == CLI["passes"] and all(
        abs(t["cost"] - c) <= 1e-5 * abs(c) for t, c in zip(tests, costs)), (tests, costs)
    assert problems == {p: [] for p in range(CLI["passes"])}, problems
    assert len(blocks) == CLI["gen_sources"], len(blocks)
    assert all(len(beams) == CLI["beam_size"] and all(w in words for _, ws_ in beams for w in ws_)
               for _, beams in blocks), blocks[:2]
    first_err = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    assert first_err <= TRAIN_TOL, (losses[0], cpu_loss)

    # per batch: from one step's start to the next's (the last to its
    # pass's end), all but the first step of the run
    walls = host_step_walls(step_t, pass_end, n_batches)
    tok_s = []
    for p in range(CLI["passes"]):
        skip = 1 if p == 0 else 0
        tok_s.append(sum(tokens[p][skip:]) / (pass_end[p] - step_t[p * n_batches + skip]))
    train_batches = host["train"]["batches"]
    # where a batch's wall goes, medians over the steps: the step's enqueue;
    # the wait for the card (float(loss)) to the evaluators' copy; the copy
    # of their layers off the card; their host work
    med = lambda xs: 1e3 * statistics.median(xs)       # noqa: E731
    breakdown = {"step_enqueue": med([e - s for s, e in zip(step_t, step_end)]),
                 "wait_for_card": med([c[0] - e for e, c in zip(step_end, copy_t)]),
                 "evaluator_copy_off_card": med([b - a for a, b in copy_t]),
                 "evaluator_host": med(eval_s)}
    cli_line = {
        "phase": "cli", "config": "demo/seqToseq train.conf/gen.conf at width "
        f"{CLI['dim']}, batch {CLI['batch']}, real mode", "vocab": CLI["vocab"],
        "train_pairs": CLI["train_pairs"], "test_pairs": CLI["test_pairs"],
        "passes": CLI["passes"], "batch_shapes_B_Ts_Tt": shapes,
        "target_tokens_per_pass": [sum(p) for p in tokens],
        "train_target_tokens_per_s_by_pass": tok_s,
        "train_target_tokens_per_s": (sum(tokens[0][1:]) + sum(sum(p) for p in tokens[1:]))
        / sum(walls),
        "batch_wall_ms_median": 1e3 * statistics.median(walls),
        "batch_wall_ms_p90": 1e3 * float(np.percentile(walls, 90)),
        "batch_wall_ms_median_by_part": breakdown,
        "host_ms_per_train_batch": {
            "provider_and_pool": 1e3 * host["train"]["provider_s"] / max(train_batches, 1),
            "assembly": 1e3 * host["train"]["assemble_s"] / max(train_batches, 1),
            "transfer": 1e3 * host["train"]["transfer_s"] / steps},
        "host_test": host["test"],
        "peak_memory_bytes": peak, "losses_first_last": [losses[0], losses[-1]],
        "test_costs_in_train": costs, "train_cli_s": train_s,
        "test_cli_s": test_s, "test_pass_wall_s": [t["wall_s"] for t in tests],
        "test_results": tests, "gen_cli_s": gen_s, "gen_blocks": len(blocks),
        "first_batch_cost": {"card": losses[0], "cpu": cpu_loss, "rel_err": first_err},
        "kernel_launches": {"train": train_launches, "test": test_launches, "gen": gen_launches},
        "eager_routes": routes, "checkpoints_verified": sorted(problems),
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(cli_line)
    return cli_line


def host_step_walls(step_t, pass_end, n_batches):
    """Per batch, from one step's start to the next's (the last to its
    pass's end), the first step of the run left out."""
    walls = []
    for p, end in enumerate(pass_end):
        t = step_t[p * n_batches:(p + 1) * n_batches] + [end]
        walls += [b - a for a, b in zip(t, t[1:])][1 if p == 0 else 0:]
    return walls



# the pass_loop phase: the cli phase's workspace and width; the corpora it
# cuts (each listed in the phase's line) keep its budget
PASS_LOOP = dict(fixed_len=32, fixed_pairs=2048, fuse=4, cut_pairs=256, test_pairs=64,
                 numerics_period=8, profile_start=2, profile_batches=2, hang_timeout=8,
                 child_timeout=300)
# kernels 2, 3, 5 and 6 by their symbols in a profiler trace
TRAIN_SYMBOLS = {"gru_fwd_train": r"(?<!\w)gru_fwd_kernel<true,\s*float>",
                 "gru_bwd": r"(?<!\w)gru_bwd_kernel<\d,\s*\d,\s*float>",
                 "attention_gru_fwd_train": r"(?<!\w)attention_gru_fwd_kernel<true,\s*float>",
                 "attention_gru_bwd": r"(?<!\w)attention_gru_bwd_kernel<float>"}


def loop_workspace(ws, name, train_lines, test_lines, settings=""):
    """A directory of its own with the demo's provider and net, the train
    config at full width (``settings`` added to its settings()), and the
    given corpus lines."""
    import shutil

    d = os.path.join(ws, name)
    os.makedirs(d)
    for f in ("dataprovider.py", "seqToseq_net.py"):
        shutil.copy(os.path.join(ws, f), d)
    with open(os.path.join(ws, "train_full.conf")) as f:
        text = f.read()
    if settings:
        old = "gradient_clipping_threshold=10.0,"
        assert text.count(old) == 1
        text = text.replace(old, f"{old}\n    {settings},")
    with open(os.path.join(d, "train_full.conf"), "w") as f:
        f.write(text)
    for split, lines in (("train", train_lines), ("test", test_lines)):
        with open(os.path.join(d, f"{split}.txt"), "w") as f:
            f.writelines(lines)
        with open(os.path.join(d, f"{split}.list"), "w") as f:
            f.write(f"{split}.txt\n")
    return d


@contextlib.contextmanager
def in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def cli_rc(argv, cwd):
    """One in-process call of the port's command line from ``cwd``, from the
    flags' defaults; the flags and the fault injector are put back after.
    Returns (exit code, the error it raised or None, wall seconds)."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.resilience import faultinject
    from paddle_tpu_torch.utils.flags import FLAGS, _Flags

    saved = dict(vars(FLAGS))
    vars(FLAGS).update(vars(_Flags()))
    obs.registry().reset()           # the counters a new process starts from
    t0 = time.perf_counter()
    rc, err = None, None
    with in_dir(cwd):
        try:
            rc = cli.main(argv)
        except Exception as e:  # noqa: BLE001 — the caller asserts on it
            err = e
        finally:
            vars(FLAGS).update(saved)
            faultinject.configure("")
            # an error leaves its records buffered; the writer's path is
            # relative to this directory
            obs.flush()
    return rc, err, time.perf_counter() - t0


def run_records(run_dir):
    from paddle_tpu_torch.observability import metrics as obs

    return [r for path in obs.metrics_files(run_dir) for r in obs.read_records(path)]


def loop_child(argv, cwd, log):
    """A ``python -m paddle_tpu_torch`` child on the card, started now, its
    output into the file ``log`` (a pipe nobody reads yet would fill)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    with open(log, "w") as f:
        # a session of its own: stop_children ends the child's own children too
        return subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch", *argv], cwd=cwd,
                                env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)


def stop_children(*procs):
    """Kill what is left of each child's session (after a failed check)."""
    import signal

    for proc in procs:
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def child_end(proc, log, timeout):
    """Wait for a child; returns its exit code and output."""
    proc.wait(timeout=timeout)
    with open(log) as f:
        return proc.returncode, f.read()


class LogLines:
    """The port's log lines while it is attached."""

    def __init__(self):
        import logging

        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(record.getMessage())
        self.logger = logging.getLogger("paddle_tpu")
        self.logger.addHandler(self.handler)

    def close(self):
        self.logger.removeHandler(self.handler)


def split_rows(batch, parts):
    """A batch cut into ``parts`` batches of consecutive rows."""
    import dataclasses

    from paddle_tpu_torch.graph import Argument

    B = next(iter(batch.values())).batch_size
    n = B // parts
    return [{name: Argument(**{f.name: None if getattr(a, f.name) is None
                               else getattr(a, f.name)[i * n:(i + 1) * n]
                               for f in dataclasses.fields(a)})
             for name, a in batch.items()} for i in range(parts)]


def params0_nmt(gm):
    """init_params(seed=1) of an nmt_config machine, drawn on the CPU."""
    from paddle_tpu_torch.graph import GradientMachine

    return GradientMachine(gm.model, device="cpu").init_params(seed=1)


def accumulate(torch, dev, kernels, big, method):
    """nmt_config with ``method``, from init_params(seed=1): ``big``'s rows
    as 4 batches of 16 at num_batches_per_send_parameter=4, and as one
    batch. Returns both parameter sets (numpy) and the first run's kernel
    launches."""
    from paddle_tpu_torch.flagship import nmt_config
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils.flags import _Flags

    out = []
    for parts in (4, 1):
        tc = nmt_config(vocab=CLI["vocab"], dim=CLI["dim"], batch_size=64 // parts)
        tc.opt_config.learning_method = method
        tc.opt_config.num_batches_per_send_parameter = parts
        t = Trainer(tc, _Flags())
        t.params = {k: v.to(dev) for k, v in params0_nmt(t.gm).items()}
        t.opt_state = t.updater.init_state(t.params)
        for part in split_rows(big, parts):
            t.train_one_batch(part)
        torch.cuda.synchronize()
        if parts == 4:
            launches, _ = read_counts(kernels)
        out.append({k: v.cpu().numpy() for k, v in t.params.items()})
    return out, launches


def phase_pass_loop(torch, dev, kernels):
    """The pass loop's launch groups, accumulation, non-finite policies,
    exit codes and telemetry on the card (see the module docstring, 3c')."""
    import io
    import signal
    import tempfile

    from paddle_tpu_torch import cli
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.data.feeder import create_data_provider
    from paddle_tpu_torch.flagship import nmt_batch, nmt_config
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.ops import kernel_flops
    from paddle_tpu_torch.resilience import EXIT_HANG, EXIT_OOM, EXIT_PREEMPTED
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    from paddle_tpu_torch.utils.flags import _Flags

    t_phase = time.perf_counter()
    PL = PASS_LOOP
    with tempfile.TemporaryDirectory() as ws:
        args, words = cli_workspace(ws)
        dict_path = os.path.join(ws, "dict.txt")
        args = f"--config_args=src_dict={dict_path},trg_dict={dict_path}"
        with open(os.path.join(ws, "train.txt")) as f:
            train_lines = f.readlines()
        with open(os.path.join(ws, "test.txt")) as f:
            test_lines = f.readlines()[:PL["test_pairs"]]
        cut = loop_workspace(ws, "cut", train_lines[:PL["cut_pairs"]], test_lines)
        cfg = parse_config(os.path.join(cut, "train_full.conf"), args[len("--config_args="):])
        layer = next(l.name for l in cfg.model_config.layers if l.type == "gated_recurrent")
        cpu = GradientMachine(cfg.model_config, device="cpu")
        params0 = cpu.init_params(seed=1)
        init = ckpt.save_checkpoint(os.path.join(ws, "init"), 0, params0)
        base = ["--config=train_full.conf", args, f"--init_model_path={init}",
                "--log_period=0", "--dot_period=0"]
        n_cut = PL["cut_pairs"] // CLI["batch"]
        runs = {}

        # the exit-code drills run as children while this process works on
        # the checks that time nothing
        hang_argv = ["supervise", "--supervise_job=train", *base, "--save_dir=hang",
                     "--supervise_dir=hang_sup", "--num_passes=2", "--restart_base_delay=0.01",
                     f"--step_hang_timeout={PL['hang_timeout']}",
                     f"--fault_spec=trainer.stall=sleep:3600@{n_cut + 1}"]
        t_children = time.perf_counter()
        hang_log, pre_log = os.path.join(ws, "hang.log"), os.path.join(ws, "pre.log")
        hang = loop_child(hang_argv, cut, hang_log)
        pre = loop_child(["train", *base, "--save_dir=pre", "--num_passes=1000"], cut, pre_log)
        try:
            # accumulation through Trainer: 4 x 16 rows against the 64 at once
            big = nmt_batch(vocab=CLI["vocab"], B=64, T=TRAIN["T"], seed=1, device=dev)
            accumulation = {}
            for method in ("momentum", "adam"):
                zero_counts(kernels)
                acc, launches = accumulate(torch, dev, kernels, big, method)
                # the largest |difference| over rtol 2e-4 * |p| + atol 2e-5, and
                # the share of elements past it
                ratio = {k: np.abs(acc[0][k] - acc[1][k]) / (2e-5 + 2e-4 * np.abs(acc[1][k]))
                         for k in acc[1]}
                accumulation[method] = {
                    "max_err_over_tolerance": max(float(r.max()) for r in ratio.values()),
                    "elements_past_tolerance": int(sum((r > 1).sum() for r in ratio.values())),
                    "elements": int(sum(r.size for r in ratio.values())),
                    "kernel_launches": {k: v for k, v in launches.items() if v}}
                del acc
            # the accumulated mean gradient against the batch's at one point,
            # by parameter: the worst one, and the worst of the others
            gm = GradientMachine(nmt_config(vocab=CLI["vocab"], dim=CLI["dim"]).model_config, dev)
            p = {k: v.to(dev) for k, v in params0_nmt(gm).items()}
            g_big = gm.grad_fn()(p, big)[1]
            g_acc = None
            for part in split_rows(big, 4):
                g = gm.grad_fn()(p, part)[1]
                g_acc = {k: v / 4 for k, v in g.items()} if g_acc is None else {
                    k: g_acc[k] + v / 4 for k, v in g.items()}
            errs = {k: float((g_acc[k] - g_big[k]).abs().max())
                    / max(float(g_big[k].abs().max()), 1e-30) for k in g_big}
            ranked = sorted(errs, key=errs.get, reverse=True)
            accumulation["mean_gradient_max_err_over_scale"] = {
                ranked[0]: errs[ranked[0]], "the other parameters": errs[ranked[1]]}
            del gm, p, g_big, g_acc, big
            assert accumulation["momentum"]["max_err_over_tolerance"] <= 1.0, accumulation
            want = {k.symbol: 0 for k in kernels}
            want.update(gru_fwd_train=8, gru_bwd=8, attention_gru_fwd_train=4, attention_gru_bwd=4)
            assert accumulation["momentum"]["kernel_launches"] == {
                k: v for k, v in want.items() if v}, accumulation

            # the preemption, once the child saved a pass
            deadline = time.monotonic() + PL["child_timeout"]
            while time.monotonic() < deadline and pre.poll() is None and \
                    ckpt.latest_pass(os.path.join(cut, "pre")) is None:
                time.sleep(0.2)
            assert pre.poll() is None, child_end(pre, pre_log, 1)
            pre.send_signal(signal.SIGTERM)
            pre_rc, pre_out = child_end(pre, pre_log, PL["child_timeout"])
            pre_s = time.perf_counter() - t_children
            assert pre_rc == EXIT_PREEMPTED, (pre_rc, pre_out[-3000:])
            assert "preemption: checkpoint saved" in pre_out, pre_out[-3000:]
            newest = ckpt.find_restorable_checkpoint(os.path.join(cut, "pre"))
            assert newest is not None and ckpt.verify_checkpoint(newest) == []

            # the OOM drill
            logs = LogLines()
            try:
                rc, err, s = cli_rc(["train", *base, "--save_dir=oom", "--num_passes=1",
                                     "--fault_spec=trainer.oom=raise@2"], cut)
                assert rc == EXIT_OOM and err is None, (rc, err)
                oom = json.load(open(os.path.join(cut, "oom", "oom_report.json")))
                assert oom["reason"] == "oom" and oom["where"] == {"pass": 0, "step": 1}, oom
                runs["oom"] = {"rc": rc, "s": s, "live": oom["live"]}

                # the non-finite policies, blamed
                nonfinite = {}
                for name, policy, spec, extra, passes in (
                        ("skip_loss", "skip", "trainer.nonfinite=raise@3", [], 1),
                        ("skip_layer", "skip", f"trainer.nonfinite_layer=raise:{layer}@3",
                         ["--max_nonfinite_steps=1"], 1),
                        ("abort_layer", "abort", f"trainer.nonfinite_layer=raise:{layer}@3", [], 1),
                        ("rollback_layer", "rollback",
                         f"trainer.nonfinite_layer=raise:{layer}@{n_cut + 2}",
                         ["--saving_period_by_batches=4"], 2)):
                    save = f"nf_{name}"
                    rc, err, s = cli_rc(["train", *base, f"--save_dir={save}",
                                         f"--num_passes={passes}", f"--nonfinite_policy={policy}",
                                         f"--fault_spec={spec}", *extra], cut)
                    recs = [r for r in run_records(os.path.join(cut, save)) if r["kind"] == "nonfinite"]
                    nonfinite[name] = {
                        "rc": rc, "s": s, "error": None if err is None else str(err)[:200],
                        "events": [(r["pass"], r["step"], r.get("blame_layer"), r.get("blame_phase"))
                                   for r in recs]}
                lines = list(logs.lines)
            finally:
                logs.close()
            assert nonfinite["skip_loss"]["rc"] == 0, nonfinite["skip_loss"]
            assert nonfinite["skip_loss"]["events"] == [(0, 2, None, None)], nonfinite
            blamed = (layer, "params")
            assert nonfinite["skip_layer"]["rc"] is None and all(
                e[2:] == blamed for e in nonfinite["skip_layer"]["events"]), nonfinite
            assert len(nonfinite["skip_layer"]["events"]) == 2, nonfinite
            assert nonfinite["abort_layer"]["rc"] is None and f"layer {layer!r}" in \
                nonfinite["abort_layer"]["error"], nonfinite
            assert nonfinite["abort_layer"]["events"] == [(0, 2, *blamed)], nonfinite
            assert nonfinite["rollback_layer"]["rc"] == 0 and \
                nonfinite["rollback_layer"]["events"] == [(1, 1, *blamed)], nonfinite
            assert any("rollback: non-finite loss at pass 1 batch 1" in l and "x0.5" in l
                       for l in lines), "no rollback line"
            assert any("fast-forwarding past the poison region (skipping batches < 2)" in l
                       for l in lines)

            # the hang drill
            hang_rc, hang_out = child_end(hang, hang_log, PL["child_timeout"])
            hang_s = time.perf_counter() - t_children
            assert hang_rc == 0, (hang_rc, hang_out[-3000:])
            assert f"rc={EXIT_HANG}" in hang_out, hang_out[-3000:]
            hang_report = json.load(open(os.path.join(cut, "hang", "hang_report.json")))
            assert hang_report["reason"] == "step_hang" and \
                hang_report["last_progress"] == {"pass": 1, "step": 0}, hang_report
            assert ckpt.verify_checkpoint(os.path.join(cut, "hang", "pass-00001")) == []
            runs["hang_supervised"] = {"rc": hang_rc, "s": hang_s, "age_s": hang_report["age_s"]}
            runs["preempt"] = {"rc": pre_rc, "s": pre_s, "checkpoint": os.path.basename(newest)}
        finally:
            stop_children(hang, pre)

        # three runs of 1 pass over 32 batches of 32 + 32 words: launch groups
        # of k = 4, single launches, and single launches with the records,
        # the numerics table and a profiler window
        rng = np.random.RandomState(2)

        def fixed_sentence():
            ids = np.minimum(rng.zipf(CLI["zipf"], size=PL["fixed_len"]) + 2, CLI["vocab"] - 1)
            return " ".join(words[i] for i in ids)

        fixed_lines = [f"{fixed_sentence()}\t{fixed_sentence()}\n"
                       for _ in range(PL["fixed_pairs"])]
        n_fixed = PL["fixed_pairs"] // CLI["batch"]
        window = set(range(PL["profile_start"], PL["profile_start"] + PL["profile_batches"]))
        fixed, first_flops = {}, []
        counted = Trainer._counted_step

        def counted_spy(trainer, batch, seed):
            out = counted(trainer, batch, seed)
            if not first_flops:
                first_flops.append(next(iter(trainer._flops_cache.values())))
            return out

        Trainer._counted_step = counted_spy
        try:
            for name, k, extra in (
                    ("fused", PL["fuse"], []), ("unfused", 1, []),
                    ("telemetry", 1, [f"--numerics_log_period={PL['numerics_period']}",
                                      "--profile_dir=prof", "--log_period=8",
                                      f"--profile_start_batch={PL['profile_start']}",
                                      f"--profile_num_batches={PL['profile_batches']}"])):
                d = loop_workspace(ws, name, fixed_lines, test_lines,
                                   settings=f"batches_per_launch={k}")
                probe, logs = CliProbe(), LogLines()
                try:
                    zero_counts(kernels)
                    rc, err, s = cli_rc(["train", *base, "--save_dir=out", "--num_passes=1",
                                         *extra], d)
                    torch.cuda.synchronize()
                    launches, _ = read_counts(kernels)
                    losses = [float(x) for x in probe.losses]
                    walls = host_step_walls(list(probe.step_t), list(probe.pass_end), n_fixed)
                    copies = len(probe.copy_t)
                    stat_dumps = sum("=== StatSet global ===" in l for l in logs.lines)
                finally:
                    probe.close()
                    logs.close()
                assert rc == 0 and err is None, (name, rc, err)
                recs = run_records(os.path.join(d, "out"))
                params = ckpt.load_checkpoint(os.path.join(d, "out", "pass-00000"),
                                              device="cpu")[0]
                fixed[name] = {"rc": rc, "s": s, "losses": losses, "walls": walls,
                               "end": [r for r in recs if r["kind"] == "pass_end"][0],
                               "records": recs, "dir": d, "stat_dumps": stat_dumps,
                               "params": {n: v.numpy() for n, v in params.items()},
                               "launches": launches, "evaluator_copies": copies}
        finally:
            Trainer._counted_step = counted
        fk, f1, tel = fixed["fused"], fixed["unfused"], fixed["telemetry"]
        assert (fk["end"]["launches_fused"], fk["end"]["launches_single"]) == (
            n_fixed // PL["fuse"], 0), fk["end"]
        assert (f1["end"]["launches_fused"], f1["end"]["launches_single"]) == (0, n_fixed)
        assert len(fk["losses"]) == len(f1["losses"]) == n_fixed
        cost_err = max(abs(a - b) / abs(b) for a, b in zip(fk["losses"], f1["losses"]))
        assert cost_err <= 1e-6, cost_err
        param_err = max(float(np.max(np.abs(fk["params"][n] - f1["params"][n]))
                              / max(float(np.max(np.abs(f1["params"][n]))), 1e-30))
                        for n in f1["params"])
        assert param_err <= 1e-5, param_err
        assert fk["launches"] == f1["launches"], (fk["launches"], f1["launches"])
        # the groups of 4 the variable-length corpus forms: its batches'
        # shape signatures, replayed on the host
        with in_dir(ws):
            replay = create_data_provider(cfg.data_config, CLI["batch"],
                                          cfg.model_config.input_layer_names, seed=1)
            sigs = [Trainer._shape_sig(b) for b in replay.batches()]
        variable_groups, run = 0, 0
        for i, sig in enumerate(sigs):
            run = run + 1 if i and sig == sigs[i - 1] and run < PL["fuse"] else 1
            variable_groups += run == PL["fuse"]

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            metrics_rc = cli.main(["metrics", os.path.join(tel["dir"], "out")])
        # the pass table: the rows under its header, to the first blank line
        table = out.getvalue().splitlines()
        head = next(i for i, l in enumerate(table) if l.split()[:2] == ["pass", "samples"])
        metrics_rows = []
        for l in table[head + 1:]:
            if not l.strip():
                break
            metrics_rows.append(l.split())
        with open(os.path.join(tel["dir"], "prof", "trace-pass00000.json")) as f:
            trace = json.load(f)
        names = [e.get("name", "") for e in trace.get("traceEvents", [])
                 if e.get("cat") == "kernel"]
        traced = {k: sum(1 for n in names if re.search(sym, n))
                  for k, sym in TRAIN_SYMBOLS.items()}

        # the first step's FLOPs on the CPU, the same batch
        with in_dir(tel["dir"]):
            replay = create_data_provider(cfg.data_config, CLI["batch"],
                                          cfg.model_config.input_layer_names, seed=1)
            first = next(iter(replay.batches()))
        cpu_flops = kernel_flops.train_step_flops(cpu.grad_fn(), params0, first)

    recs = tel["records"]
    for r in recs:
        assert obs.validate_record(r) == [], r
    kinds = [r["kind"] for r in recs]
    assert kinds[-1] == "run_end" and recs[-1]["status"] == "completed", kinds[-3:]
    for kind in ("restart", "train_window", "numerics", "test", "pass_end"):
        assert kind in kinds, kind
    end = tel["end"]
    assert "model_tflops_per_sec" in end and "mfu" in end, end
    flops_err = abs(first_flops[0] - cpu_flops) / cpu_flops
    assert flops_err <= 1e-6, (first_flops, cpu_flops)
    assert all(traced.values()), traced
    assert metrics_rc == 0 and [r[0] for r in metrics_rows] == ["0"], out.getvalue()
    assert tel["stat_dumps"] == 1, tel["stat_dumps"]
    # the batch walls, the profiled batches and the first left out of both
    keep = [i for i in range(len(tel["walls"])) if i + 1 not in window]
    med = {name: 1e3 * statistics.median([fixed[name]["walls"][i] for i in keep])
           for name in ("unfused", "telemetry")}
    mean = {name: 1e3 * statistics.mean(fixed[name]["walls"]) for name in ("fused", "unfused")}
    line = {
        "phase": "pass_loop",
        "config": f"demo/seqToseq train.conf at width {CLI['dim']}, batch {CLI['batch']}, "
                  "real mode, the cli phase's workspace",
        "cuts": {"launch_groups_and_telemetry": f"{PL['fixed_pairs']} pairs of "
                 f"{PL['fixed_len']} + {PL['fixed_len']} words, 1 pass a run",
                 "nonfinite_exit_codes": f"the first {PL['cut_pairs']} train pairs",
                 "test_passes": f"the first {PL['test_pairs']} test pairs"},
        "launch_groups": {
            "batches": n_fixed, "groups": fk["end"]["launches_fused"],
            "loss_reads_per_pass": {"fused": fk["end"]["launches_fused"]
                                    + fk["end"]["launches_single"],
                                    "unfused": f1["end"]["launches_single"]},
            "evaluator_copies_per_pass": fk["evaluator_copies"],
            "cost_max_rel_err": cost_err, "param_max_err_over_scale": param_err,
            # a group's 4 steps are enqueued back to back: its batches' walls
            # are 3 short ones and one long, so the mean compares
            "batch_wall_ms_mean": mean,
            "batch_wall_ms_median_unfused": 1e3 * statistics.median(f1["walls"]),
            "rc_s": {"fused": [fk["rc"], fk["s"]], "unfused": [f1["rc"], f1["s"]]},
            "groups_on_the_variable_length_corpus": variable_groups,
            "variable_length_batches": len(sigs)},
        "accumulation": accumulation,
        "nonfinite": nonfinite, "runs": runs,
        "telemetry": {
            "rc_s": [tel["rc"], tel["s"]], "mfu": end["mfu"],
            "model_tflops_per_sec": end["model_tflops_per_sec"],
            "flops_counted_steps": end.get("flops_counted_steps"),
            "flops_count_ms": end.get("flops_count_ms"),
            "first_step_flops": {"card": first_flops[0], "cpu": cpu_flops, "rel_err": flops_err},
            "batch_wall_ms_median": {"with_numerics": med["telemetry"],
                                     "without": med["unfused"]},
            "numerics_cost_ms_per_batch": med["telemetry"] - med["unfused"],
            "records": len(recs), "kinds": sorted(set(kinds)),
            "numerics_records": kinds.count("numerics"),
            "trace_kernel_events": traced, "metrics_rows": len(metrics_rows),
            "stat_dumps": tel["stat_dumps"], "kernel_launches": tel["launches"]},
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(line)
    return line

def demo_workspace(ws, demo, names, train, test):
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo", demo)
    for name in names:
        shutil.copy(os.path.join(root, name), ws)
    with open(os.path.join(ws, "train.list"), "w") as f:
        f.write(f"{train}\n")
    with open(os.path.join(ws, "test.list"), "w") as f:
        f.write(f"{test}\n")


def cli_train_probed(argv, passes):
    """`train` through the port's command line, watched by a CliProbe:
    (losses, per-pass test results, per-batch walls, wall seconds)."""
    probe = CliProbe()
    try:
        wall = run_cli(argv)
        losses = [float(x) for x in probe.losses]
        walls = host_step_walls(probe.step_t, probe.pass_end, len(losses) // passes)
        return losses, list(probe.tests), walls, wall
    finally:
        probe.close()


def replay_batches(cfg):
    """The train provider's first batch and every batch's rows, replayed on
    the host from the command line's seed (1)."""
    from paddle_tpu_torch.data.feeder import create_data_provider

    replay = create_data_provider(cfg.data_config, cfg.opt_config.batch_size,
                                  cfg.model_config.input_layer_names, seed=1)
    batches = list(replay.batches())
    return batches[0], [next(iter(b.values())).batch_size for b in batches]


def wall_stats(walls, samples, passes):
    """Samples/s over every step but the run's first, and ms a batch."""
    return {"train_samples_per_s": (sum(samples) * passes - samples[0]) / sum(walls),
            "batch_wall_ms_median": 1e3 * statistics.median(walls),
            "batch_wall_ms_p90": 1e3 * float(np.percentile(walls, 90))}


def layers_cnn(torch, dev, ws):
    """quick_start's text CNN: train through the command line, then the
    is_predict=1 (maxid) forward on the card against the CPU."""
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.data.feeder import create_data_provider
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.graph.argument import Argument
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    conf = "trainer_config.cnn.py"
    demo_workspace(ws, "quick_start", ("common.py", "dataprovider_emb.py", conf),
                   "train-seed-1", "test-seed-1")
    cfg = parse_config(conf)
    cpu = GradientMachine(cfg.model_config, device="cpu")
    params0 = cpu.init_params(seed=1)
    init = ckpt.save_checkpoint(os.path.join(ws, "init"), 0, params0)
    first, samples = replay_batches(cfg)
    with torch.no_grad():
        cpu_loss = float(cpu.loss_fn(params0, first, seed=1)[0])
    passes = LAYERS_PASSES
    losses, tests, walls, wall = cli_train_probed(
        ["train", f"--config={conf}", "--save_dir=out", f"--num_passes={passes}",
         f"--init_model_path={init}", "--log_period=0"], passes)
    assert len(losses) == passes * len(samples) and all(np.isfinite(losses)), losses
    costs = [t["cost"] for t in tests]
    assert len(costs) == passes and costs[1] < costs[0], costs
    first_err = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    assert first_err <= TRAIN_TOL, (losses[0], cpu_loss)

    pred = parse_config(conf, "is_predict=1")
    last = os.path.join(ws, "out", ckpt.PASS_FMT % (passes - 1), "params.npz")
    with np.load(last) as z:
        trained = {k: z[k] for k in z.files}
    test_dp = create_data_provider(cfg.test_data_config, cfg.opt_config.batch_size,
                                   cfg.model_config.input_layer_names, seed=1, for_test=True)
    word = next(iter(test_dp.batches()))["word"]
    (name,) = pred.model_config.output_layer_names
    probs_name = [l for l in pred.model_config.layers if l.name == name][0] \
        .inputs[0].input_layer_name
    got = {}
    for where in ("cpu", dev):
        machine = GradientMachine(pred.model_config, device=where)
        params = {k: torch.as_tensor(v, device=machine.device) for k, v in trained.items()}
        batch = {"word": Argument(ids=word.ids.to(machine.device),
                                  seq_lengths=word.seq_lengths.to(machine.device))}
        outs, _ = machine.forward(params, batch, seed=1)
        assert outs[name].ids.device.type == machine.device.type
        got[machine.device.type] = (outs[name].ids.cpu().numpy(),
                                    outs[probs_name].value.cpu().numpy())
    ids_cpu, probs = got["cpu"]
    top2 = np.sort(probs, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    differ = int((got[dev.type][0] != ids_cpu)[clear].sum())
    assert differ == 0 and clear.sum() > 0, (differ, int(clear.sum()))
    return {"part": "quick_start_cnn",
            "config": "demo/quick_start/trainer_config.cnn.py (embedding 32, context_len 3, "
                      "hidden 64, batch 128), train-seed-1 / test-seed-1",
            "passes": passes, "steps": len(losses), "samples_per_pass": sum(samples),
            "first_batch_cost": {"card": losses[0], "cpu": cpu_loss, "rel_err": first_err},
            "test_costs": costs, "test_results": tests, "losses_first_last": [losses[0],
                                                                              losses[-1]],
            **wall_stats(walls, samples, passes), "train_cli_s": wall,
            "predict": {"rows": int(len(ids_cpu)), "clear_margin_rows": int(clear.sum()),
                        "ids_differ_where_clear": differ,
                        "ids_differ_anywhere": int((got[dev.type][0] != ids_cpu).sum()),
                        "class_1_share": float(ids_cpu.mean())}}


def layers_embedding(torch, dev, ws):
    """model_zoo embedding (hsigmoid) through the command line, and the
    JAX test's check on the trained table."""
    import importlib.util

    from paddle_tpu_torch.config import parse_config

    demo_workspace(ws, "model_zoo/embedding", ("common.py", "dataprovider.py",
                                               "trainer_config.py"),
                   "corpus-seed-1", "corpus-seed-2")
    _, samples = replay_batches(parse_config("trainer_config.py"))
    passes = LAYERS_PASSES
    losses, tests, walls, wall = cli_train_probed(
        ["train", "--config=trainer_config.py", "--save_dir=out", f"--num_passes={passes}",
         "--log_period=0"], passes)
    costs = [t["cost"] for t in tests]
    assert losses and all(np.isfinite(losses)), losses[:4]
    assert len(costs) == passes and all(np.isfinite(costs)) and costs[1] < costs[0], costs
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    with np.load(os.path.join(ws, "out", ckpt.PASS_FMT % (passes - 1), "params.npz")) as z:
        emb = z["_emb"]
    spec = importlib.util.spec_from_file_location("embedding_common",
                                                  os.path.join(ws, "common.py"))
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    # tests/test_embedding_demo.py's check: 400 seeded pairs of rows
    norm = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
    within, across = [], []
    rng = np.random.RandomState(0)
    for _ in range(400):
        a, b = rng.randint(0, emb.shape[0], 2)
        sim = float(norm[a] @ norm[b])
        (within if common.cluster_of(a) == common.cluster_of(b) else across).append(sim)
    assert np.mean(within) > np.mean(across) + 0.05, (np.mean(within), np.mean(across))
    return {"part": "embedding",
            "config": "demo/model_zoo/embedding/trainer_config.py (dim 32, batch 256, "
                      "hsigmoid over 200 words), corpus-seed-1 / corpus-seed-2",
            "passes": passes, "steps": len(losses), "test_costs": costs,
            "losses_first_last": [losses[0], losses[-1]], "samples_per_pass": sum(samples),
            **wall_stats(walls, samples, passes), "train_cli_s": wall, "cosine_within": float(np.mean(within)),
            "cosine_across": float(np.mean(across))}


def layers_zoo(torch, dev):
    """Every entry of the layer zoo on the card against the CPU, timed;
    nce's own draws and sampling_id's draws on the card."""
    import scipy.stats

    from paddle_tpu_torch.graph.argument import Argument
    from paddle_tpu_torch.layers import misc
    from paddle_tpu_torch.layers.base import LayerContext, forward_layer
    from paddle_tpu_torch.proto import LayerConfig, LayerInputConfig, ModelConfig
    from paddle_tpu_torch.tools import layer_zoo

    rows = []
    entries = layer_zoo.build()
    for e in entries:
        card, step = layer_zoo.run(e, dev)
        cpu, _ = layer_zoo.run(e, "cpu")
        rep = layer_zoo.compare(e, card, cpu)
        if e.dtype == torch.float64:
            # the float32 readings behind the float64 check, not asserted:
            # the card against the CPU, and the CPU against its float64 result
            e32 = dataclasses.replace(e, dtype=torch.float32)
            cpu32 = layer_zoo.run(e32, "cpu")[0]
            rep["float32_unasserted"] = {
                "card_vs_cpu": layer_zoo.errors(layer_zoo.run(e32, dev)[0], cpu32),
                "cpu_vs_cpu_float64": layer_zoo.errors(cpu32, cpu)}
        rows.append({"name": e.name, "type": e.cfg.type, "size": e.size,
                     "fwd_bwd_ms": time_ms(torch, step, reps=20), **rep})
    # the nce layer drawing its own negatives on the card
    nce = [e for e in entries if e.cfg.type == "nce"][0]
    ctx = LayerContext(params={k: torch.as_tensor(v, device=dev) for k, v in nce.params.items()},
                       model=ModelConfig(), pass_type="train", seed=7)
    args = [Argument(value=torch.as_tensor(nce.inputs[0]["value"], device=dev)),
            Argument(ids=torch.as_tensor(nce.inputs[1]["ids"], device=dev))]
    neg = misc.nce_negatives(nce.cfg, args[0].value.shape[0], ctx, dev)
    cost = forward_layer(nce.cfg, args, ctx).value
    assert neg.device.type == cost.device.type == dev.type
    assert bool(torch.isfinite(cost).all()) and 0 <= int(neg.min()) and \
        int(neg.max()) < nce.cfg.num_classes
    # sampling_id: 10^5 draws on the card against the rows' distribution
    p = np.array([0.05, 0.4, 0.0, 0.25, 0.2, 0.1], np.float32)
    cfg = LayerConfig(name="sid", type="sampling_id", size=1)
    cfg.inputs.append(LayerInputConfig(input_layer_name="p"))
    draws = SAMPLING_DRAWS
    ids = forward_layer(cfg, [Argument(value=torch.as_tensor(np.tile(p, (draws, 1)),
                                                             device=dev))],
                        LayerContext(params={}, model=ModelConfig(), pass_type="gen",
                                     seed=5)).ids
    assert ids.device.type == dev.type
    counts = np.bincount(ids.cpu().numpy(), minlength=len(p))
    keep = p > 0
    chi2 = scipy.stats.chisquare(counts[keep], draws * p[keep].astype(np.float64) /
                                 p[keep].sum())
    assert counts[~keep].sum() == 0 and chi2.pvalue > 1e-3, (counts, chi2.pvalue)
    return {"part": "zoo", "entries": rows, "n_entries": len(rows),
            "types": sorted({r["type"] for r in rows}),
            "sampling_id": {"draws": draws, "counts": counts.tolist(), "p": p.tolist(),
                            "chi2_pvalue": float(chi2.pvalue)},
            "nce_own_draws": {"negatives": list(neg.shape), "cost_mean": float(cost.mean())}}


def phase_layers(torch, dev):
    """The layers phase: the quick_start CNN, the embedding demo, the zoo."""
    import tempfile

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cwd = os.getcwd()
    lines = []
    for part in (layers_cnn, layers_embedding):
        with tempfile.TemporaryDirectory() as ws:
            os.chdir(ws)
            try:
                t0 = time.perf_counter()
                line = part(torch, dev, ws)
                line.update(phase="layers", part_s=time.perf_counter() - t0, card=smi)
            finally:
                os.chdir(cwd)
        emit(line)
        lines.append(line)
    t0 = time.perf_counter()
    line = layers_zoo(torch, dev)
    line.update(phase="layers", part_s=time.perf_counter() - t0, card=smi,
                phase_s=time.perf_counter() - t_phase)
    emit(line)
    lines.append(line)
    return lines


def read_result_file_words(path):
    """A result file with words (gen_dict): [(index line, [(score, [words])])]."""
    blocks = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if "\t" in line:
                score, text = line.split("\t")
                blocks[-1][1].append((float(score), text.split()))
            else:
                blocks.append((line, []))
    return blocks


def phase_train(torch, dev, kernels):
    """The NMT train step on the card: 8 Adam steps through Trainer, the
    launch counts of that run, a B = 4 step against the CPU, a checkpoint
    round trip, and one profiled step."""
    import shutil

    from paddle_tpu_torch.flagship import nmt_batch, nmt_config
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils.flags import _Flags

    tc = nmt_config(vocab=FULL["vocab"], dim=FULL["dim"], batch_size=TRAIN["batch"])
    trainer = Trainer(tc)                             # the card (--use_tpu)
    batch = nmt_batch(vocab=FULL["vocab"], B=TRAIN["batch"], T=TRAIN["T"], seed=1, device=dev)
    target_tokens = int(batch["target_language_word"].seq_lengths.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    losses, step_s = [], []
    for _ in range(TRAIN["steps"]):
        t0 = time.perf_counter()
        loss = trainer.train_one_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches, routes = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    n = TRAIN["steps"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    want = {k.symbol: 0 for k in kernels}
    want.update(gru_fwd_train=2 * n, gru_bwd=2 * n, attention_gru_fwd_train=n,
                attention_gru_bwd=n)
    assert launches == want, (launches, want)
    step_ms = 1e3 * statistics.median(step_s[1:])

    # one B = 4 step on the card against the same step on the CPU
    params_cpu = {k: v.cpu() for k, v in trainer.params.items()}
    small = dict(vocab=FULL["vocab"], B=TRAIN["cpu_batch"], T=TRAIN["T"], seed=2)
    loss_g, grads_g, _, _ = trainer.gm.grad_fn()(trainer.params, nmt_batch(device=dev, **small))
    cpu = GradientMachine(tc.model_config, device="cpu")
    loss_c, grads_c, _, _ = cpu.grad_fn()(params_cpu, nmt_batch(device="cpu", **small))
    loss_err = abs(float(loss_g) - float(loss_c)) / max(1.0, abs(float(loss_c)))
    grad_err = {n_: float((grads_g[n_].cpu() - g).abs().max()) / max(1.0, float(g.abs().max()))
                for n_, g in grads_c.items()}
    assert loss_err <= TRAIN_TOL and max(grad_err.values()) <= TRAIN_TOL, (loss_err, grad_err)

    # pass-00000 saved and restored into a fresh Trainer
    save_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ckpt")
    shutil.rmtree(save_dir, ignore_errors=True)
    trainer.save_dir = save_dir
    path = trainer.save(0)
    fresh = Trainer(tc, _Flags(seed=2))
    fresh.restore(path)
    assert fresh.opt_state.step == trainer.opt_state.step == n
    for name, p in trainer.params.items():
        assert torch.equal(fresh.params[name], p), name
        for slot, v in trainer.opt_state.slots[name].items():
            assert torch.equal(fresh.opt_state.slots[name][slot], v), (name, slot)
    shutil.rmtree(save_dir, ignore_errors=True)

    # a batch of 128-token sources: the decoder route takes kernels 5 and 6
    long_batch = nmt_batch(vocab=FULL["vocab"], B=TRAIN["batch"], T=LONG_TE, seed=3, device=dev)
    zero_counts(kernels)
    long_loss = float(trainer.train_one_batch(long_batch))
    torch.cuda.synchronize()
    long_launches, _ = read_counts(kernels)
    assert np.isfinite(long_loss), long_loss
    assert long_launches["attention_gru_fwd_train"] == long_launches["attention_gru_bwd"] == 1

    train = {"phase": "train", "params": sum(p.numel() for p in trainer.params.values()),
             "batch": TRAIN["batch"], "T": TRAIN["T"], "steps": n,
             "step_ms": step_ms, "step_ms_all": [1e3 * x for x in step_s],
             "target_tokens_per_step": target_tokens,
             "target_tokens_per_s": target_tokens / (step_ms / 1e3),
             "peak_memory_bytes": peak, "losses": losses, "kernel_launches": launches, "eager_routes": routes,
             "cpu_step_loss_rel_err": loss_err, "cpu_step_grad_max_err_over_scale":
             max(grad_err.values()), "checkpoint_roundtrip": "equal",
             "long_source_step": {"T": LONG_TE, "loss": long_loss}}
    emit(train)
    train["profile"] = profiled(torch, "train_profile", lambda: trainer.train_one_batch(batch))[1]
    return train


BF16_TOL = 1e-2            # of max |plain|: a bf16 ulp at the largest magnitude is 2^-8
BF16_LOSS_TOL = dict(rtol=0.05, atol=0.02)   # bf16 against float32 losses (tests/test_bf16.py:74)
# kernel 9 bf16's s and q against Σ|y| and Σy²: the kernel's y may round to
# the other neighbour of the plain y's, one bf16 ulp (2^-8) of an element
CONV_STATS_BF16_TOL = 1e-3
# the LM's B = 2 bf16 step, every gradient against the CPU's at the card's
# gates: bf16 activations that differ by an ulp between the devices carry
# through two blocks and the backward
LM_BF16_GRAD_TOL = 5e-2
BF16_KERNELS = ("gru_fwd_bf16", "gru_fwd_train_bf16", "gru_bwd_bf16",
                "attention_gru_fwd_train_bf16", "attention_gru_bwd_bf16",
                "attention_gru_bwd_bf16_sm90")
# The Hopper bodies of kernels 8 and 6 (lstm_bwd_sm90.cu,
# attention_gru_bwd_sm90.cu) sum dW and dWa from two bf16 pieces of the
# unrounded gradients: held to RECURRENT_SM90_ULPS bf16 spacings (bf16_ulps
# at SM90_CANCEL_FLOOR) of the plain version walked through the kernel's own
# rounded gradients (dx4_forced / dxw_forced; over a sequence two float32
# summation orders round some bf16 gradient the other way and the
# recurrence carries it on), the one-piece control (from the rounded values
# alone) reported beside it
RECURRENT_SM90_ULPS = 2.0
# the bf16 NMT model at a width kernel 6's Hopper body does not take (D no
# multiple of 256): the persistent body on a main path, held to the float32 steps
NMT_D384 = dict(dim=384, steps=2)


def _scale_errs(names, got, want):
    """{output: (max abs error, over max |plain|)} of bf16 results."""
    out = {}
    for name, a, b in zip(names, got, want):
        a, b = a.float(), b.float()
        assert bool(a.isfinite().all()), name
        err = float((a - b).abs().max())
        out[name] = (err, err / max(1e-30, float(b.abs().max())))
    return out


def bf16_kernel_cases(torch, dev):
    """Kernels 1, 2, 3, 5 and 6 in bf16 at the bf16 train and test paths'
    shapes (GRU T = 32, B = 64, H = 512 both ways; attention-GRU Td = Te =
    32, B = 64, D = 512, E = 1024) against their bf16 plain versions, each
    output within BF16_TOL of scale; timed as in phase 2. Bytes count every
    bf16 operand at 2 bytes (the masks of kernels 1-3, m and the float32
    sums of kernel 6 at 4); operations as the float32 rows'."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_gru as fg

    rng = np.random.RandomState(20)
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(
        torch.bfloat16)
    T, B, H = TRAIN["T"], TRAIN["batch"], FULL["dim"]
    x3 = bf(rng.randn(B, T, 3 * H) * 0.5).transpose(0, 1)
    w = bf(rng.randn(H, 3 * H) / np.sqrt(H))
    lens = rng.randint(1, T + 1, B)
    lens[3] = 0
    mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(dev)
    dy = bf(rng.randn(T, B, H))
    cases = {k: {"errors": {}, "timed": []} for k in BF16_KERNELS}
    for reverse in (False, True):
        light = fg.fused_gru(x3, mask, w, reverse=reverse)
        got = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
        ref = fg.gru_forward_reference(x3, mask, w, reverse, residuals=True)
        bwd = fg._launch_bwd(dy, got[1], got[2], mask, w, reverse, fg.KERNEL_ACTS)
        pb = fg.gru_backward_reference(dy, got[1], got[2], mask, w, reverse)
        torch.cuda.synchronize()
        assert torch.equal(light, got[0]), ("gru_fwd_bf16", reverse)
        for name, errs in (("gru_fwd_bf16", _scale_errs(["ys"], [light], ref[:1])),
                           ("gru_fwd_train_bf16", _scale_errs(["ys", "acts", "hprev"], got, ref)),
                           ("gru_bwd_bf16", _scale_errs(["dx3", "dw"], bwd, pb))):
            for out, e in errs.items():
                assert e[1] <= BF16_TOL, (name, reverse, out, e)
                key = f"{out}{'_reversed' if reverse else ''}"
                cases[name]["errors"][key] = {"max_abs_err": e[0], "err_over_scale": e[1]}
        runs = {"gru_fwd_bf16": (lambda: fg.fused_gru(x3, mask, w, reverse=reverse),
                                 lambda: fg.gru_forward_reference(x3, mask, w, reverse)),
                "gru_fwd_train_bf16": (lambda: fg._launch_fwd(x3, mask, w, reverse,
                                                              fg.KERNEL_ACTS, residuals=True),
                                       lambda: fg.gru_forward_reference(
                                           x3, mask, w, reverse, residuals=True)),
                "gru_bwd_bf16": (lambda: fg._launch_bwd(dy, got[1], got[2], mask, w, reverse,
                                                        fg.KERNEL_ACTS),
                                 lambda: fg.gru_backward_reference(dy, got[1], got[2], mask,
                                                                   w, reverse))}
        for name, (run, plain) in runs.items():
            cases[name]["timed"].append({"reverse": reverse, "ms": time_ms(torch, run),
                                         "device_ms": time_ms(torch, run, hide_host=True),
                                         "plain_ms": time_ms(torch, plain, reps=5)})
    fwd_bytes = 2.0 * (T * B * 3 * H + H * 3 * H + T * B * H) + 4.0 * T * B
    gru_flops = T * (6.0 * B * H * H + 14.0 * B * H)
    work = {"gru_fwd_bf16": (fwd_bytes, gru_flops),
            "gru_fwd_train_bf16": (fwd_bytes + 2.0 * T * B * 4 * H, gru_flops),
            "gru_bwd_bf16": (2.0 * (T * B * H + T * B * 3 * H + T * B * H + H * 3 * H
                                    + T * B * 3 * H + H * 3 * H) + 4.0 * T * B,
                             T * (12.0 * B * H * H + 25.0 * B * H))}
    shape = {k: dict(T=T, B=B, H=H) for k in work}

    Td, Te, D, E = TRAIN["T"], FULL["prompt_tokens"], FULL["dim"], 2 * FULL["dim"]
    args, ady = agru_bf16_inputs(torch, dev, rng, Td, Te, B, D, E)
    got = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    ref = fa.attention_gru_reference(*args, residuals=True)
    ys, hprev, saved, alpha, ctxs, m = got
    wa, ba = args[6], args[7]
    torch.cuda.synchronize()
    m_err = float((m - (hprev.float() @ wa.float() + ba.float())).abs().max())
    for out, e in _scale_errs(["ys", "hprev", "acts", "alpha", "ctx"], got[:5], ref).items():
        assert e[1] <= BF16_TOL, ("attention_gru_fwd_train_bf16", out, e)
        cases["attention_gru_fwd_train_bf16"]["errors"][out] = {"max_abs_err": e[0],
                                                                "err_over_scale": e[1]}
    assert m_err <= TOL, ("attention_gru_fwd_train_bf16 m", m_err)
    cases["attention_gru_fwd_train_bf16"]["errors"]["m"] = {"max_abs_err": m_err}
    cases["attention_gru_fwd_train_bf16"]["timed"].append({
        "ms": time_ms(torch, lambda: fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)),
        "device_ms": time_ms(torch, lambda: fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True),
                             hide_host=True),
        "plain_ms": time_ms(torch, lambda: fa.attention_gru_reference(*args, residuals=True),
                            reps=5)})
    weights = D * D + 2 * D + E * 3 * D + D * 3 * D
    att = 2.0 * B * D * D + 4.0 * B * Te * D + 2.0 * B * Te * E
    step_fwd = att + 2.0 * B * E * 3 * D + 6.0 * B * D * D
    work["attention_gru_fwd_train_bf16"] = (
        2.0 * (Te * B * (D + E + 1) + Td * B * (3 * D + 1) + B * D + weights
               + Td * B * (D + D + 3 * D + Te + E)) + 4.0 * Td * B * D,   # ... and m in float32
        Td * step_fwd)
    shape["attention_gru_fwd_train_bf16"] = dict(Td=Td, Te=Te, B=B, D=D, E=E)

    # kernel 6: the Hopper body (the route's choice at the path's shape) here;
    # the persistent body (attention_gru_bwd_bf16) through the route at the
    # shape of its own main path (dim 384, E = 768), and by name here beside
    # the Hopper body (at_main_shape)
    sms = fa.card_sms(dev)
    assert fa.sm90_takes(B, Te, D, E, sms, wa, args[9], args[10], args[1])
    sm90 = agru_bf16_bwd_body(torch, fa._launch_bwd, "attention_gru_bwd_bf16_sm90", args, ady)
    assert sm90["err_ulps"]["dwa"] <= RECURRENT_SM90_ULPS, sm90["err_ulps"]
    D384, E384 = NMT_D384["dim"], 2 * NMT_D384["dim"]
    assert not fa.sm90_takes(B, Te, D384, E384, sms) and fa.supported(B, Te, D384, E384, sms)
    args384, ady384 = agru_bf16_inputs(torch, dev, np.random.RandomState(22), Td, Te, B, D384,
                                       E384)
    old = agru_bf16_bwd_body(torch, fa._launch_bwd, "attention_gru_bwd_bf16", args384, ady384)
    old_main = agru_bf16_bwd_body(torch, fa._launch_bwd_persistent, "attention_gru_bwd_bf16",
                                  args, ady)
    # bounds: the bytes at 2-byte operands and the bf16 rate; the persistent
    # body's design at the float32 FMA rate; the Hopper body's design with
    # its bytes with d_m's two pieces written and read, its products at the
    # bf16 tensor-core rate (dWa's twice), plus its 4 Td barriers at one
    # barrier's time on a grid of its blocks
    nbytes, flops = agru_bf16_bwd_work(Td, Te, B, D, E)
    plan = fa.sm90_plan(B, Te, D, E, sms)
    barrier_us = grid_barrier_us(torch, dev, plan["blocks"], plan["smem_bytes"])
    sm90.update(bytes=nbytes, flops=flops, barrier_us=barrier_us, plan=plan,
                design_bound_ms=bound_bf16(nbytes + 2.0 * 2 * 2 * Td * B * D,
                                           flops + 2.0 * Td * B * D * D)[0]
                + fa.grid_barriers(Td)[1] * barrier_us * 1e-3)
    old_main.update(bound_ms=bound_bf16(nbytes, flops)[0], design_bound_ms=bound(nbytes, flops)[0])
    nbytes, flops = agru_bf16_bwd_work(Td, Te, B, D384, E384)
    old.update(bytes=nbytes, flops=flops, design_bound_ms=bound(nbytes, flops)[0],
               at_main_shape=old_main)
    cases["attention_gru_bwd_bf16"].update(old)
    cases["attention_gru_bwd_bf16_sm90"].update(sm90)
    for k, (nbytes, flops) in work.items():
        cases[k].update(bytes=nbytes, flops=flops, shape=shape[k])
    return cases


def agru_bf16_inputs(torch, dev, rng, Td, Te, B, D, E):
    """Kernels 5 and 6's bf16 operands drawn from ``rng``: (ep, ev, em, xw,
    dmask, h0, wa, ba, v, wctx, wg) with ep and ev batch-major views, one row
    with no encoder position, ragged decoder lengths; and dy."""
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(
        torch.bfloat16)
    r = lambda *s_: bf(rng.randn(*s_) * 0.3)
    elens = rng.randint(1, Te + 1, B)
    elens[3] = 0
    args = [r(B, Te, D).transpose(0, 1), r(B, Te, E).transpose(0, 1),
            bf((np.arange(Te)[:, None] < elens[None, :])[:, :, None]), r(Td, B, 3 * D),
            bf((np.arange(Td)[:, None] < rng.randint(1, Td + 1, B)[None, :])[:, :, None]),
            r(B, D), bf(rng.randn(D, D) / np.sqrt(D)), r(1, D), r(1, D),
            bf(rng.randn(E, 3 * D) / np.sqrt(E)), bf(rng.randn(D, 3 * D) / np.sqrt(D))]
    return args, bf(rng.randn(Td, B, D))


def agru_bf16_bwd_work(Td, Te, B, D, E):
    """Bytes and operations of kernel 6 in bf16: every bf16 operand and
    output at 2 bytes, m and the float32 sums at 4."""
    weights = D * D + 2 * D + E * 3 * D + D * 3 * D
    step_bwd = B * (10.0 * D * D + 6.0 * D * E + 2.0 * Te * E + 8.0 * Te * D)
    return (2.0 * (Td * B * D + Te * B * (D + E) + Td * B + weights - D  # dy, ep, ev, dmask, weights
                   + Td * B * (D + 3 * D + Te)                           # hprev, acts, alpha
                   + Td * B * (3 * D + E) + B * D)                       # dxw, dctx, dh0
            + 4.0 * (Td * B * D + Te * B * D + D * D + 2 * D),           # m; dep, dwa, dba, dv
            Td * step_bwd)


def agru_bf16_bwd_body(torch, launch, symbol, args, ady):
    """Kernel 6 in bf16 through ``launch`` (the route, or a body launched by
    name) on kernel 5's residuals of ``args``: two launches of ``symbol``
    and of no other body, bit-equal; every output within BF16_TOL of scale
    of the bf16 plain version; dWa in bf16 spacings of the plain version
    through the body's own d_din, beside the one-piece control (the
    product from d_m rounded once); timed as in phase 2 (ms, device_ms,
    plain_ms)."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    Te, B, D = args[0].shape
    E, Td = args[1].shape[2], ady.shape[0]
    ys, hprev, saved, alpha, ctxs, m = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    ep, ev, _, _, dmask, _, wa, ba, v, wctx, wg = args
    bargs = (ady, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg)
    before = {k.symbol: k.launches for k in fa.KERNELS}
    kb, kb2 = launch(*bargs), launch(*bargs)
    plain = lambda **kw: fa.attention_gru_backward_reference(
        ady, ep, ev, dmask, hprev, saved, alpha, wa, ba, v, wctx, wg, **kw)
    pb = plain()
    torch.cuda.synchronize()
    ran = {k.symbol: k.launches - before[k.symbol] for k in fa.KERNELS
           if k.launches != before[k.symbol]}
    assert ran == {symbol: 2}, (symbol, ran)
    assert all(torch.equal(a, b) for a, b in zip(kb, kb2)), symbol
    case = {"errors": {}, "bit_equal_launches": True,
            "shape": dict(Td=Td, Te=Te, B=B, D=D, E=E)}
    for out, e in _scale_errs(["dxw", "dctx", "dh0", "dep", "dwa", "dba", "dv"], kb,
                              pb).items():
        assert e[1] <= BF16_TOL, (symbol, out, e)
        case["errors"][out] = {"max_abs_err": e[0], "err_over_scale": e[1]}
    bfl = lambda x: x.to(torch.bfloat16)
    own = plain(dxw_forced=kb[0])[4]
    case["err_ulps"] = {
        "dwa": bf16_ulps(torch, bfl(kb[4]), bfl(own)),
        "one_piece_dwa": bf16_ulps(torch, bfl(plain(dxw_forced=kb[0], dwa_pieces=1)[4]),
                                   bfl(own))}
    case["timed"] = [{"ms": time_ms(torch, lambda: launch(*bargs)),
                      "device_ms": time_ms(torch, lambda: launch(*bargs), hide_host=True),
                      "plain_ms": time_ms(torch, plain, reps=5)}]
    return case


def phase_bf16(torch, dev, kernels, f32_train):
    """The train path in bf16 mixed precision (docstring, 4a): launch counts
    of the bf16 instances, the dtypes of the master state and the islands,
    the losses against the float32 run from the same parameters, a test
    pass, the bf16 kernels against their plain versions, and the step's
    time, device time and memory beside the float32 step's. Returns the
    kernel rows of the bf16 instances."""
    from paddle_tpu_torch.flagship import nmt_batch, nmt_config
    from paddle_tpu_torch.trainer import Trainer

    t_phase = time.perf_counter()
    tc = nmt_config(vocab=FULL["vocab"], dim=FULL["dim"], dtype="bfloat16",
                    batch_size=TRAIN["batch"])
    trainer = Trainer(tc)                             # the train phase's seed: its parameters
    assert trainer.gm.compute_dtype == torch.bfloat16
    batch = nmt_batch(vocab=FULL["vocab"], B=TRAIN["batch"], T=TRAIN["T"], seed=1, device=dev)
    target_tokens = int(batch["target_language_word"].seq_lengths.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    losses, step_s = [], []
    for _ in range(TRAIN["steps"]):
        t0 = time.perf_counter()
        loss = trainer.train_one_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches, routes = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    n = TRAIN["steps"]
    want = {k.symbol: 0 for k in kernels}
    # D = 512: kernel 6's Hopper body, and none of the persistent body
    want.update(gru_fwd_train_bf16=2 * n, gru_bwd_bf16=2 * n, attention_gru_fwd_train_bf16=n,
                attention_gru_bwd_bf16_sm90=n)
    assert launches == want, (launches, want)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, f32_train["losses"], **BF16_LOSS_TOL)
    # the master state float32; a step's gradients float32, its embeddings bf16
    assert all(p.dtype == torch.float32 for p in trainer.params.values())
    slots = [v for s in trainer.opt_state.slots.values() for v in s.values()
             if torch.is_tensor(v) and v.is_floating_point()]
    assert slots and all(v.dtype == torch.float32 for v in slots)
    _, grads, outs, _ = trainer.gm.grad_fn()(trainer.params, batch)
    assert all(g.dtype == torch.float32 for g in grads.values())
    emb = [k for k in outs if "embedding" in k and outs[k].value is not None]
    assert emb and all(outs[k].value.dtype == torch.bfloat16 for k in emb), emb
    del grads, outs
    step_ms = 1e3 * statistics.median(step_s[1:])

    # one test pass: the encoder through kernel 1's bf16 instance
    zero_counts(kernels)
    result = trainer.test_batches([batch])
    torch.cuda.synchronize()
    test_launches, test_routes = read_counts(kernels)
    want_test = {k.symbol: 0 for k in kernels}
    want_test["gru_fwd_bf16"] = 2
    assert test_launches == want_test, (test_launches, want_test)
    assert not any(test_routes.values()), ("eager routes in the bf16 test pass", test_routes)
    assert np.isfinite(result["cost"]), result

    summary = profiled(torch, "bf16_train_profile", lambda: trainer.train_one_batch(batch))[1]
    del trainer

    # the persistent body of kernel 6 on a main path: the model at dim 384, which
    # the Hopper body does not take, held to the same steps in float32
    d384 = lambda dtype: Trainer(nmt_config(vocab=FULL["vocab"], dim=NMT_D384["dim"],
                                            dtype=dtype, batch_size=TRAIN["batch"]))
    n384 = NMT_D384["steps"]
    f32_losses384 = train_steps(torch, dev, kernels, d384("float32"), batch, n384)[0]
    losses384, step384_s, launches384, routes384, _ = train_steps(torch, dev, kernels,
                                                                  d384("bfloat16"), batch, n384)
    want384 = {k.symbol: 0 for k in kernels}
    want384.update(gru_fwd_train_bf16=2 * n384, gru_bwd_bf16=2 * n384,
                   attention_gru_fwd_train_bf16=n384, attention_gru_bwd_bf16=n384)
    assert launches384 == want384, (launches384, want384)
    assert all(np.isfinite(losses384)), losses384
    np.testing.assert_allclose(losses384, f32_losses384, **BF16_LOSS_TOL)
    cases = bf16_kernel_cases(torch, dev)
    f32_ms = f32_train["step_ms"]
    emit({"phase": "bf16", "batch": TRAIN["batch"], "T": TRAIN["T"], "steps": n,
          "losses": losses, "f32_losses": f32_train["losses"],
          "loss_max_rel_diff_vs_f32": max(abs(a - b) / abs(b) for a, b in
                                          zip(losses, f32_train["losses"])),
          "step_ms": step_ms, "f32_step_ms": f32_ms, "step_ms_all": [1e3 * x for x in step_s],
          "target_tokens_per_s": target_tokens / (step_ms / 1e3),
          "f32_target_tokens_per_s": f32_train["target_tokens_per_s"],
          "profile_device_ms": summary["device_ms"],
          "f32_profile_device_ms": f32_train["profile"]["device_ms"],
          "peak_memory_bytes": peak, "f32_peak_memory_bytes": f32_train["peak_memory_bytes"],
          "kernel_launches": {k: v for k, v in launches.items() if v},
          "eager_routes": routes, "test_cost": result["cost"],
          "test_kernel_launches": {k: v for k, v in test_launches.items() if v},
          "test_eager_routes": test_routes,
          "d384": {"dim": NMT_D384["dim"], "steps": n384, "losses": losses384,
                   "f32_losses": f32_losses384, "step_ms": [1e3 * x for x in step384_s],
                   "kernel_launches": {k: v for k, v in launches384.items() if v},
                   "eager_routes": routes384},
          "kernel_errors": {k: c["errors"] for k, c in cases.items()},
          "kernel_err_ulps": {k: c["err_ulps"] for k, c in cases.items() if "err_ulps" in c},
          "seconds": time.perf_counter() - t_phase})
    meta = {"gru_fwd_bf16": ("paddle_tpu_torch/csrc/gru_fwd.cu",
                             "paddle_tpu/ops/pallas_gru.py:75 (_fwd_kernel_light in bf16; "
                             "pallas_call :178)", test_launches),
            "gru_fwd_train_bf16": ("paddle_tpu_torch/csrc/gru_fwd.cu",
                                   "paddle_tpu/ops/pallas_gru.py:57 (_fwd_kernel in bf16; "
                                   "pallas_call :178)", launches),
            "gru_bwd_bf16": ("paddle_tpu_torch/csrc/gru_bwd.cu",
                             "paddle_tpu/ops/pallas_gru.py:91 (_bwd_kernel in bf16; "
                             "pallas_call :206)", launches),
            "attention_gru_fwd_train_bf16": (
                "paddle_tpu_torch/csrc/attention_gru_fwd.cuh",
                "paddle_tpu/ops/pallas_attention_gru.py:199 (_fwd_kernel in bf16; "
                "pallas_call :266)", launches),
            "attention_gru_bwd_bf16": ("paddle_tpu_torch/csrc/attention_gru_bwd.cu",
                                       "paddle_tpu/ops/pallas_attention_gru.py:298 "
                                       "(_bwd_kernel in bf16; pallas_call :415)", launches384),
            "attention_gru_bwd_bf16_sm90": ("paddle_tpu_torch/csrc/attention_gru_bwd_sm90.cu",
                                            "paddle_tpu/ops/pallas_attention_gru.py:298 "
                                            "(_bwd_kernel in bf16; pallas_call :415)",
                                            launches)}
    rows = []
    for name, c in cases.items():
        main_case = c["timed"][0]
        b_ms, b_by = bound_bf16(c["bytes"], c["flops"])
        launched = meta[name][2][name]
        assert launched > 0, name
        sm90 = name == "attention_gru_bwd_bf16_sm90"
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
            "launches": launched,
            "max_abs_err": max(e["max_abs_err"] for e in c["errors"].values()),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            # the design's bound: the persistent bodies widen bf16 on load and
            # multiply in float32 FMA on the CUDA cores; kernel 6's Hopper
            # body multiplies on the bf16 tensor cores (bf16_kernel_cases)
            "design_bound_ms": c.get("design_bound_ms", bound(c["bytes"], c["flops"])[0]),
            "library_ms": None,
            **({"device_ms": main_case["device_ms"]} if "device_ms" in main_case else {}),
            **{key: c[key] for key in ("err_ulps", "bit_equal_launches", "at_main_shape")
               if key in c},
            **({"barrier_us": c["barrier_us"], "plan": c["plan"],
                "body": "Hopper: bf16 mma.sync products, row groups, dWa on the tensor cores"}
               if sm90 else {}),
            "library_note": ("no single PyTorch call computes this function (torch.nn.GRU "
                             "applies the reset gate after the recurrent product, a different "
                             "cell)"),
            "main_path": ("bf16_test" if name == "gru_fwd_bf16" else
                          "bf16_d384_train" if name == "attention_gru_bwd_bf16" else "bf16_train"),
            "operand_dtype": "bfloat16",
            "max_err_over_scale": max(e.get("err_over_scale", 0.0) for e in c["errors"].values()),
            "errors_by_output": c["errors"], "timed": c["timed"],
            "bytes": c["bytes"], "flops": c["flops"], "shape": c["shape"]})
    return rows


def lstm_bytes_flops(T, B, H):
    """Bytes each input read and each output written once, and operations
    (kernel_flops.lstm_fwd_flops / lstm_bwd_flops), of kernels 7a, 7b and 8."""
    light = 4.0 * (T * B * 4 * H + T * B + H * 4 * H + 3 * H + T * B * H)  # x4, mask, w, peep, ys
    residuals = 4.0 * (T * B * 4 * H + 2 * T * B * H)                     # acts, hprev, cprev
    fwd_flops = T * (8.0 * B * H * H + 21.0 * B * H)
    bwd_bytes = 4.0 * (T * B * H + T * B * 4 * H + 2 * T * B * H + T * B + H * 4 * H + 3 * H
                       + T * B * 4 * H + H * 4 * H + 3 * H)   # dy, acts, h/cprev, mask, w, peep; dx4, dw, dpeep
    return {"lstm_fwd": (light, fwd_flops), "lstm_fwd_train": (light + residuals, fwd_flops),
            "lstm_bwd": (bwd_bytes, T * (16.0 * B * H * H + 40.0 * B * H))}


def relu_gate_flips(kernel_acts, plain_acts, H):
    """Where a forward kernel's candidate gate a = relu(ga) opened and the
    plain version's did not, or the other way round (acts [T, B, 4H], a
    first): there ga lies within float32 rounding of 0, |ga| being the
    side's a that opened. Returns their count, that largest |ga| and the
    scale GATE_EPS applies to, the largest a of the plain version."""
    a_k, a_p = kernel_acts[..., :H], plain_acts[..., :H]
    differ = (a_k > 0) != (a_p > 0)
    return {"count": int(differ.sum()),
            "max_abs_pre": float((a_k + a_p)[differ].max()) if differ.any() else 0.0,
            "pre_scale": float(a_p.max())}


def lstm_plain_at_gates(torch, x4, mask, w, peep, reverse, acts, gate):
    """ys of fused_lstm.lstm_forward_reference (the same cell) with the
    candidate's relu(ga) taken as ga * gate[t], the gates a kernel found
    open: autograd through it is the plain version's gradient at the
    kernel's ReLU gates (act_in = relu). The time loop and cell are
    written out here because the gate sits between the candidate's
    pre-activation and c' inside fused_lstm.lstm_cell, which takes the
    activation by name and returns only what follows it; a hook in the
    port's cell for this check alone would be code the port never runs."""
    from paddle_tpu_torch.ops.activations import apply_activation

    T, B, H4 = x4.shape
    H = H4 // 4
    h, c, ys = x4.new_zeros(B, H), x4.new_zeros(B, H), [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = x4[t] + h @ w
        ga, gi, gf, go = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
        i = apply_activation(acts[1], gi + peep[0] * c)
        f = apply_activation(acts[1], gf + peep[1] * c)
        c_new = f * c + i * (ga * gate[t])
        o = apply_activation(acts[1], go + peep[2] * c_new)
        h_new = o * apply_activation(acts[2], c_new)
        m = mask[t][:, None]
        ys[t] = m * h_new
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
    return torch.stack(ys)


def phase_lstm_kernels(torch, dev):
    """Kernels 7a, 7b and 8 at the classifier's full width, forward and
    reversed, default activations and (relu, sigmoid, tanh). With the
    default activations all three are timed (also with the host's enqueue
    hidden) and two launches of each give the same bits; the forwards also
    report their grid and their time with 1, 2 and 4 row groups, and
    kernel 8 with one row group and with run-time activation codes; the forwards and kernel 8 report
    their phase clocks, the barrier timed on their grid and their design
    bound (the bound plus their barriers)."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    rng = np.random.RandomState(3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    T, B, H = LSTM["T"], LSTM["batch"], LSTM["hidden"]
    x4 = t(rng.randn(B, T, 4 * H) * 0.5).transpose(0, 1)    # as the layer passes it
    w = t(rng.randn(H, 4 * H) / np.sqrt(H))
    peep = t(rng.randn(3, H) * 0.1)
    lens = rng.randint(T // 2, T + 1, B)
    lens[5] = 0                                               # one all-masked row
    mask = t(np.arange(T)[:, None] < lens[None, :])
    dy = t(rng.randn(T, B, H))
    plan = fl.grid_plan(B, H, fl.card_sms(dev))
    fplan = fl.fwd_plan(B, H, fl.card_sms(dev))
    cases = {name: [] for name in LSTM_KERNELS}
    for acts in (fl.DEFAULT_ACTS, ("relu", "sigmoid", "tanh")):
        for reverse in (False, True):
            key = {"acts": list(acts), "reverse": reverse}
            light = fl.fused_lstm(x4, mask, w, peep, reverse, acts)
            got = fl._launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)
            ref = fl.lstm_forward_reference(x4, mask, w, peep, reverse, acts, residuals=True)
            torch.cuda.synchronize()
            err = float((light - ref[0]).abs().max())
            assert torch.isfinite(light).all() and err <= TOL, ("lstm_fwd", key, err)
            cases["lstm_fwd"].append({**key, "max_abs_err": err})
            err = _err(got, ref)
            assert all(torch.isfinite(a).all() for a in got) and err <= TOL, ("lstm_fwd_train", key, err)
            cases["lstm_fwd_train"].append({**key, "max_abs_err": err})
            _, saved, hprev, cprev = got
            leaves = [a.detach().requires_grad_() for a in (x4, w, peep)]
            kg = torch.autograd.grad(fl.fused_lstm(*leaves[:1], mask, *leaves[1:], reverse, acts),
                                     leaves, dy)
            plain = [a.detach().requires_grad_() for a in (x4, w, peep)]
            ys_plain = fl.lstm_forward_reference(plain[0], mask, plain[1], plain[2], reverse, acts)
            pg = torch.autograd.grad(ys_plain, plain, dy, retain_graph=True)
            flips = None
            if acts[0] == "relu":
                # a candidate gate within float32 rounding of 0 may open in
                # the kernel and not in the plain version (or the other way
                # round): those must lie within GATE_EPS of 0, and the
                # gradients are then held to the plain version's at the
                # kernel's gates
                flips = relu_gate_flips(saved, ref[1], H)
                assert flips["max_abs_pre"] <= GATE_EPS * flips["pre_scale"], ("lstm_fwd_train", key, flips)
                if flips["count"]:
                    gated = [a.detach().requires_grad_() for a in (x4, w, peep)]
                    pg = torch.autograd.grad(lstm_plain_at_gates(
                        torch, gated[0], mask, gated[1], gated[2], reverse, acts,
                        (saved[..., :H] > 0).float()), gated, dy)
            torch.cuda.synchronize()
            err, rel = _err(kg, pg), _grad_err(kg, pg)
            assert all(torch.isfinite(g).all() for g in kg) and rel <= TOL, ("lstm_bwd", key, rel)
            cases["lstm_bwd"].append({**key, "max_abs_err": err, "err_over_scale": rel,
                                      **({"relu_gate_flips": flips} if flips else {})})
            if acts != fl.DEFAULT_ACTS:
                continue
            # time the default activations, both directions, from a cold L2;
            # two launches of each kernel give the same bits
            for name, res in (("lstm_fwd", False), ("lstm_fwd_train", True)):
                run_fwd = lambda **kw: fl._launch_fwd(x4, mask, w, peep, reverse, acts, res, **kw)
                one, two = run_fwd(), run_fwd()
                torch.cuda.synchronize()
                one, two = (one, two) if res else ((one,), (two,))
                assert all(torch.equal(a, b) for a, b in zip(one, two)), (name, key)
                ms = time_ms(torch, run_fwd)
                cases[name][-1].update(
                    ms=ms, device_ms=time_ms(torch, run_fwd, hide_host=True),
                    plain_ms=time_ms(torch, lambda: fl.lstm_forward_reference(
                        x4, mask, w, peep, reverse, acts, residuals=res), reps=5),
                    per_step_us=1e3 * ms / T, grid_barriers=fl.fwd_barriers(T),
                    blocks=fplan["blocks"], row_groups=fplan["row_groups"],
                    units_per_block=fplan["units_per_block"],
                    smem_bytes_per_block=fplan["smem_bytes"], w_in_smem=bool(fplan["w_in_smem"]))
                if reverse:
                    continue
                # the alternatives, device time: 1, 2 and 4 row groups (128
                # blocks of 4, 8 and 16 units)
                cases[name][-1].update(
                    ms_row_groups={P: time_ms(torch, lambda: run_fwd(row_groups=P),
                                              hide_host=True) for P in (1, 2, 4)})
            bwd_args = (dy, saved, hprev, cprev, mask, w, peep, reverse, acts)
            one, two = fl._launch_bwd(*bwd_args), fl._launch_bwd(*bwd_args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(one, two)), ("lstm_bwd", key)
            run_bwd = lambda **kw: fl._launch_bwd_persistent(*bwd_args, **kw)
            ms = time_ms(torch, run_bwd)
            cases["lstm_bwd"][-1].update(
                ms=ms, device_ms=time_ms(torch, run_bwd, hide_host=True),
                plain_ms=time_ms(torch, lambda: torch.autograd.grad(
                    ys_plain, plain, dy, retain_graph=True), reps=5),
                # the alternatives: one row group (128 blocks of 4 units, all
                # 256 rows each), and the activation codes read at run time
                ms_row_groups_1=time_ms(torch, lambda: run_bwd(row_groups=1), hide_host=True),
                ms_runtime_acts=time_ms(torch, lambda: run_bwd(runtime_acts=True),
                                        hide_host=True),
                per_step_us=1e3 * ms / T, grid_barriers=fl.grid_barriers(T, plan["row_groups"]),
                blocks=plan["blocks"], row_groups=plan["row_groups"],
                units_per_block=fl.UNITS * plan["unit_groups_per_block"],
                smem_bytes_per_block=plan["smem_bytes"], w_in_smem=bool(plan["w_in_smem"]),
                dw_in_smem=bool(plan["dw_in_smem"]))
    emit({"phase": "lstm_kernels", "cases": cases})
    sizes = lstm_bytes_flops(T, B, H)
    out = {name: dict(cases=cases[name], shape=dict(T=T, B=B, H=H),
                      bytes=sizes[name][0], flops=sizes[name][1]) for name in LSTM_KERNELS}
    # where a step of 7b goes: block 0's clock at its product's and cells' ends
    clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
    fl._launch_fwd(x4, mask, w, peep, False, fl.DEFAULT_ACTS, True, phase_ns=clocks)
    torch.cuda.synchronize()
    c = clocks.double().cpu()
    fwd_phases = {"product": float((c[1:, 1] - c[1:, 0]).mean()) / 1e3,
                  "cells": float((c[:, 2] - c[:, 1]).mean()) / 1e3,
                  "barrier": float((c[1:, 0] - c[:-1, 2]).mean()) / 1e3}
    barrier_us = grid_barrier_us(torch, dev, fplan["blocks"], fplan["smem_bytes"])
    for name in ("lstm_fwd", "lstm_fwd_train"):
        out[name].update(barrier_us=barrier_us, phase_us_per_step=fwd_phases,
                         design_bound_ms=bound(*sizes[name])[0]
                         + fl.fwd_barriers(T) * barrier_us * 1e-3)
    # where a step of kernel 8 goes: block 0's clock at its phases' ends
    clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
    fl._launch_bwd(dy, saved, hprev, cprev, mask, w, peep, True, fl.DEFAULT_ACTS,
                   phase_ns=clocks)
    torch.cuda.synchronize()
    spans = (clocks[:, 1:] - clocks[:, :-1]).double().mean(0).cpu().tolist()
    barrier_us = grid_barrier_us(torch, dev, plan["blocks"], plan["smem_bytes"])
    n_bar = fl.grid_barriers(T, plan["row_groups"])
    out["lstm_bwd"].update(
        barrier_us=barrier_us,
        phase_us_per_step=dict(zip(("phase1_and_barrier", "phase2"), (x / 1e3 for x in spans))),
        design_bound_ms=bound(*sizes["lstm_bwd"])[0] + n_bar * barrier_us * 1e-3)
    return out


def lstm_classifier(torch, dev, **opt):
    """Trainer(flagship_config(...)) on the card at LSTM's widths and batch
    size, with the OptimizationConfig fields ``opt``, from the flags' seed
    (so every call starts from the same parameters), and the training batch
    (seed 1)."""
    from paddle_tpu_torch.flagship import example_batch, flagship_config
    from paddle_tpu_torch.trainer import Trainer

    tc = flagship_config(**{k: LSTM[k] for k in ("dict_dim", "emb_dim", "hidden", "classes")})
    tc.opt_config.batch_size = LSTM["batch"]
    for key, value in opt.items():
        setattr(tc.opt_config, key, value)
    trainer = Trainer(tc)
    return trainer, example_batch(LSTM["dict_dim"], B=LSTM["batch"], T=LSTM["T"], seed=1,
                                  device=dev)


def train_steps(torch, dev, kernels, trainer, batch, n):
    """n steps between zeroed counts: (losses, wall seconds a step, launches,
    eager routes, peak bytes from just before the first step)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    losses, step_s = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = trainer.train_one_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches, routes = read_counts(kernels)
    return losses, step_s, launches, routes, torch.cuda.max_memory_allocated(dev)


def phase_lstm_train(torch, dev, kernels):
    """The LSTM classifier's train step on the card: 8 Adam steps through
    Trainer with the launch counts of that run, a B = 4 step against the
    CPU, and one profiled step. Returns the trainer and its batch for the
    test phase, with the training batch's classification_error before the
    steps."""
    from paddle_tpu_torch.flagship import example_batch
    from paddle_tpu_torch.graph import GradientMachine

    trainer, batch = lstm_classifier(torch, dev)      # the card (--use_tpu)
    tc = trainer.config
    err_key = next(e.name for e in tc.model_config.evaluators) + ".classification_error"
    err_before = trainer.test_batches([batch])[err_key]
    n = LSTM["steps"]
    losses, step_s, launches, routes, peak = train_steps(torch, dev, kernels, trainer, batch, n)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    want = {k.symbol: 0 for k in kernels}
    want.update(lstm_fwd_train=n, lstm_bwd=n)
    assert launches == want, (launches, want)
    step_ms = 1e3 * statistics.median(step_s[1:])

    # one B = 4 step on the card against the same step on the CPU
    params_cpu = {k: v.cpu() for k, v in trainer.params.items()}
    small = dict(dict_dim=LSTM["dict_dim"], B=LSTM["cpu_batch"], T=LSTM["T"], seed=2)
    loss_g, grads_g, _, _ = trainer.gm.grad_fn()(trainer.params, example_batch(device=dev, **small))
    cpu = GradientMachine(tc.model_config, device="cpu")
    loss_c, grads_c, _, _ = cpu.grad_fn()(params_cpu, example_batch(device="cpu", **small))
    loss_err = abs(float(loss_g) - float(loss_c)) / max(1.0, abs(float(loss_c)))
    grad_err = {n_: float((grads_g[n_].cpu() - g).abs().max()) / max(1.0, float(g.abs().max()))
                for n_, g in grads_c.items()}
    assert loss_err <= TRAIN_TOL and max(grad_err.values()) <= TRAIN_TOL, (loss_err, grad_err)

    tokens = LSTM["batch"] * LSTM["T"]                    # B * T per step, as bench.py counts
    train = {"phase": "lstm_train", "params": sum(p.numel() for p in trainer.params.values()),
             "batch": LSTM["batch"], "T": LSTM["T"], "steps": n,
             "step_ms": step_ms, "step_ms_all": [1e3 * x for x in step_s],
             "tokens_per_step": tokens, "tokens_per_s": tokens / (step_ms / 1e3),
             "valid_tokens_per_step": int(batch["words"].seq_lengths.sum()),
             "peak_memory_bytes": peak, "losses": losses, "kernel_launches": launches, "eager_routes": routes,
             "cpu_step_loss_rel_err": loss_err,
             "cpu_step_grad_max_err_over_scale": max(grad_err.values())}
    emit(train)
    train["profile_device_ms"] = profiled(
        torch, "lstm_train_profile", lambda: trainer.train_one_batch(batch))[1]["device_ms"]
    return train, trainer, batch, err_key, err_before


def lstm_bf16_bytes(T, B, H):
    """Bytes of kernels 7a, 7b and 8's bf16 instances, each input read and
    each output written once: every bf16 operand at 2 bytes, the mask and
    cprev at 4."""
    light = 2.0 * (T * B * 4 * H + H * 4 * H + 3 * H + T * B * H) + 4.0 * T * B
    residuals = 2.0 * (T * B * 4 * H + T * B * H) + 4.0 * T * B * H      # acts, hprev; cprev
    bwd = (2.0 * (T * B * H + T * B * 4 * H + T * B * H + H * 4 * H + 3 * H    # dy, acts, hprev, w, peep
                  + T * B * 4 * H + H * 4 * H + 3 * H)                       # dx4, dw, dpeep
           + 4.0 * (T * B * H + T * B))                                     # cprev, mask
    return {"lstm_fwd_bf16": light, "lstm_fwd_train_bf16": light + residuals,
            "lstm_bwd_bf16": bwd}


def lstm_bf16_kernel_cases(torch, dev, barrier_us):
    """Kernels 7a, 7b and 8 in bf16 at the bf16 classifier's shape (T = 64,
    B = 256, H = 512, its activations tanh, sigmoid, tanh), both ways,
    against their bf16 plain versions, each output within BF16_TOL of
    scale, two launches of each bit-equal, 7a's ys equal to 7b's; timed as
    in phase 5. Kernel 8's Hopper body through the route here; its
    persistent body through the route at hidden 480 (the shape of its own
    main path) and by name here (at_main_shape). The bound at 2-byte
    operands and the bf16 tensor-core rate (bound_ms); the design's bound
    (design_bound_ms): the forwards' product as one TF32 mma.sync pass (bf16
    operands are exact in TF32), the persistent kernel 8's on the CUDA
    cores' float32 FMAs, each plus its barriers at its grid's measured
    barrier time; the Hopper body's below."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T, B, H = LSTM["T"], LSTM["batch"], LSTM["hidden"]
    acts = ("tanh", "sigmoid", "tanh")
    inputs = lstm_bf16_inputs(torch, dev, np.random.RandomState(21), T, B, H)
    x4, w, peep, mask, dy = inputs
    cases = {k: {"errors": {}, "timed": []} for k in LSTM_BF16_KERNELS}
    for reverse in (False, True):
        light = fl.fused_lstm(x4, mask, w, peep, reverse, acts)
        got = fl._launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)
        again = fl._launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)
        ref = fl.lstm_forward_reference(x4, mask, w, peep, reverse, acts, residuals=True)
        torch.cuda.synchronize()
        assert torch.equal(light, got[0]), ("lstm_fwd_bf16", reverse)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), ("lstm_fwd_train_bf16", reverse)
        assert got[3].dtype == torch.float32 and all(
            a.dtype == torch.bfloat16 for a in (light, *got[:3]))
        for name, errs in (
                ("lstm_fwd_bf16", _scale_errs(["ys"], [light], ref[:1])),
                ("lstm_fwd_train_bf16", _scale_errs(["ys", "acts", "hprev", "cprev"], got, ref))):
            for out, e in errs.items():
                assert e[1] <= BF16_TOL, (name, reverse, out, e)
                key = f"{out}{'_reversed' if reverse else ''}"
                cases[name]["errors"][key] = {"max_abs_err": e[0], "err_over_scale": e[1]}
        runs = {"lstm_fwd_bf16": (lambda: fl._launch_fwd(x4, mask, w, peep, reverse, acts, False),
                                  lambda: fl.lstm_forward_reference(x4, mask, w, peep, reverse,
                                                                    acts)),
                "lstm_fwd_train_bf16": (
                    lambda: fl._launch_fwd(x4, mask, w, peep, reverse, acts, True),
                    lambda: fl.lstm_forward_reference(x4, mask, w, peep, reverse, acts,
                                                      residuals=True))}
        for name, (run, plain) in runs.items():
            cases[name]["timed"].append({"reverse": reverse, "ms": time_ms(torch, run),
                                         "device_ms": time_ms(torch, run, hide_host=True),
                                         "plain_ms": time_ms(torch, plain, reps=5)})
    sms = fl.card_sms(dev)
    assert fl.sm90_takes(B, H, sms)
    sm90 = lstm_bf16_bwd_body(torch, fl._launch_bwd, "lstm_bwd_bf16_sm90", inputs, acts)
    ulps = sm90["err_ulps"]
    assert all(u["dw"] <= RECURRENT_SM90_ULPS for u in ulps.values()), ulps
    H480 = LSTM_H480["hidden"]
    assert not fl.sm90_takes(B, H480, sms) and fl.supported(acts, H480, B, sms)
    old = lstm_bf16_bwd_body(torch, fl._launch_bwd, "lstm_bwd_bf16",
                             lstm_bf16_inputs(torch, dev, np.random.RandomState(22), T, B, H480),
                             acts)
    old_main = lstm_bf16_bwd_body(torch, fl._launch_bwd_persistent, "lstm_bwd_bf16", inputs,
                                  acts)

    sizes = lstm_bytes_flops(T, B, H)
    nbytes = lstm_bf16_bytes(T, B, H)
    # the persistent body's design: float32 FMAs, plus its barriers at its
    # grid's barrier time (at H = 512 the float32 instance's grid)
    P = fl.grid_plan(B, H, sms)["row_groups"]
    old_main.update(bound_ms=bound_bf16(nbytes["lstm_bwd_bf16"], sizes["lstm_bwd"][1])[0],
                    design_bound_ms=bound(nbytes["lstm_bwd_bf16"], sizes["lstm_bwd"][1])[0]
                    + fl.grid_barriers(T, P) * barrier_us["lstm_bwd"] * 1e-3)
    plan480 = fl.grid_plan(B, H480, sms)
    barrier480_us = grid_barrier_us(torch, dev, plan480["blocks"], plan480["smem_bytes"])
    bytes480 = lstm_bf16_bytes(T, B, H480)["lstm_bwd_bf16"]
    flops480 = lstm_bytes_flops(T, B, H480)["lstm_bwd"][1]
    old.update(bytes=bytes480, flops=flops480, barrier_us=barrier480_us,
               design_bound_ms=bound(bytes480, flops480)[0]
               + fl.grid_barriers(T, plan480["row_groups"]) * barrier480_us * 1e-3,
               at_main_shape=old_main)
    # the Hopper body's design bound: its bytes with lo written and read and
    # hi read again, its products at the bf16 tensor-core rate (dW's twice),
    # plus its T barriers at one barrier's time on a grid of its blocks
    plan = fl.sm90_plan(B, H, sms)
    sm90_barrier_us = grid_barrier_us(torch, dev, plan["blocks"], plan["smem_bytes"])
    sm90.update(
        bytes=nbytes["lstm_bwd_bf16"], flops=sizes["lstm_bwd"][1],
        design_bound_ms=bound_bf16(nbytes["lstm_bwd_bf16"] + 3 * 2.0 * T * B * 4 * H,
                                   sizes["lstm_bwd"][1] + 2.0 * T * B * H * 4 * H)[0]
        + T * sm90_barrier_us * 1e-3,
        barrier_us=sm90_barrier_us, plan=plan)
    cases["lstm_bwd_bf16"].update(old)
    cases["lstm_bwd_bf16_sm90"].update(sm90)
    for name, f32 in (("lstm_fwd_bf16", "lstm_fwd"), ("lstm_fwd_train_bf16", "lstm_fwd_train")):
        flops = sizes[f32][1]
        design = (1e3 * max(nbytes[name] / PEAK_BYTES_PER_S, flops / PEAK_TF32_FLOPS)
                  + fl.fwd_barriers(T) * barrier_us[f32] * 1e-3)
        cases[name].update(bytes=nbytes[name], flops=flops, design_bound_ms=design,
                           shape=dict(T=T, B=B, H=H, acts=list(acts)))
    return cases


def lstm_bf16_inputs(torch, dev, rng, T, B, H):
    """Kernels 7a, 7b and 8's bf16 operands drawn from ``rng``: x4 (a
    batch-major view), w, peep, a float32 mask (ragged lengths, row 5
    empty) and dy."""
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(
        torch.bfloat16)
    x4 = bf(rng.randn(B, T, 4 * H) * 0.5).transpose(0, 1)
    w = bf(rng.randn(H, 4 * H) / np.sqrt(H))
    peep = bf(rng.randn(3, H) * 0.1)
    lens = rng.randint(T // 2, T + 1, B)
    lens[5] = 0
    mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(dev)
    return x4, w, peep, mask, bf(rng.randn(T, B, H))


def lstm_bf16_bwd_body(torch, launch, symbol, inputs, acts):
    """Kernel 8 in bf16 through ``launch`` (the route, or a body launched by
    name) on 7b's residuals of ``inputs`` (x4, w, peep, mask, dy), both
    ways: two launches of ``symbol`` a direction and of no other body,
    bf16 and bit-equal; dx4, dW and dpeep within BF16_TOL of scale of the
    bf16 plain version; dW in bf16 spacings of the plain version through
    the body's own dx4, beside the one-piece control (the product from the
    rounded gate gradients alone); timed as in phase 5 (ms, device_ms,
    plain_ms)."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    x4, w, peep, mask, dy = inputs
    T, B, H = dy.shape
    case = {"errors": {}, "err_ulps": {}, "timed": [], "bit_equal_launches": True,
            "shape": dict(T=T, B=B, H=H, acts=list(acts))}
    for reverse in (False, True):
        saved = fl._launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)[1:]
        bargs = (dy, *saved, mask, w, peep, reverse, acts)
        before = {k.symbol: k.launches for k in fl.KERNELS}
        bwd, bwd2 = launch(*bargs), launch(*bargs)
        pb = fl.lstm_backward_reference(*bargs)
        torch.cuda.synchronize()
        ran = {k.symbol: k.launches - before[k.symbol] for k in fl.KERNELS
               if k.launches != before[k.symbol]}
        assert ran == {symbol: 2}, (symbol, ran)
        assert all(a.dtype == torch.bfloat16 for a in bwd), symbol
        assert all(torch.equal(a, b) for a, b in zip(bwd, bwd2)), (symbol, reverse)
        for out, e in _scale_errs(["dx4", "dw", "dpeep"], bwd, pb).items():
            assert e[1] <= BF16_TOL, (symbol, reverse, out, e)
            key = f"{out}{'_reversed' if reverse else ''}"
            case["errors"][key] = {"max_abs_err": e[0], "err_over_scale": e[1]}
        own = fl.lstm_backward_reference(*bargs, dx4_forced=bwd[0])[1]
        one = fl.lstm_backward_reference(*bargs, dw_pieces=1, dx4_forced=bwd[0])[1]
        case["err_ulps"]["reversed" if reverse else "forward"] = {
            "dw": bf16_ulps(torch, bwd[1], own), "one_piece_dw": bf16_ulps(torch, one, own)}
        case["timed"].append({
            "reverse": reverse, "ms": time_ms(torch, lambda: launch(*bargs)),
            "device_ms": time_ms(torch, lambda: launch(*bargs), hide_host=True),
            "plain_ms": time_ms(torch, lambda: fl.lstm_backward_reference(*bargs), reps=5)})
    return case


def phase_lstm_bf16(torch, dev, kernels, f32_train, barrier_us):
    """The LSTM classifier in bf16 mixed precision (docstring, 7a): the
    launches of kernels 7a, 7b and 8's bf16 instances in 8 steps and a test
    pass, the master state float32, the losses against the float32 run
    from the same parameters, a B = 4 step against the CPU's bf16 plain
    versions, the kernels against their plain versions, and the step's
    time, device time, tokens/s and memory beside the float32 step's.
    Returns the kernel rows of the bf16 instances."""
    from paddle_tpu_torch.flagship import example_batch
    from paddle_tpu_torch.graph import GradientMachine

    t_phase = time.perf_counter()
    trainer, batch = lstm_classifier(torch, dev, dtype="bfloat16")
    assert trainer.gm.compute_dtype == torch.bfloat16
    n = LSTM["steps"]
    losses, step_s, launches, routes, peak = train_steps(torch, dev, kernels, trainer, batch, n)
    want = {k.symbol: 0 for k in kernels}
    # H = 512: kernel 8's Hopper body, and none of the persistent body
    want.update(lstm_fwd_train_bf16=n, lstm_bwd_bf16_sm90=n)
    assert launches == want, (launches, want)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, f32_train["losses"], **BF16_LOSS_TOL)
    assert all(p.dtype == torch.float32 for p in trainer.params.values())
    slots = [v for s_ in trainer.opt_state.slots.values() for v in s_.values()
             if torch.is_tensor(v) and v.is_floating_point()]
    assert slots and all(v.dtype == torch.float32 for v in slots)
    step_ms = 1e3 * statistics.median(step_s[1:])

    # the test pass: kernel 7a's bf16 instance once a batch
    batches = [example_batch(LSTM["dict_dim"], B=LSTM["batch"], T=LSTM["T"], seed=10 + i,
                             device=dev) for i in range(LSTM["test_batches"])]
    torch.cuda.synchronize()
    zero_counts(kernels)
    result = trainer.test_batches(batches)
    torch.cuda.synchronize()
    test_launches, test_routes = read_counts(kernels)
    want_test = {k.symbol: 0 for k in kernels}
    want_test["lstm_fwd_bf16"] = LSTM["test_batches"]
    assert test_launches == want_test, (test_launches, want_test)
    assert np.isfinite(result["cost"]), result

    # one B = 4 bf16 step on the card against the CPU's bf16 plain versions
    small = dict(dict_dim=LSTM["dict_dim"], B=LSTM["cpu_batch"], T=LSTM["T"], seed=2)
    loss_g, grads_g, _, _ = trainer.gm.grad_fn()(trainer.params,
                                                 example_batch(device=dev, **small))
    cpu = GradientMachine(trainer.config.model_config, device="cpu", compute_dtype="bfloat16")
    loss_c, grads_c, _, _ = cpu.grad_fn()({k: v.cpu() for k, v in trainer.params.items()},
                                          example_batch(device="cpu", **small))
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_err = {k: float((grads_g[k].cpu() - g).abs().max()) / max(1e-30, float(g.abs().max()))
                for k, g in grads_c.items()}
    assert loss_err <= BF16_TOL and max(grad_err.values()) <= BF16_TOL, (loss_err, grad_err)

    summary = profiled(torch, "lstm_bf16_train_profile",
                       lambda: trainer.train_one_batch(batch))[1]
    # the step's device time from events (the trace lacks kernel 7b's event)
    dev_ms, dev_hidden = step_device_ms(torch, lambda: trainer.train_one_batch(batch))
    del trainer, batches

    # the persistent body of kernel 8 on a main path: the classifier at hidden 480,
    # which the Hopper body does not take, held to the same steps in float32
    def h480(dtype):
        from paddle_tpu_torch.flagship import flagship_config
        from paddle_tpu_torch.trainer import Trainer

        tc = flagship_config(dict_dim=LSTM["dict_dim"], emb_dim=LSTM["emb_dim"],
                             hidden=LSTM_H480["hidden"], classes=LSTM["classes"])
        tc.opt_config.batch_size = LSTM["batch"]
        tc.opt_config.dtype = dtype
        return Trainer(tc)

    n480 = LSTM_H480["steps"]
    f32_losses480 = train_steps(torch, dev, kernels, h480("float32"), batch, n480)[0]
    losses480, step480_s, launches480, routes480, _ = train_steps(torch, dev, kernels,
                                                                  h480("bfloat16"), batch, n480)
    want480 = {k.symbol: 0 for k in kernels}
    want480.update(lstm_fwd_train_bf16=n480, lstm_bwd_bf16=n480)
    assert launches480 == want480, (launches480, want480)
    assert all(np.isfinite(losses480)), losses480
    np.testing.assert_allclose(losses480, f32_losses480, **BF16_LOSS_TOL)
    del batch
    cases = lstm_bf16_kernel_cases(torch, dev, barrier_us)
    tokens = LSTM["batch"] * LSTM["T"]
    emit({"phase": "lstm_bf16", "batch": LSTM["batch"], "T": LSTM["T"], "steps": n,
          "losses": losses, "f32_losses": f32_train["losses"],
          "loss_max_rel_diff_vs_f32": max(abs(a - b) / abs(b) for a, b in
                                          zip(losses, f32_train["losses"])),
          "step_ms": step_ms, "f32_step_ms": f32_train["step_ms"],
          "step_ms_all": [1e3 * x for x in step_s],
          "tokens_per_s": tokens / (step_ms / 1e3), "f32_tokens_per_s": f32_train["tokens_per_s"],
          "profile_device_ms": summary["device_ms"],
          "f32_profile_device_ms": f32_train["profile_device_ms"],
          "step_device_ms": dev_ms, "step_device_host_hidden": dev_hidden,
          "peak_memory_bytes": peak, "f32_peak_memory_bytes": f32_train["peak_memory_bytes"],
          "kernel_launches": {k: v for k, v in launches.items() if v}, "eager_routes": routes,
          "test_cost": result["cost"],
          "test_kernel_launches": {k: v for k, v in test_launches.items() if v},
          "test_eager_routes": test_routes,
          "cpu_step_loss_rel_err": loss_err, "cpu_step_grad_err_over_scale": grad_err,
          "h480": {"hidden": LSTM_H480["hidden"], "steps": n480, "losses": losses480,
                   "f32_losses": f32_losses480, "step_ms": [1e3 * x for x in step480_s],
                   "kernel_launches": {k: v for k, v in launches480.items() if v},
                   "eager_routes": routes480},
          "kernel_errors": {k: c["errors"] for k, c in cases.items()},
          "kernel_err_ulps": {k: c["err_ulps"] for k, c in cases.items() if "err_ulps" in c},
          "seconds": time.perf_counter() - t_phase})
    meta = {"lstm_fwd_bf16": ("paddle_tpu/ops/pallas_lstm.py:179 (_fwd_kernel_light in bf16; "
                              "pallas_call :307)", test_launches, "lstm_bf16_test"),
            "lstm_fwd_train_bf16": ("paddle_tpu/ops/pallas_lstm.py:155 (_fwd_kernel in bf16; "
                                    "pallas_call :307)", launches, "lstm_bf16_train"),
            "lstm_bwd_bf16": ("paddle_tpu/ops/pallas_lstm.py:201 (_bwd_kernel in bf16; "
                              "pallas_call :341)", launches480, "lstm_bf16_h480_train"),
            "lstm_bwd_bf16_sm90": ("paddle_tpu/ops/pallas_lstm.py:201 (_bwd_kernel in bf16; "
                                   "pallas_call :341)", launches, "lstm_bf16_train")}
    rows = []
    for name, c in cases.items():
        main_case = c["timed"][0]
        b_ms, b_by = bound_bf16(c["bytes"], c["flops"])
        launched = meta[name][1][name]
        assert launched > 0, name
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/" + ("lstm_bwd_sm90.cu" if name.endswith("_sm90") else
                                                  "lstm_bwd.cu" if "bwd" in name else
                                                  "lstm_fwd.cu"),
            "replaces": meta[name][0], "launches": launched,
            "max_abs_err": max(e["max_abs_err"] for e in c["errors"].values()),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "design_bound_ms": c["design_bound_ms"],
            "device_ms": main_case["device_ms"], "library_ms": None,
            "library_note": ("no single PyTorch call computes this function (torch.nn.LSTM has "
                             "no peepholes and fixes the activations)"),
            "main_path": meta[name][2], "operand_dtype": "bfloat16",
            "max_err_over_scale": max(e["err_over_scale"] for e in c["errors"].values()),
            **{key: c[key] for key in ("err_ulps", "bit_equal_launches", "barrier_us", "plan",
                                       "at_main_shape") if key in c},
            **({"body": "Hopper: bf16 mma.sync products in 8 row groups, dW off the loop on "
                        "the tensor cores from two bf16 pieces"}
               if name.endswith("_sm90") else {}),
            "errors_by_output": c["errors"], "timed": c["timed"],
            "bytes": c["bytes"], "flops": c["flops"], "shape": c["shape"]})
    return rows


def phase_lstm_remat(torch, dev, kernels, f32_train):
    """remat="full" on the float32 classifier (docstring, 7b): 3 steps from
    the float32 phase's parameters and batch, their losses equal to its
    first three (the recompute is the same forward), kernel 7b twice a step
    and kernel 8 once, and the peak memory beside the plain steps'."""
    trainer, batch = lstm_classifier(torch, dev, remat="full")
    n = LSTM["remat_steps"]
    losses, step_s, launches, routes, peak = train_steps(torch, dev, kernels, trainer, batch, n)
    want = {k.symbol: 0 for k in kernels}
    want.update(lstm_fwd_train=2 * n, lstm_bwd=n)
    assert launches == want, (launches, want)
    plain = f32_train["losses"][:n]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    assert rel <= REMAT_TOL, (losses, plain)
    emit({"phase": "lstm_remat", "steps": n, "losses": losses, "plain_losses": plain,
          "loss_max_rel_diff": rel, "step_ms": 1e3 * statistics.median(step_s[1:]),
          "plain_step_ms": f32_train["step_ms"], "step_ms_all": [1e3 * x for x in step_s],
          "peak_memory_bytes": peak, "plain_peak_memory_bytes": f32_train["peak_memory_bytes"],
          "kernel_launches": {k: v for k, v in launches.items() if v}, "eager_routes": routes})


def phase_lstm_test(torch, dev, kernels, trainer, batch, err_key, err_before):
    """Trainer.test on the card: launches, a B = 4 batch against the CPU,
    and the training batch's classification_error after the steps."""
    from paddle_tpu_torch.flagship import example_batch
    from paddle_tpu_torch.trainer import Trainer

    batches = [example_batch(LSTM["dict_dim"], B=LSTM["batch"], T=LSTM["T"], seed=10 + i,
                             device=dev) for i in range(LSTM["test_batches"])]
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    results = trainer.test_batches(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts(kernels)
    want = {k.symbol: 0 for k in kernels}
    want.update(lstm_fwd=LSTM["test_batches"])
    assert launches == want, (launches, want)
    assert np.isfinite(results["cost"]), results
    _, batch_profile = profiled(torch, "lstm_test_profile", lambda: trainer.test_batches(batches[:1]))

    small = dict(dict_dim=LSTM["dict_dim"], B=LSTM["cpu_batch"], T=LSTM["T"], seed=3)
    on_card = trainer.test_batches([example_batch(device=dev, **small)])
    cpu = Trainer(trainer.config, device="cpu")
    cpu.params = {k: v.cpu() for k, v in trainer.params.items()}
    on_cpu = cpu.test_batches([example_batch(device="cpu", **small)])
    cost_err = abs(on_card["cost"] - on_cpu["cost"]) / abs(on_cpu["cost"])
    assert cost_err <= TOL and on_card[err_key] == on_cpu[err_key], (on_card, on_cpu)

    err_after = trainer.test_batches([batch])[err_key]
    assert err_after <= err_before, (err_before, err_after)
    test = {"phase": "lstm_test", "batches": LSTM["test_batches"], "batch": LSTM["batch"],
            "wall_s": wall, "results": results, "kernel_launches": launches, "eager_routes": routes,
            "batch_device_ms": batch_profile["device_ms"],
            "cpu_cost_rel_err": cost_err, "cpu_classification_error": on_cpu[err_key],
            "train_batch_error_before": err_before, "train_batch_error_after": err_after}
    emit(test)
    return test


def conv_shapes():
    """The (M, K, N) of every 1x1 stride-1 conv of ResNet-50 at the main
    path's batch, with how often each occurs per step."""
    from collections import Counter

    from paddle_tpu_torch.flagship import resnet_config

    tc = resnet_config(RESNET["layer_num"], RESNET["img_size"], RESNET["classes"])
    count = Counter()
    for layer in tc.model_config.layers:
        cc = layer.inputs[0].conv_conf if layer.type == "exconv" else None
        if cc is not None and cc.filter_size == 1 and cc.stride == 1:
            count[(RESNET["batch"] * cc.img_size ** 2, cc.channels, layer.num_filters)] += 1
    assert sum(count.values()) == RESNET["launches_per_step"], count
    return count


def conv_bytes_flops(M, K, N, bias):
    """Bytes each input read and each output written once (x, w, b; y, s,
    q) and operations (the product, the bias, Σy and Σy²) of one launch."""
    nbytes = 4.0 * (M * K + N * K + (N if bias else 0) + M * N + 2 * N)
    return nbytes, 2.0 * M * K * N + (4.0 if bias else 3.0) * M * N


def phase_conv_kernels(torch, dev):
    """Kernel 9 at the nine shapes of the ResNet-50 train step."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    rng = np.random.RandomState(9)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    shapes = conv_shapes()
    cases = []
    for (M, K, N), per_step in sorted(shapes.items()):
        x = t(rng.randn(M, K))
        w = t(rng.randn(N, K) / np.sqrt(K))
        b = t(rng.randn(N) * 0.1)
        for bias in (None, b):
            y, s, q = fc.conv1x1_stats(x, w, bias)
            yr, sr, qr = fc.conv1x1_stats_reference(x, w, bias)
            torch.cuda.synchronize()
            err = float((y - yr).abs().max())
            s_err = float(((s - sr).abs() / yr.abs().sum(0)).max())
            q_err = float(((q - qr).abs() / qr).max())
            key = {"M": M, "K": K, "N": N, "bias": bias is not None}
            assert torch.isfinite(y).all() and err <= TOL, ("conv1x1_stats", key, err)
            assert s_err <= CONV_STATS_TOL and q_err <= CONV_STATS_TOL, (key, s_err, q_err)
            cts = [t(rng.randn(*a.shape)) for a in (y, s, q)]
            ops = (x, w) if bias is None else (x, w, bias)
            leaves = [a.detach().requires_grad_() for a in ops]
            kg = torch.autograd.grad(fc.conv1x1_stats(*leaves), leaves, cts)
            plain = [a.detach().requires_grad_() for a in ops]
            pg = torch.autograd.grad(fc.conv1x1_stats_reference(*plain), plain, cts)
            torch.cuda.synchronize()
            rel = _grad_err(kg, pg)
            assert all(torch.isfinite(g).all() for g in kg) and rel <= TOL, (key, rel)
            del kg, pg, leaves, plain, cts
            case = {**key, "per_step": per_step, "max_abs_err": err, "s_err_over_scale": s_err,
                    "q_err_over_scale": q_err, "grad_err_over_scale": rel}
            if bias is None:                         # ResNet's convs have no bias
                nbytes, flops = conv_bytes_flops(M, K, N, False)
                case.update(
                    ms=time_ms(torch, lambda: fc.conv1x1_stats(x, w)),
                    plain_ms=time_ms(torch, lambda: fc.conv1x1_stats_reference(x, w)),
                    library_ms=time_ms(torch, lambda: torch.addmm(b, x, w.t())),
                    bytes=nbytes, flops=flops, bound_ms=bound(nbytes, flops)[0],
                    bound_tc_ms=bound_tc(nbytes, flops))
                case.update(over_library=case["ms"] / case["library_ms"],
                            over_bound_tc=case["ms"] / case["bound_tc_ms"])
            cases.append(case)
    timed = [c for c in cases if "ms" in c]
    step = lambda k: sum(c[k] * c["per_step"] for c in timed)
    per_step = {k: step(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms")}
    per_step.update(over_library=per_step["ms"] / per_step["library_ms"],
                    over_bound_tc=per_step["ms"] / per_step["bound_tc_ms"])
    emit({"phase": "conv_kernels", "cases": cases, "per_step": per_step})
    return {"conv1x1_stats": dict(
        cases=cases, shape={"per_step": {f"{c['M']}x{c['K']}x{c['N']}": c["per_step"]
                                         for c in timed}},
        bytes=step("bytes"), flops=step("flops"), per_step=per_step)}


def count_copies(rows):
    """Device events of a profiled step that copy or transpose a tensor."""
    keys = ("copy", "transpose", "nchwtonhwc", "nhwctonchw")
    hits = [(n, ms, c) for n, ms, c in rows if any(k in n.lower() for k in keys)]
    return {"events": sum(c for _, _, c in hits), "ms": sum(ms for _, ms, _ in hits),
            "kinds": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in hits]}


def resnet_steps(torch, dev, kernels, mode):
    """8 Momentum steps of ResNet-50 in ``mode``, from seed 1, between
    zeroed counters; returns the trainer, its batch and the run's numbers."""
    from paddle_tpu_torch.flagship import make_image_batch, resnet_config
    from paddle_tpu_torch.trainer import Trainer

    tc = resnet_config(RESNET["layer_num"], RESNET["img_size"], RESNET["classes"])
    tc.opt_config.conv_stats_mode = mode
    trainer = Trainer(tc)                             # the card (--use_tpu)
    batch = make_image_batch(RESNET["batch"], RESNET["img_size"], RESNET["classes"], seed=1,
                             device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    losses, step_s = [], []
    for _ in range(RESNET["steps"]):
        t0 = time.perf_counter()
        loss = trainer.train_one_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches, routes = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], (mode, losses)
    step_ms = 1e3 * statistics.median(step_s[1:])
    return trainer, batch, {
        "conv_stats_mode": mode, "step_ms": step_ms, "step_ms_all": [1e3 * x for x in step_s],
        "images_per_s": RESNET["batch"] / (step_ms / 1e3), "peak_memory_bytes": peak,
        "losses": losses, "kernel_launches": launches, "eager_routes": routes}


def phase_resnet_train(torch, dev, kernels):
    """ResNet-50's train step on the card with kernel 9, a B = 2 step against
    the CPU, a profiled step, then the same steps without kernel 9."""
    from paddle_tpu_torch.flagship import make_image_batch
    from paddle_tpu_torch.graph import Argument, GradientMachine

    trainer, batch, run = resnet_steps(torch, dev, kernels, "pallas")
    n = RESNET["steps"]
    want = {k.symbol: 0 for k in kernels}
    want["conv1x1_stats"] = RESNET["launches_per_step"] * n
    assert run["kernel_launches"] == want, (run["kernel_launches"], want)
    rows, prof = profiled(torch, "resnet_train_profile", lambda: trainer.train_one_batch(batch),
                          top=24)
    copies = count_copies(rows)
    del trainer

    # the parameters that the B = 2 checks below, the test phase and the bf16
    # phase read come from the same 8 steps run again, untimed, on cuDNN's
    # deterministic algorithms: its default ones sum some float32
    # convolution gradients with atomics, so the trained parameters, and the
    # bf16 B = 2 step's loss gap to the CPU with them, change from run to
    # run (0.0045 and 0.0111 against its 1e-2 bound in two runs of one build
    # of this script on an H100); the timed steps above keep the defaults
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainer, _, det = resnet_steps(torch, dev, kernels, "pallas")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert det["kernel_launches"] == want, (det["kernel_launches"], want)

    # one B = 2 step on the card against the same step on the CPU. ResNet-50's
    # float32 gradients are discontinuous at the scale of float32 rounding
    # (rounding carries pre-ReLU values across 0: a 1e-8 relative change of
    # the input moves some float64 gradients by ~3e-3 of their scale), so
    # every gradient is held in float64 (the plain path: kernel 9 takes
    # float32 only), and the float32 "pallas" step's loss and state updates
    # at 1e-3; its gradients may sit no further from the CPU's float64 ones
    # than the CPU's own float32 gradients do (3x, plus 1e-3).
    params_cpu = {k: v.cpu() for k, v in trainer.params.items()}
    cfg = trainer.config.model_config
    small = dict(B=RESNET["cpu_batch"], img_size=RESNET["img_size"],
                 classes=RESNET["classes"], seed=2)

    def step(machine, params, wide):
        batch = make_image_batch(device=machine.device, **small)
        if wide:
            params = {k: v.double() for k, v in params.items()}
            batch["input"] = Argument(value=batch["input"].value.double())
        loss, grads, _, su = machine.grad_fn()(params, batch)
        return float(loss), {k: v.cpu() for k, v in grads.items()}, \
            {k: v.cpu() for k, v in su.items()}

    rel = lambda a, b: float((a.double() - b.double()).abs().max()) / max(
        1.0, float(b.abs().max()))
    gap = lambda a, b: max(rel(a[n_], b[n_]) for n_ in b)
    card32 = step(trainer.gm, trainer.params, False)
    cpu32 = step(GradientMachine(cfg, device="cpu", conv_stats_mode="pallas"), params_cpu, False)
    card64 = step(GradientMachine(cfg, device=dev), trainer.params, True)
    cpu64 = step(GradientMachine(cfg, device="cpu"), params_cpu, True)
    assert sorted(card32[2]) == sorted(cpu32[2]) and len(cpu32[2]) == 106, sorted(cpu32[2])
    rel_loss = lambda a, b: abs(a[0] - b[0]) / max(1.0, abs(b[0]))
    check = {
        "f64_loss_rel_err": rel_loss(card64, cpu64),
        "f64_grad_max_err_over_scale": gap(card64[1], cpu64[1]),
        "f64_state_update_max_err_over_scale": gap(card64[2], cpu64[2]),
        "f32_loss_rel_err": rel_loss(card32, cpu32),
        "f32_state_update_max_err_over_scale": gap(card32[2], cpu32[2]),
        "f32_grad_max_err_over_scale": gap(card32[1], cpu32[1]),
        "f32_card_grad_gap_to_cpu_f64": gap(card32[1], cpu64[1]),
        "f32_cpu_grad_gap_to_cpu_f64": gap(cpu32[1], cpu64[1]),
    }
    assert all(check[k] <= F64_TOL for k in check if k.startswith("f64")), check
    assert check["f32_loss_rel_err"] <= TRAIN_TOL, check
    assert check["f32_state_update_max_err_over_scale"] <= TRAIN_TOL, check
    assert check["f32_card_grad_gap_to_cpu_f64"] <= (
        3.0 * check["f32_cpu_grad_gap_to_cpu_f64"] + TRAIN_TOL), check
    cpu64 = cpu64[:2]                       # the bf16 phase's yardstick: loss and gradients
    del card32, cpu32, card64, trainer
    # the A/B of the fused statistics, in turns after the run above:
    # "", "" (one step of it profiled), "pallas"
    ab = [run]
    for mode in ("", "", "pallas"):
        other, _, again = resnet_steps(torch, dev, kernels, mode)
        want = {k.symbol: 0 for k in kernels}
        want["conv1x1_stats"] = RESNET["launches_per_step"] * n if mode else 0
        assert again["kernel_launches"] == want, (mode, again["kernel_launches"])
        if not mode and len(ab) == 1:
            plain_rows, _ = profiled(torch, "resnet_plain_profile",
                                     lambda: other.train_one_batch(batch), top=24)
        ab.append(again)
        del other
    train = {"phase": "resnet_train", "params": sum(p.numel() for p in params_cpu.values()),
             "batch": RESNET["batch"], "img_size": RESNET["img_size"], "steps": n, **run,
             "launches_per_step": run["kernel_launches"]["conv1x1_stats"] / n,
             "copy_transpose_per_step": copies, "profile_device_ms": prof["device_ms"],
             "cpu_step": check, "check_params_losses": det["losses"],
             "ab_step_ms": [(r["conv_stats_mode"], r["step_ms"]) for r in ab],
             "ab_peak_memory_bytes": [(r["conv_stats_mode"], r["peak_memory_bytes"]) for r in ab],
             "without_kernel9": ab[1],
             "without_kernel9_copy_transpose_per_step": count_copies(plain_rows)}
    emit(train)
    return train, params_cpu, cpu64


def phase_resnet_test(torch, dev, kernels, params_cpu):
    """Trainer.test on the card after the steps: launches, and a B = 2
    batch against the CPU."""
    from paddle_tpu_torch.flagship import make_image_batch, resnet_config
    from paddle_tpu_torch.trainer import Trainer

    tc = resnet_config(RESNET["layer_num"], RESNET["img_size"], RESNET["classes"])
    tc.opt_config.conv_stats_mode = "pallas"
    trainer = Trainer(tc)
    trainer.params = {k: v.to(dev) for k, v in params_cpu.items()}
    shape = dict(img_size=RESNET["img_size"], classes=RESNET["classes"])
    batches = [make_image_batch(RESNET["batch"], seed=20 + i, device=dev, **shape)
               for i in range(RESNET["test_batches"])]
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    results = trainer.test_batches(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts(kernels)
    assert launches == {k.symbol: 0 for k in kernels}, launches
    assert np.isfinite(results["cost"]), results

    small = dict(B=RESNET["cpu_batch"], seed=3, **shape)
    on_card = trainer.test_batches([make_image_batch(device=dev, **small)])
    cpu = Trainer(tc, device="cpu")
    cpu.params = params_cpu
    on_cpu = cpu.test_batches([make_image_batch(device="cpu", **small)])
    err_key = next(e.name for e in tc.model_config.evaluators) + ".classification_error"
    cost_err = abs(on_card["cost"] - on_cpu["cost"]) / abs(on_cpu["cost"])
    assert cost_err <= TOL and on_card[err_key] == on_cpu[err_key], (on_card, on_cpu)
    test = {"phase": "resnet_test", "batches": RESNET["test_batches"], "batch": RESNET["batch"],
            "wall_s": wall, "results": results, "kernel_launches": launches, "eager_routes": routes,
            "cpu_cost_rel_err": cost_err, "cpu_classification_error": on_cpu[err_key]}
    emit(test)
    return test


def conv_bf16_bytes(M, K, N, bias):
    """Bytes of kernel 9's bf16 instance, each input read and each output
    written once: x, w, b and y at 2 bytes, s and q at 4."""
    return 2.0 * (M * K + N * K + (N if bias else 0) + M * N) + 4.0 * 2 * N


def conv_bf16_kernel_cases(torch, dev):
    """Kernel 9's bf16 body at the nine shapes of the ResNet-50 train
    step, with and without a bias, against its bf16 plain version: y within
    BF16_TOL of max |plain|, s and q within 1e-3 of Σ|y| and Σy² (the
    kernel's y may round to a neighbour of the plain y), two launches
    bit-equal. Without the bias (ResNet's convs have none): kernel, plain
    version and torch.addmm in bf16 (the product alone) timed from a cold
    L2, the kernel and addmm also as device time alone (time_ms's
    hide_host: at 4,096 rows the wrapper's host work outlasts the kernel),
    each launch's bound at 2-byte operands and the bf16 rate, and all
    summed over a step's 30 launches."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    rng = np.random.RandomState(22)
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(
        torch.bfloat16)
    cases = []
    for (M, K, N), per_step in sorted(conv_shapes().items()):
        x = bf(rng.randn(M, K))
        w = bf(rng.randn(N, K) / np.sqrt(K))
        b = bf(rng.randn(N) * 0.1)
        for bias in (None, b):
            got = fc.conv1x1_stats(x, w, bias)
            again = fc.conv1x1_stats(x, w, bias)
            yr, sr, qr = fc.conv1x1_stats_reference(x, w, bias)
            torch.cuda.synchronize()
            y, s, q = got
            yf = yr.float()
            err, over = _scale_errs(["y"], [y], [yr])["y"]
            s_err = float(((s - sr).abs() / yf.abs().sum(0)).max())
            q_err = float(((q - qr).abs() / (yf * yf).sum(0)).max())
            key = {"M": M, "K": K, "N": N, "bias": bias is not None}
            assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32, key
            assert over <= BF16_TOL, ("conv1x1_stats_bf16", key, err, over)
            assert s_err <= CONV_STATS_BF16_TOL and q_err <= CONV_STATS_BF16_TOL, (
                key, s_err, q_err)
            assert all(torch.equal(a, r) for a, r in zip(got, again)), key
            case = {**key, "per_step": per_step, "max_abs_err": err, "err_over_scale": over,
                    "s_err_over_scale": s_err, "q_err_over_scale": q_err}
            if bias is None:
                nbytes, flops = conv_bf16_bytes(M, K, N, False), conv_bytes_flops(M, K, N, False)[1]
                case.update(
                    ms=time_ms(torch, lambda: fc.conv1x1_stats(x, w)),
                    device_ms=time_ms(torch, lambda: fc.conv1x1_stats(x, w), hide_host=True),
                    plain_ms=time_ms(torch, lambda: fc.conv1x1_stats_reference(x, w)),
                    library_ms=time_ms(torch, lambda: torch.addmm(b, x, w.t())),
                    library_device_ms=time_ms(torch, lambda: torch.addmm(b, x, w.t()),
                                              hide_host=True),
                    bytes=nbytes, flops=flops, bound_ms=bound_bf16(nbytes, flops)[0],
                    bound_by=bound_bf16(nbytes, flops)[1])
                case.update(over_library=case["ms"] / case["library_ms"],
                            over_bound=case["ms"] / case["bound_ms"],
                            device_over_library=case["device_ms"] / case["library_device_ms"])
            cases.append(case)
            del got, again, yr, sr, qr, y, s, q, yf
        del x, w, b
    timed = [c for c in cases if "ms" in c]
    step = lambda k: sum(c[k] * c["per_step"] for c in timed)
    per_step = {k: step(k) for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                     "library_device_ms", "bound_ms", "bytes", "flops")}
    per_step.update(over_library=per_step["ms"] / per_step["library_ms"],
                    over_bound=per_step["ms"] / per_step["bound_ms"],
                    device_over_library=per_step["device_ms"] / per_step["library_device_ms"])
    return {"cases": cases, "per_step": per_step,
            "shape": {"per_step": {f"{c['M']}x{c['K']}x{c['N']}": c["per_step"] for c in timed}}}


def phase_resnet_bf16(torch, dev, kernels, f32_train, f32_test, params_cpu, cpu64):
    """ResNet-50 in bf16 mixed precision (docstring, 10a): 8 Momentum steps
    from the float32 phase's initial parameters and batch, a test pass and
    a B = 2 bf16 step at the float32 phase's trained parameters against
    the CPU, kernel 9's bf16 instance against its plain version, and the
    step's time, device time, images/s and memory beside the float32
    step's. Returns the kernel row of conv1x1_stats_bf16."""
    from paddle_tpu_torch.flagship import make_image_batch, resnet_config
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.trainer import Trainer

    t_phase = time.perf_counter()
    tc = resnet_config(RESNET["layer_num"], RESNET["img_size"], RESNET["classes"])
    tc.opt_config.conv_stats_mode = "pallas"
    tc.opt_config.dtype = "bfloat16"
    trainer = Trainer(tc)                             # the float32 phase's seed: its parameters
    assert trainer.gm.compute_dtype == torch.bfloat16
    shape = dict(img_size=RESNET["img_size"], classes=RESNET["classes"])

    # the bf16 curve of the card against the CPU's bf16 plain versions, from
    # the same initial parameters, at a cut batch (the CPU's time)
    cpu = Trainer(tc, device="cpu")
    cpu.params = {k: v.cpu() for k, v in trainer.params.items()}
    cpu.opt_state = cpu.updater.init_state(cpu.params)
    card = Trainer(tc)
    cut = dict(B=RESNET["curve_batch"], seed=3, **shape)
    card_curve = [float(card.train_one_batch(make_image_batch(device=dev, **cut)))
                  for _ in range(RESNET["steps"])]
    cpu_curve = [float(cpu.train_one_batch(make_image_batch(device="cpu", **cut)))
                 for _ in range(RESNET["steps"])]
    np.testing.assert_allclose(card_curve, cpu_curve, **BF16_LOSS_TOL)
    del card, cpu

    batch = make_image_batch(RESNET["batch"], seed=1, device=dev, **shape)
    n = RESNET["steps"]
    losses, step_s, launches, routes, peak = train_steps(torch, dev, kernels, trainer, batch, n)
    want = {k.symbol: 0 for k in kernels}
    want["conv1x1_stats_bf16"] = RESNET["launches_per_step"] * n
    assert launches == want, (launches, want)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    # the first loss (the same parameters and batch, no update yet) within
    # the bf16 bound of float32's; after it ResNet-50's bf16 curve leaves
    # float32's in the JAX package too (its gradients at these parameters
    # are ill-conditioned: bf16 rounding moves them by O(1) of their norm),
    # so the curve is held against the CPU's bf16 one above and reported
    # beside float32's
    np.testing.assert_allclose(losses[0], f32_train["losses"][0], **BF16_LOSS_TOL)
    assert all(p.dtype == torch.float32 for p in trainer.params.values())
    slots = [v for s_ in trainer.opt_state.slots.values() for v in s_.values()
             if torch.is_tensor(v) and v.is_floating_point()]
    assert slots and all(v.dtype == torch.float32 for v in slots)
    step_ms = 1e3 * statistics.median(step_s[1:])
    summary = profiled(torch, "resnet_bf16_train_profile",
                       lambda: trainer.train_one_batch(batch), top=24)[1]
    del batch

    # the test pass at the float32 test's parameters and batches: no launch
    trainer.params = {k: v.to(dev) for k, v in params_cpu.items()}
    batches = [make_image_batch(RESNET["batch"], seed=20 + i, device=dev, **shape)
               for i in range(RESNET["test_batches"])]
    torch.cuda.synchronize()
    zero_counts(kernels)
    result = trainer.test_batches(batches)
    torch.cuda.synchronize()
    test_launches, test_routes = read_counts(kernels)
    assert test_launches == {k.symbol: 0 for k in kernels}, test_launches
    assert np.isfinite(result["cost"]), result
    np.testing.assert_allclose(result["cost"], f32_test["results"]["cost"], **BF16_LOSS_TOL)
    del batches

    # one B = 2 bf16 step on the card against the CPU's bf16 plain versions,
    # at the float32 phase's trained parameters: the loss within BF16_TOL,
    # each gradient no further from the CPU's float64 one (the float32
    # phase's) than 3x the CPU's own bf16 gradient is, plus BF16_TOL of scale
    small = dict(B=RESNET["cpu_batch"], seed=2, **shape)
    loss_g, grads_g, _, _ = trainer.gm.grad_fn()(trainer.params,
                                                 make_image_batch(device=dev, **small))
    cpu = GradientMachine(tc.model_config, device="cpu", conv_stats_mode="pallas",
                          compute_dtype="bfloat16")
    loss_c, grads_c, _, _ = cpu.grad_fn()(params_cpu, make_image_batch(device="cpu", **small))
    loss64, grads64 = cpu64
    rel = lambda a, b_: float((a.double().cpu() - b_).abs().max()) / max(
        1e-30, float(b_.abs().max()))
    card_gap = {k: rel(grads_g[k], g) for k, g in grads64.items()}
    cpu_gap = {k: rel(grads_c[k], g) for k, g in grads64.items()}
    check = {"loss_rel_err": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
             "card_loss_rel_err_to_cpu_f64": abs(float(loss_g) - loss64) / abs(loss64),
             "card_grad_gap_to_cpu_f64_max": max(card_gap.values()),
             "cpu_bf16_grad_gap_to_cpu_f64_max": max(cpu_gap.values()),
             "worst_over_allowance": max(card_gap[k] - (3.0 * cpu_gap[k] + BF16_TOL)
                                         for k in grads64)}
    assert check["loss_rel_err"] <= BF16_TOL, check
    assert check["worst_over_allowance"] <= 0.0, check
    del grads_g, grads_c, cpu

    del trainer
    cases = conv_bf16_kernel_cases(torch, dev)
    emit({"phase": "resnet_bf16", "batch": RESNET["batch"], "img_size": RESNET["img_size"],
          "steps": n, "losses": losses, "f32_losses": f32_train["losses"],
          "loss_max_rel_diff_vs_f32": max(abs(a - b_) / abs(b_) for a, b_ in
                                          zip(losses, f32_train["losses"])),
          "curve_batch": RESNET["curve_batch"], "card_curve": card_curve,
          "cpu_curve": cpu_curve,
          "curve_max_rel_diff_vs_cpu": max(abs(a - b_) / abs(b_) for a, b_ in
                                           zip(card_curve, cpu_curve)),
          "step_ms": step_ms, "f32_step_ms": f32_train["step_ms"],
          "step_ms_all": [1e3 * x for x in step_s],
          "images_per_s": RESNET["batch"] / (step_ms / 1e3),
          "f32_images_per_s": f32_train["images_per_s"],
          "profile_device_ms": summary["device_ms"],
          "f32_profile_device_ms": f32_train["profile_device_ms"],
          "peak_memory_bytes": peak, "f32_peak_memory_bytes": f32_train["peak_memory_bytes"],
          "kernel_launches": {k: v for k, v in launches.items() if v}, "eager_routes": routes,
          "test_cost": result["cost"], "f32_test_cost": f32_test["results"]["cost"],
          "test_kernel_launches": {k: v for k, v in test_launches.items() if v},
          "test_eager_routes": test_routes, "cpu_step": check,
          "kernel_cases": cases["cases"], "kernel_per_step": cases["per_step"],
          "seconds": time.perf_counter() - t_phase})
    ps = cases["per_step"]
    return [{
        "name": "conv1x1_stats_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv1x1_bn.cu",
        "replaces": "paddle_tpu/ops/pallas_conv1x1_bn.py:115 (_kernel in bf16; pallas_call :159)",
        "launches": launches["conv1x1_stats_bf16"],
        "max_abs_err": max(c["max_abs_err"] for c in cases["cases"]),
        "ms": ps["ms"], "plain_ms": ps["plain_ms"],
        "bound_ms": ps["bound_ms"], "bound_by": bound_bf16(ps["bytes"], ps["flops"])[1],
        "bound_bf16_ms": ps["bound_ms"],
        # the design: one bf16 wgmma pass at the bf16 rate, so its bound is bound_bf16
        "design_bound_ms": ps["bound_ms"], "library_ms": ps["library_ms"],
        "library_note": ("torch.addmm(b, x, w.t()) in bf16 at each shape, summed over a step's "
                         "30 launches: the product alone, since no single PyTorch call also "
                         "returns the column statistics"),
        "main_path": "resnet_bf16_train", "operand_dtype": "bfloat16",
        "max_err_over_scale": max(c["err_over_scale"] for c in cases["cases"]),
        "max_stats_err_over_scale": max(max(c["s_err_over_scale"], c["q_err_over_scale"])
                                        for c in cases["cases"]),
        "bytes": ps["bytes"], "flops": ps["flops"], "shape": cases["shape"],
        "timed_over": "one train step (30 launches)",
        "body": ("Hopper: one float32 wgmma accumulator over K with a group in flight, a "
                 "loading warp, y staged in bf16 and stored by TMA"),
        "device_ms": ps["device_ms"], "library_device_ms": ps["library_device_ms"],
        "per_shape": {f"{c['M']}x{c['K']}x{c['N']}": {
            k: c[k] for k in ("per_step", "ms", "device_ms", "library_ms", "library_device_ms",
                              "bound_ms", "bound_by", "over_library", "over_bound")}
            for c in cases["cases"] if "ms" in c},
        "launches_per_step": launches["conv1x1_stats_bf16"] / n}]


def visible_pairs(lens, T, causal, H):
    """(query, key) pairs the mask lets through, over every batch row and head."""
    L = np.minimum(np.maximum(np.asarray(lens, np.int64), 0), T)
    per_row = L * (L + 1) // 2 + (T - L) * L if causal else T * L
    return int(H * per_row.sum())


def attn_bytes_flops(B, T, H, D, pairs):
    """Bytes each input read and each output written once, and operations
    (2 per multiply-add of the products over the visible pairs: q.k and p.v
    forward; q.k, dout.v and ds.k for dq; q.k, dout.v, p^T.dout and ds^T.q
    for dk, dv) of kernels 10, 11 and 12."""
    x, stat = 4.0 * B * T * H * D, 4.0 * B * H * T
    return {"flash_attn_fwd": (4 * x + stat + 4 * B, 4.0 * pairs * D),      # q, k, v; out, lse
            "flash_attn_dq": (5 * x + 2 * stat + 4 * B, 6.0 * pairs * D),   # + dout, delta; dq
            "flash_attn_dkv": (6 * x + 2 * stat + 4 * B, 8.0 * pairs * D)}  # ...; dk, dv


def phase_attn_kernels(torch, dev):
    """Kernels 10, 11 and 12 against their plain versions at the LM's shape
    and four others; timings at the LM's shape."""
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(10)
    B, T, H, D = LM["batch"], LM["seq_len"], LM["heads"], LM["dim"] // LM["heads"]
    cases = [dict(B=B, T=T, H=H, D=D, causal=True, ragged=False),
             dict(B=B, T=T, H=H, D=D, causal=False, ragged=True),
             dict(B=2, T=1000, H=4, D=64, causal=True, ragged=True),
             dict(B=4, T=1024, H=8, D=32, causal=True, ragged=True),
             dict(B=2, T=1024, H=4, D=128, causal=True, ragged=True),
             dict(B=2, T=1024, H=4, D=256, causal=True, ragged=True),
             dict(B=2, T=1000, H=4, D=40, causal=False, ragged=True)]
    out_cases = {name: [] for name in ATTN_KERNELS}
    sizes = None
    for i, c in enumerate(cases):
        b, t, h, d = c["B"], c["T"], c["H"], c["D"]
        qkv = torch.from_numpy(rng.randn(b, t, 3, h, d).astype(np.float32)).to(dev)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]     # as the layer passes them
        do = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(dev)
        lens = rng.randint(2, t + 1, b) if c["ragged"] else np.full(b, t)
        if c["ragged"]:
            lens[1 % b], lens[-1] = 1, 0
        lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
        causal = c["causal"]
        key = {**c, "lengths": lens.tolist() if c["ragged"] else "full"}

        out, lse = fa._launch_fwd(q, k, v, lengths, causal, True)
        light, _ = fa._launch_fwd(q, k, v, lengths, causal, False)
        ref, ref_lse = fa.flash_forward_reference(q, k, v, lengths, causal)
        torch.cuda.synchronize()
        seen = lengths > 0
        err = float((out - ref).abs().max())
        lse_err = float((lse - ref_lse)[seen].abs().max())
        scale = max(1.0, float(ref.abs().max()))
        assert torch.isfinite(out).all() and err <= TOL * scale, (key, err)
        assert lse_err <= TOL and bool((lse[~seen] == -1e30).all()), (key, lse_err)
        assert torch.equal(light, out), key
        out_cases["flash_attn_fwd"].append({**key, "max_abs_err": err, "lse_max_abs_err": lse_err})

        delta = torch.sum(do * ref, dim=-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, ref_lse, delta, lengths, causal)
        dq, (dk, dv) = fa._launch_dq(*args), fa._launch_dkv(*args)
        dq2, (dk2, dv2) = fa._launch_dq(*args), fa._launch_dkv(*args)
        want = (fa.flash_dq_reference(*args),) + fa.flash_dkv_reference(*args)
        torch.cuda.synchronize()
        same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
        assert same, ("flash backward not deterministic", key)
        errs = [float((a - w).abs().max()) for a, w in zip((dq, dk, dv), want)]
        rel = [e / max(1.0, float(w.abs().max())) for e, w in zip(errs, want)]
        assert all(torch.isfinite(a).all() for a in (dq, dk, dv)) and max(rel) <= TOL, (key, rel)
        out_cases["flash_attn_dq"].append({**key, "max_abs_err": errs[0],
                                           "err_over_scale": rel[0], "bit_equal_launches": same})
        out_cases["flash_attn_dkv"].append({**key, "max_abs_err": max(errs[1:]),
                                            "err_over_scale": max(rel[1:]),
                                            "bit_equal_launches": same})
        del ref, want, dq2, dk2, dv2
        if i:
            continue
        # the LM's shape: kernel, plain version and PyTorch's attention
        sizes = attn_bytes_flops(b, t, h, d, visible_pairs(lens, t, causal, h))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = [a.transpose(1, 2).contiguous().requires_grad_() for a in (q, k, v)]
        lib_out = sdpa(*lib, is_causal=True)
        lib_do = do.transpose(1, 2).contiguous()
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(lib_out, lib, lib_do,
                                                                retain_graph=True))
        fwd = out_cases["flash_attn_fwd"][-1]
        fwd.update(
            ms=time_ms(torch, lambda: fa._launch_fwd(q, k, v, lengths, causal, True)),
            light_ms=time_ms(torch, lambda: fa._launch_fwd(q, k, v, lengths, causal, False)),
            plain_ms=time_ms(torch, lambda: fa.flash_forward_reference(q, k, v, lengths, causal),
                             reps=5),
            library_ms=time_ms(torch, lambda: sdpa(*lib, is_causal=True)),
            bound_tc_ms=bound_tc(*sizes["flash_attn_fwd"]))
        fwd.update(over_library=fwd["ms"] / fwd["library_ms"],
                   over_bound_tc=fwd["ms"] / fwd["bound_tc_ms"])
        out_cases["flash_attn_dq"][-1].update(
            ms=time_ms(torch, lambda: fa._launch_dq(*args)),
            plain_ms=time_ms(torch, lambda: fa.flash_dq_reference(*args), reps=5),
            library_ms=lib_bwd_ms)
        out_cases["flash_attn_dkv"][-1].update(
            ms=time_ms(torch, lambda: fa._launch_dkv(*args)),
            plain_ms=time_ms(torch, lambda: fa.flash_dkv_reference(*args), reps=5),
            library_ms=lib_bwd_ms)
        del lib, lib_out, lib_do
    emit({"phase": "attn_kernels", "cases": out_cases})
    shape = {k_: cases[0][k_] for k_ in ("B", "T", "H", "D", "causal")}
    return {name: dict(cases=out_cases[name], shape=shape, bytes=sizes[name][0],
                       flops=sizes[name][1]) for name in ATTN_KERNELS}


FAMILIES = (("flash attention (kernels 10-12)", ("flash_",)),
            ("products (cuBLAS)", ("gemm", "cutlass", "xmma", "gemv", "nvjet")),
            ("reductions (softmax, cross-entropy, sums)", ("reduce", "softmax")),
            ("copies and fills", ("copy", "memcpy", "memset", "fill", "transpose", "cat")),
            ("elementwise (activations, residuals, Adam)", ("",)))


def by_family(rows):
    """Device ms and events of a profile's rows, summed by kernel family."""
    out = {name: {"ms": 0.0, "count": 0} for name, _ in FAMILIES}
    for n, ms, c in rows:
        name = next(f for f, keys in FAMILIES if any(k in n.lower() for k in keys))
        out[name]["ms"] += ms
        out[name]["count"] += c
    return out


def lm_cpu_step(trainer, params_cpu, tc):
    """A B = 2, T = 256 step on the card against the same step on the CPU.

    The loss is held to TRAIN_TOL. The gradients cannot always be: a ReLU
    gate of an FFN whose pre-activation lies within float32 rounding of 0
    (|x| ~ 1e-8 among 10^6 of them) opens on one device and stays shut on
    the other, which moves that unit's bias gradient by one token's
    gradient, ~1% of scale, and the CPU's own float32 step differs from its
    float64 one the same way. So the gates on which the card and the CPU in
    float64 disagree must all lie within GATE_EPS of 0 (of the largest
    |pre-activation|), and every gradient is held to TRAIN_TOL against the
    CPU's float64 step taken with the card's gates. The plain comparisons,
    card and CPU float32 against the CPU in float64, are reported."""
    import torch

    from paddle_tpu_torch.flagship import lm_batch
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.layers import core

    small = dict(vocab=LM["vocab"], B=LM["cpu_batch"], T=LM["cpu_T"], seed=2)
    loss_g, grads_g, outs_g, _ = trainer.gm.grad_fn()(
        trainer.params, lm_batch(device=trainer.device, **small))
    relu = [l.name for l in tc.model_config.layers if l.active_type == "relu"]   # the FFNs
    gates = {n: outs_g[n].value.detach().cpu() > 0 for n in relu}
    cpu = GradientMachine(tc.model_config, device="cpu")
    batch = lm_batch(device="cpu", **small)
    p64 = {k: v.double() for k, v in params_cpu.items()}
    loss32, grads32, _, _ = cpu.grad_fn()(params_cpu, batch)
    loss64, grads64, outs64, _ = cpu.grad_fn()(p64, batch)

    finalize = core.finalize_output

    def card_gates(cfg, value, ctx, mask=None):     # relu(x) = x * [x > 0], the card's [.]
        if cfg.name not in gates:
            return finalize(cfg, value, ctx, mask)
        return (value + ctx.param(cfg.bias_parameter_name)) * gates[cfg.name].double()

    core.finalize_output = card_gates
    try:
        _, grads_gated, _, _ = cpu.grad_fn()(p64, batch)
    finally:
        core.finalize_output = finalize
    source = {l.name: l.inputs[0].input_layer_name for l in tc.model_config.layers if l.inputs}
    flips = {}
    for n in relu:
        pre = outs64[source[n]].value.detach() @ p64[f"_{n}.w0"] + p64[f"_{n}.wbias"]
        differ = gates[n] != (pre > 0)
        flips[n] = {"count": int(differ.sum()),
                    "max_abs_pre": float(pre[differ].abs().max()) if differ.any() else 0.0,
                    "pre_scale": float(pre.abs().max())}
    rel = lambda a, b: float((a.double().cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))
    gap = lambda got, want: max(rel(got[n_], want[n_]) for n_ in want)
    check = {"loss_rel_err": abs(float(loss_g) - float(loss64)) / max(1.0, abs(float(loss64))),
             "grad_max_err_over_scale_same_gates": gap(grads_g, grads_gated),
             "gate_flips": flips,
             "card_grad_gap_to_cpu_f64": gap(grads_g, grads64),
             "cpu_f32_grad_gap_to_cpu_f64": gap(grads32, grads64),
             "card_grad_gap_to_cpu_f32": gap(grads_g, grads32)}
    assert check["loss_rel_err"] <= TRAIN_TOL, check
    assert all(f["max_abs_pre"] <= GATE_EPS * f["pre_scale"] for f in flips.values()), check
    assert check["grad_max_err_over_scale_same_gates"] <= TRAIN_TOL, check
    return check


def phase_lm_train(torch, dev, kernels):
    """The long-context LM's train step on the card: 8 Adam steps through
    Trainer with the launch counts of that run, a B = 2, T = 256 step
    against the CPU, and one profiled step."""
    from paddle_tpu_torch.flagship import lm_batch, long_context_config
    from paddle_tpu_torch.trainer import Trainer

    tc = long_context_config(vocab=LM["vocab"], seq_len=LM["seq_len"], dim=LM["dim"],
                             heads=LM["heads"], blocks=LM["blocks"], batch_size=LM["batch"])
    trainer = Trainer(tc)                             # the card (--use_tpu)
    batch = lm_batch(LM["vocab"], B=LM["batch"], T=LM["seq_len"], seed=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    losses, step_s = [], []
    for _ in range(LM["steps"]):
        t0 = time.perf_counter()
        loss = trainer.train_one_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches, routes = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    n = LM["steps"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    want = {k.symbol: 0 for k in kernels}
    want.update({name: LM["blocks"] * n for name in ATTN_KERNELS})
    assert launches == want, (launches, want)
    step_ms = 1e3 * statistics.median(step_s[1:])

    params_cpu = {k: v.cpu() for k, v in trainer.params.items()}
    cpu_step = lm_cpu_step(trainer, params_cpu, tc)

    rows, prof = profiled(torch, "lm_train_profile", lambda: trainer.train_one_batch(batch),
                          top=24)
    tokens = LM["batch"] * LM["seq_len"]                  # B * T target tokens per step
    train = {"phase": "lm_train", "params": sum(p.numel() for p in params_cpu.values()),
             "batch": LM["batch"], "T": LM["seq_len"], "steps": n,
             "step_ms": step_ms, "step_ms_all": [1e3 * x for x in step_s],
             "target_tokens_per_step": tokens, "target_tokens_per_s": tokens / (step_ms / 1e3),
             "peak_memory_bytes": peak, "losses": losses, "kernel_launches": launches, "eager_routes": routes,
             "cpu_step": cpu_step,
             "profiled_step": {**prof, "by_family": by_family(rows),
                               "host_gap_ms": 1e3 * prof["wall_s"] - (prof["device_ms"] or 0.0)}}
    emit(train)
    return train, trainer


def phase_lm_test(torch, dev, kernels, trainer):
    """Trainer.test on the card after the steps: launches, and a B = 2,
    T = 256 batch against the CPU."""
    from paddle_tpu_torch.flagship import lm_batch
    from paddle_tpu_torch.trainer import Trainer

    batches = [lm_batch(LM["vocab"], B=LM["batch"], T=LM["seq_len"], seed=10 + i, device=dev)
               for i in range(LM["test_batches"])]
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    results = trainer.test_batches(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts(kernels)
    want = {k.symbol: 0 for k in kernels}
    want["flash_attn_fwd"] = LM["blocks"] * LM["test_batches"]
    assert launches == want, (launches, want)
    assert np.isfinite(results["cost"]), results

    small = dict(vocab=LM["vocab"], B=LM["cpu_batch"], T=LM["cpu_T"], seed=3)
    on_card = trainer.test_batches([lm_batch(device=dev, **small)])
    cpu = Trainer(trainer.config, device="cpu")
    cpu.params = {k: v.cpu() for k, v in trainer.params.items()}
    on_cpu = cpu.test_batches([lm_batch(device="cpu", **small)])
    err_key = next(e.name for e in trainer.config.model_config.evaluators) + \
        ".classification_error"
    cost_err = abs(on_card["cost"] - on_cpu["cost"]) / abs(on_cpu["cost"])
    assert cost_err <= TOL and on_card[err_key] == on_cpu[err_key], (on_card, on_cpu)
    test = {"phase": "lm_test", "batches": LM["test_batches"], "batch": LM["batch"],
            "T": LM["seq_len"], "wall_s": wall, "results": results, "kernel_launches": launches, "eager_routes": routes,
            "cpu_cost_rel_err": cost_err, "cpu_classification_error": on_cpu[err_key]}
    emit(test)
    return test


def attn_bf16_bytes(B, T, H, D):
    """Bytes of kernels 10, 11 and 12's bf16 bodies, each input read and
    each output written once: q, k, v, dout, out and the gradients at 2
    bytes, lse, delta and lengths at 4."""
    x, stat = 2.0 * B * T * H * D, 4.0 * B * H * T
    fwd, dkv = 4 * x + stat + 4 * B, 6 * x + 2 * stat + 4 * B
    dq = 5 * x + 2 * stat + 4 * B
    return {"flash_attn_fwd_bf16": fwd, "flash_attn_dq_bf16": dq,
            "flash_attn_dkv_bf16": dkv, "flash_attn_fwd_bf16_sm90": fwd,
            "flash_attn_dq_bf16_sm90": dq, "flash_attn_dkv_bf16_sm90": dkv}


# the bf16 flash bodies: the float32 body's bf16 instances, and the bodies
# for Hopper (bf16 wgmma over TMA tiles) that take D = 64 and 128
ATTN_BF16_KERNELS = ("flash_attn_fwd_bf16", "flash_attn_dq_bf16", "flash_attn_dkv_bf16")
ATTN_SM90_KERNELS = ("flash_attn_fwd_bf16_sm90", "flash_attn_dq_bf16_sm90",
                     "flash_attn_dkv_bf16_sm90")
# passes a product of each bf16 body's design takes, on average, and the
# rate it takes them at: the float32 body's instances in TF32 (Q.K^T one
# at D = 64, q * scale exact, and P.V two; dq's two scores one each and
# dS.K two; dkv's two scores one each, P^T.dO and dS^T.Q two each); the
# Hopper bodies in bf16 (the scores one, p and ds in two bf16 pieces:
# dQ's two scores and dS.K two)
ATTN_BF16_PASSES = {"flash_attn_fwd_bf16": (1.5, PEAK_TF32_FLOPS),
                    "flash_attn_dq_bf16": (4.0 / 3.0, PEAK_TF32_FLOPS),
                    "flash_attn_dkv_bf16": (1.5, PEAK_TF32_FLOPS),
                    "flash_attn_fwd_bf16_sm90": (1.5, PEAK_BF16_FLOPS),
                    "flash_attn_dq_bf16_sm90": (4.0 / 3.0, PEAK_BF16_FLOPS),
                    "flash_attn_dkv_bf16_sm90": (1.5, PEAK_BF16_FLOPS)}
# the LM at a head dim the Hopper bodies do not take (dim 320 over 8 heads:
# D = 40), a few bf16 steps: the main path of the float32 body's bf16 forward
# and dK/dV instances
LM_D40 = dict(dim=320, steps=2)
# the Hopper bodies' out, dk and dv against their plain versions: within
# SM90_ULPS bf16 spacings of the larger magnitude, the spacing taken at no
# less than SM90_CANCEL_FLOOR of max |plain| (tests/test_torch_flash_attention.py's
# floor, where sums cancel to far below their terms). p and ds in two bf16
# pieces keep ~16 bits: out and dv lie within one spacing, dq (each key tile
# summed apart and added with rounded float32 adds) within one but where
# ds = p (dp - delta) cancels and the tensor core's truncating sums of the
# scores show (1.07 in a GPU test case; tests/test_torch_flash_attention.py
# reproduces it on the CPU), so within two; dk, summed over up to T queries
# in the wgmma accumulator (which truncates each step), lies several
# spacings off where it cancels (non-causal, T = 1000-2048), a few 1e-5 of its
# scale. The planted control, the plain versions with p and ds rounded once
# to bf16 (one piece), lies tens to hundreds of spacings off in out, dq and
# dk, and a few in dv, and must fall outside each bound at every case.
SM90_CANCEL_FLOOR = 2.0 ** -11
SM90_ULPS = {"out": 1.0, "dq": 2.0, "dk": 16.0, "dv": 1.0}


def bf16_ulps(torch, got, want, floor=SM90_CANCEL_FLOOR) -> float:
    """The largest |got - want| in bf16 spacings of the larger magnitude,
    the spacing taken at no less than ``floor`` of max |want|
    (tests/torch_bf16_checks.assert_within_one_ulp holds it to 1)."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs()).clamp(min=floor * float(want.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=2.0 ** -126))) - 7)
    return float(((got - want).abs() / ulp).max())


def one_piece_references(torch, q, k, v, do, lse, delta, lengths, causal):
    """The planted control of the Hopper bodies' two-piece products: kernels
    10, 12 and 11's plain versions with p and ds rounded once to bf16 before
    their products, everything else as theirs -> (out, dk, dv, dq) in
    bf16."""
    from paddle_tpu_torch.ops import flash_attention as fa

    piece = lambda x: x.to(torch.bfloat16).float()
    T, D = q.shape[1], q.shape[3]
    msk = fa._visible(lengths, T, T, causal)
    qw, kw, vw, dw = fa._widened(q, k, v, do)
    s = torch.einsum("bqhd,bkhd->bhqk", qw * (1.0 / np.sqrt(D)), kw)
    s = torch.where(msk, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1)
    p = torch.where(msk, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l_safe = torch.clamp(torch.sum(p, dim=-1), min=1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", piece(p), vw) / l_safe.transpose(1, 2)[..., None]
    del s, p
    p, ds = fa._scores_backward(q, k, v, do, lse, delta, lengths, causal)
    return (out.to(q.dtype), torch.einsum("bhqk,bqhd->bkhd", piece(ds), qw).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", piece(p), dw).to(v.dtype),
            torch.einsum("bhqk,bkhd->bqhd", piece(ds), kw).to(q.dtype))


def named_bf16_launchers(torch, q, k, v, do, lse, delta, lengths, causal):
    """The float32 body's bf16 forward, dQ and dK/dV launched by name, with
    the arguments flash_attention._launch_fwd, _launch_dq and _launch_dkv
    give them, at a shape their route gives the Hopper bodies: (fwd() ->
    out, dq() -> dq, dkv() -> (dk, dv)), to time both bodies at the LM's
    shape."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, T, H, D = q.shape
    cz = int(bool(causal))
    new = lambda: torch.empty((B, T, H, D), device=q.device, dtype=q.dtype)
    lse_out = torch.empty((B, H, T), device=q.device)

    def fwd():
        out = new()
        fa.FLASH_ATTN_FWD_BF16.launch(q.device, *fa._strided(q), *fa._strided(k),
                                      *fa._strided(v), fa.ptr(lengths), *fa._strided(out),
                                      fa.ptr(lse_out), B, T, H, D, cz)
        return out

    def dq():
        args, _ = fa._check_backward(q, k, v, do, lse, delta, lengths)
        out = new()
        fa.FLASH_ATTN_DQ_BF16.launch(q.device, *args, *fa._strided(out), B, T, H, D, cz)
        return out

    def dkv():
        args, _ = fa._check_backward(q, k, v, do, lse, delta, lengths)
        dk, dv = new(), new()
        fa.FLASH_ATTN_DKV_BF16.launch(q.device, *args, *fa._strided(dk), *fa._strided(dv),
                                      B, T, H, D, cz)
        return dk, dv

    return fwd, dq, dkv


def attn_bf16_kernel_cases(torch, dev, kernels):
    """Kernels 10, 11 and 12's bf16 bodies on strided views of a fused bf16
    [B, T, 3, H, D] qkv against their bf16 plain versions: the LM's shape
    causal with full lengths and non-causal with ragged ones (one 1, one 0);
    T = 1000 (a ragged last tile), D = 128; and, for the float32 body's
    bf16 instances, which alone take D = 40, the D = 40 LM's shape (their
    main path) causal with full lengths and a ragged T = 512. Each case
    launches the bodies the route (flash_attention.sm90_takes) picks and
    none other: out, dq, dk and dv within BF16_TOL of max |plain|, lse
    within 1e-4 on rows that see a key and -1e30 on the others, the light
    forward equal to the training one, two launches of 11 and of 12
    bit-equal. The Hopper bodies' out, dk and dv also within SM90_ULPS bf16
    spacings (bf16_ulps), where the one-piece control must not be. Each body timed
    at its main path's shape from a cold L2, with its plain version and
    bf16 scaled_dot_product_attention at that shape (forward, and its
    autograd backward against 11 + 12); at the LM's shape the float32
    body's instances, launched by name, timed beside the Hopper bodies
    (``at_lm_shape``)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(23)
    B, T, H, D = LM["batch"], LM["seq_len"], LM["heads"], LM["dim"] // LM["heads"]
    D40 = LM_D40["dim"] // LM["heads"]
    names = ATTN_BF16_KERNELS + ATTN_SM90_KERNELS
    by_name = {k.symbol: k for k in kernels}
    out_cases = {name: [] for name in names}
    timed, shapes_of, at_lm = {}, {}, {}
    shapes = [(B, T, H, D, True, False), (B, T, H, D, False, True), (4, 1000, 4, 64, True, True),
              (4, 1024, 4, 128, True, True), (B, T, H, D40, True, False),
              (4, 512, 4, D40, True, True)]
    for b_, t_, h_, d_, causal, ragged in shapes:
        qkv = torch.from_numpy(rng.randn(b_, t_, 3, h_, d_).astype(np.float32)).to(dev).to(
            torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.from_numpy(rng.randn(b_, t_, h_, d_).astype(np.float32)).to(dev).to(
            torch.bfloat16)
        lens = rng.randint(2, t_ + 1, b_) if ragged else np.full(b_, t_)
        if ragged:
            lens[1], lens[-1] = 1, 0
        lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
        key = {"B": b_, "T": t_, "H": h_, "D": d_, "causal": causal,
               "lengths": lens.tolist() if ragged else "full"}
        sm90 = fa.sm90_takes(q, k, v, do)
        assert sm90 == (d_ in fa.SM90_D), key
        fwd_name, dq_name, dkv_name = ATTN_SM90_KERNELS if sm90 else ATTN_BF16_KERNELS
        before = {name: by_name[name].launches for name in names}
        out, lse = fa._launch_fwd(q, k, v, lengths, causal, True)
        light, _ = fa._launch_fwd(q, k, v, lengths, causal, False)
        ref, ref_lse = fa.flash_forward_reference(q, k, v, lengths, causal)
        torch.cuda.synchronize()
        seen = lengths > 0
        err, over = _scale_errs(["out"], [out], [ref])["out"]
        lse_err = float((lse - ref_lse)[seen].abs().max())
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32, key
        assert over <= BF16_TOL and torch.equal(light, out), (key, err, over)
        assert lse_err <= TOL and bool((lse[~seen] == -1e30).all()), (key, lse_err)
        fwd_case = {**key, "max_abs_err": err, "err_over_scale": over, "lse_max_abs_err": lse_err}
        out_cases[fwd_name].append(fwd_case)
        delta = torch.sum(do.float() * ref.float(), dim=-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, ref_lse, delta, lengths, causal)
        dq, (dk, dv) = fa._launch_dq(*args), fa._launch_dkv(*args)
        dq2, (dk2, dv2) = fa._launch_dq(*args), fa._launch_dkv(*args)
        want = (fa.flash_dq_reference(*args),) + fa.flash_dkv_reference(*args)
        torch.cuda.synchronize()
        launched = {name: by_name[name].launches - before[name] for name in names}
        assert launched == {name: 2 if name in (fwd_name, dq_name, dkv_name) else 0
                            for name in names}, (key, launched)
        same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
        assert same, ("flash bf16 backward not deterministic", key)
        errs = _scale_errs(["dq", "dk", "dv"], (dq, dk, dv), want)
        assert all(a.dtype == torch.bfloat16 for a in (dq, dk, dv)), key
        assert max(e[1] for e in errs.values()) <= BF16_TOL, (key, errs)
        dq_case = {**key, "max_abs_err": errs["dq"][0], "err_over_scale": errs["dq"][1],
                   "bit_equal_launches": same}
        out_cases[dq_name].append(dq_case)
        dkv_case = {**key, "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
                    "err_over_scale": max(errs["dk"][1], errs["dv"][1]),
                    "bit_equal_launches": same}
        out_cases[dkv_name].append(dkv_case)
        if sm90:
            # two bf16 pieces of p and ds: within SM90_ULPS, where one piece is not
            control = one_piece_references(torch, *args)
            got = {"out": (out, ref), "dk": (dk, want[1]), "dv": (dv, want[2]),
                   "dq": (dq, want[0])}
            ulps = {n_: bf16_ulps(torch, g, w) for n_, (g, w) in got.items()}
            one = {n_: bf16_ulps(torch, c, got[n_][1])
                   for n_, c in zip(("out", "dk", "dv", "dq"), control)}
            for case, names_ in ((fwd_case, ("out",)), (dq_case, ("dq",)),
                                 (dkv_case, ("dk", "dv"))):
                case.update(err_ulps={n_: ulps[n_] for n_ in names_},
                            one_piece_err_ulps={n_: one[n_] for n_ in names_})
            assert all(ulps[n_] <= SM90_ULPS[n_] for n_ in ulps), (key, ulps)
            assert all(one[n_] > SM90_ULPS[n_] for n_ in one), ("one-piece control passed", key,
                                                                 one)
            del control
        if (b_, t_, h_) == (B, T, H) and causal and not ragged:
            # a main path's shape (D = 64: the LM; D = 40: the D = 40 LM):
            # its bodies, their plain versions and SDPA timed
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = [a.transpose(1, 2).contiguous().requires_grad_() for a in (q, k, v)]
            lib_out = sdpa(*lib, is_causal=True)
            lib_do = do.transpose(1, 2).contiguous()
            lib_fwd_ms = time_ms(torch, lambda: sdpa(*lib, is_causal=True))
            lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(lib_out, lib, lib_do,
                                                                    retain_graph=True))
            here = {
                fwd_name: dict(
                    ms=time_ms(torch, lambda: fa._launch_fwd(q, k, v, lengths, causal, True)),
                    light_ms=time_ms(torch, lambda: fa._launch_fwd(q, k, v, lengths, causal,
                                                                   False)),
                    plain_ms=time_ms(torch, lambda: fa.flash_forward_reference(
                        q, k, v, lengths, causal), reps=5), library_ms=lib_fwd_ms),
                dq_name: dict(ms=time_ms(torch, lambda: fa._launch_dq(*args)),
                              plain_ms=time_ms(torch, lambda: fa.flash_dq_reference(*args),
                                               reps=5), library_ms=lib_bwd_ms),
                dkv_name: dict(ms=time_ms(torch, lambda: fa._launch_dkv(*args)),
                               plain_ms=time_ms(torch, lambda: fa.flash_dkv_reference(*args),
                                                reps=5), library_ms=lib_bwd_ms)}
            if sm90:
                # the float32 body's instances at the LM's shape, launched by
                # name (their route gives it the Hopper bodies), then the
                # Hopper bodies again: the old and new bodies in turns
                old_fwd, old_dq, old_dkv = named_bf16_launchers(torch, *args)
                old_out, old_dq_, (old_dk, old_dv) = old_fwd(), old_dq(), old_dkv()
                old_errs = _scale_errs(["out", "dq", "dk", "dv"],
                                       (old_out, old_dq_, old_dk, old_dv), (ref,) + want)
                assert max(e[1] for e in old_errs.values()) <= BF16_TOL, (key, old_errs)
                at_lm = {
                    "flash_attn_fwd_bf16": dict(ms=time_ms(torch, old_fwd),
                                                max_abs_err=old_errs["out"][0],
                                                err_over_scale=old_errs["out"][1]),
                    "flash_attn_dq_bf16": dict(ms=time_ms(torch, old_dq),
                                               max_abs_err=old_errs["dq"][0],
                                               err_over_scale=old_errs["dq"][1]),
                    "flash_attn_dkv_bf16": dict(
                        ms=time_ms(torch, old_dkv),
                        max_abs_err=max(old_errs["dk"][0], old_errs["dv"][0]),
                        err_over_scale=max(old_errs["dk"][1], old_errs["dv"][1]))}
                for tm in at_lm.values():
                    tm.update(key)
                here[fwd_name]["ms_again"] = time_ms(
                    torch, lambda: fa._launch_fwd(q, k, v, lengths, causal, True))
                here[dq_name]["ms_again"] = time_ms(torch, lambda: fa._launch_dq(*args))
                here[dkv_name]["ms_again"] = time_ms(torch, lambda: fa._launch_dkv(*args))
                del old_out, old_dq_, old_dk, old_dv
            sizes = attn_bytes_flops(b_, t_, h_, d_, visible_pairs(lens, t_, causal, h_))
            nbytes = attn_bf16_bytes(b_, t_, h_, d_)
            for name, tm in here.items():
                flops = sizes["flash_attn_" + name.split("_")[2]][1]
                b_ms, b_by = bound_bf16(nbytes[name], flops)
                passes, rate = ATTN_BF16_PASSES[name]
                tm.update(bytes=nbytes[name], flops=flops, bound_ms=b_ms, bound_by=b_by,
                          design_bound_ms=1e3 * max(nbytes[name] / PEAK_BYTES_PER_S,
                                                    passes * flops / rate))
                timed[name] = tm
                shapes_of[name] = {"B": b_, "T": t_, "H": h_, "D": d_, "causal": True}
            del lib, lib_out, lib_do
        del ref, want, dq2, dk2, dv2, dq, dk, dv
    for name, tm in at_lm.items():
        timed[name]["at_lm_shape"] = tm
    return {name: dict(cases=out_cases[name], timed=timed[name], shape=shapes_of[name])
            for name in names}


def lm_bf16_cpu_step(trainer, params_cpu, tc):
    """A B = 2, T = 256 bf16 step on the card against the CPU's bf16 plain
    versions, at the float32 phase's trained parameters: the loss within
    BF16_TOL, and every gradient within LM_BF16_GRAD_TOL of scale of the
    CPU's bf16 step taken with the card's ReLU gates (lm_cpu_step's
    handling: a gate whose pre-activation lies near 0 may open on one
    device only, and in bf16 the FFN's input may differ by an ulp between
    the devices, so such gates are reported, with their largest |pre| over
    the scale, and the gradients held at the card's gates)."""
    import torch

    from paddle_tpu_torch.flagship import lm_batch
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.layers import core

    small = dict(vocab=LM["vocab"], B=LM["cpu_batch"], T=LM["cpu_T"], seed=2)
    loss_g, grads_g, outs_g, _ = trainer.gm.grad_fn()(
        {k: v.to(trainer.device) for k, v in params_cpu.items()},
        lm_batch(device=trainer.device, **small))
    relu = [l.name for l in tc.model_config.layers if l.active_type == "relu"]   # the FFNs
    gates = {n: outs_g[n].value.detach().cpu() > 0 for n in relu}
    cpu = GradientMachine(tc.model_config, device="cpu", compute_dtype="bfloat16")
    batch = lm_batch(device="cpu", **small)
    loss_c, grads_c, outs_c, _ = cpu.grad_fn()(params_cpu, batch)

    finalize = core.finalize_output

    def card_gates(cfg, value, ctx, mask=None):     # relu(x) = x * [x > 0], the card's [.]
        if cfg.name not in gates:
            return finalize(cfg, value, ctx, mask)
        return (value + ctx.param(cfg.bias_parameter_name)) * gates[cfg.name].to(value.dtype)

    core.finalize_output = card_gates
    try:
        _, grads_gated, _, _ = cpu.grad_fn()(params_cpu, batch)
    finally:
        core.finalize_output = finalize
    source = {l.name: l.inputs[0].input_layer_name for l in tc.model_config.layers if l.inputs}
    flips = {}
    for n in relu:
        pre = (outs_c[source[n]].value.detach().float() @ params_cpu[f"_{n}.w0"]
               + params_cpu[f"_{n}.wbias"])
        differ = gates[n] != (outs_c[n].value.detach() > 0)
        flips[n] = {"count": int(differ.sum()), "of": int(differ.numel()),
                    "max_abs_pre_over_scale": (float(pre[differ].abs().max()) /
                                               float(pre.abs().max())) if differ.any() else 0.0}
    rel = lambda a, b: float((a.cpu().float() - b.float()).abs().max()) / max(
        1e-30, float(b.float().abs().max()))
    gap = lambda got, want: max(rel(got[n_], want[n_]) for n_ in want)
    check = {"loss_rel_err": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
             "grad_max_err_over_scale_same_gates": gap(grads_g, grads_gated),
             "grad_max_err_over_scale": gap(grads_g, grads_c), "gate_flips": flips}
    assert check["loss_rel_err"] <= BF16_TOL, check
    assert check["grad_max_err_over_scale_same_gates"] <= LM_BF16_GRAD_TOL, check
    return check


def phase_lm_bf16(torch, dev, kernels, f32_train, f32_test, params_cpu):
    """The long-context LM in bf16 mixed precision (docstring, 13a): 8 Adam
    steps from the float32 phase's initial parameters and batch, a test
    pass at its trained parameters, a B = 2, T = 256 bf16 step against the
    CPU, kernels 10-12's bf16 instances against their plain versions, and
    the step's time, device time, tokens/s and memory beside the float32
    step's. Returns the kernel rows of the three bf16 instances."""
    from paddle_tpu_torch.flagship import lm_batch, long_context_config
    from paddle_tpu_torch.trainer import Trainer

    t_phase = time.perf_counter()
    tc = long_context_config(vocab=LM["vocab"], seq_len=LM["seq_len"], dim=LM["dim"],
                             heads=LM["heads"], blocks=LM["blocks"], batch_size=LM["batch"],
                             dtype="bfloat16")
    trainer = Trainer(tc)                             # the float32 phase's seed: its parameters
    assert trainer.gm.compute_dtype == torch.bfloat16
    batch = lm_batch(LM["vocab"], B=LM["batch"], T=LM["seq_len"], seed=1, device=dev)
    n = LM["steps"]
    losses, step_s, launches, routes, peak = train_steps(torch, dev, kernels, trainer, batch, n)
    # D = 64: the Hopper bodies of 10, 11 and 12, and nothing of the
    # float32 body's bf16 instances
    want = {k.symbol: 0 for k in kernels}
    want.update({name: LM["blocks"] * n for name in ATTN_SM90_KERNELS})
    assert launches == want, (launches, want)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, f32_train["losses"], **BF16_LOSS_TOL)
    assert all(p.dtype == torch.float32 for p in trainer.params.values())
    slots = [v for s_ in trainer.opt_state.slots.values() for v in s_.values()
             if torch.is_tensor(v) and v.is_floating_point()]
    assert slots and all(v.dtype == torch.float32 for v in slots)
    step_ms = 1e3 * statistics.median(step_s[1:])
    rows, prof = profiled(torch, "lm_bf16_train_profile", lambda: trainer.train_one_batch(batch),
                          top=24)

    # the float32 body's bf16 forward and dK/dV on a main path: the LM at
    # head dim 40, which the Hopper bodies do not take, held to the same
    # steps in float32
    d40 = lambda dtype: Trainer(long_context_config(
        vocab=LM["vocab"], seq_len=LM["seq_len"], dim=LM_D40["dim"], heads=LM["heads"],
        blocks=LM["blocks"], batch_size=LM["batch"], dtype=dtype))
    n40 = LM_D40["steps"]
    f32_losses40 = train_steps(torch, dev, kernels, d40("float32"), batch, n40)[0]
    losses40, step40_s, launches40, routes40, _ = train_steps(torch, dev, kernels,
                                                              d40("bfloat16"), batch, n40)
    want40 = {k.symbol: 0 for k in kernels}
    want40.update({name: LM["blocks"] * n40 for name in ATTN_BF16_KERNELS})
    assert launches40 == want40, (launches40, want40)
    assert all(np.isfinite(losses40)) and losses40[-1] < losses40[0], losses40
    np.testing.assert_allclose(losses40, f32_losses40, **BF16_LOSS_TOL)
    del batch

    # the test pass at the float32 phase's trained parameters and batches:
    # kernel 10's bf16 instance, as float32 launches its own
    trainer.params = {k: v.to(dev) for k, v in params_cpu.items()}
    batches = [lm_batch(LM["vocab"], B=LM["batch"], T=LM["seq_len"], seed=10 + i, device=dev)
               for i in range(LM["test_batches"])]
    torch.cuda.synchronize()
    zero_counts(kernels)
    result = trainer.test_batches(batches)
    torch.cuda.synchronize()
    test_launches, test_routes = read_counts(kernels)
    want_test = {k.symbol: 0 for k in kernels}
    want_test["flash_attn_fwd_bf16_sm90"] = LM["blocks"] * LM["test_batches"]
    assert test_launches == want_test, (test_launches, want_test)
    assert np.isfinite(result["cost"]), result
    np.testing.assert_allclose(result["cost"], f32_test["results"]["cost"], **BF16_LOSS_TOL)
    del batches

    cpu_step = lm_bf16_cpu_step(trainer, params_cpu, tc)
    del trainer
    cases = attn_bf16_kernel_cases(torch, dev, kernels)
    tokens = LM["batch"] * LM["seq_len"]
    emit({"phase": "lm_bf16", "batch": LM["batch"], "T": LM["seq_len"], "steps": n,
          "losses": losses, "f32_losses": f32_train["losses"],
          "loss_max_rel_diff_vs_f32": max(abs(a - b_) / abs(b_) for a, b_ in
                                          zip(losses, f32_train["losses"])),
          "step_ms": step_ms, "f32_step_ms": f32_train["step_ms"],
          "step_ms_all": [1e3 * x for x in step_s],
          "target_tokens_per_s": tokens / (step_ms / 1e3),
          "f32_target_tokens_per_s": f32_train["target_tokens_per_s"],
          "profile_device_ms": prof["device_ms"],
          "f32_profile_device_ms": f32_train["profiled_step"]["device_ms"],
          "profile_by_family": by_family(rows),
          "f32_profile_by_family": f32_train["profiled_step"]["by_family"],
          "peak_memory_bytes": peak, "f32_peak_memory_bytes": f32_train["peak_memory_bytes"],
          "kernel_launches": {k: v for k, v in launches.items() if v}, "eager_routes": routes,
          "test_cost": result["cost"], "f32_test_cost": f32_test["results"]["cost"],
          "test_kernel_launches": {k: v for k, v in test_launches.items() if v},
          "test_eager_routes": test_routes, "cpu_step": cpu_step,
          "d40": {"dim": LM_D40["dim"], "heads": LM["heads"], "steps": n40,
                  "losses": losses40, "f32_losses": f32_losses40,
                  "step_ms": [1e3 * x for x in step40_s],
                  "kernel_launches": {k: v for k, v in launches40.items() if v},
                  "eager_routes": routes40},
          "kernel_cases": {k: c["cases"] for k, c in cases.items()},
          "timed": {k: c["timed"] for k, c in cases.items()},
          "seconds": time.perf_counter() - t_phase})
    fwd_src = ("paddle_tpu/ops/pallas_attention.py:56 (_fwd_kernel in bf16; pallas_call :173)",
               "flash_attn_fwd.cu")
    dkv_src = ("paddle_tpu/ops/pallas_attention.py:121 (_dkv_kernel in bf16; pallas_call :215)",
               "flash_attn_bwd.cu")
    dq_src = ("paddle_tpu/ops/pallas_attention.py:91 (_dq_kernel in bf16; pallas_call :202)",
              "flash_attn_bwd.cu")
    replaces = {"flash_attn_fwd_bf16": fwd_src, "flash_attn_fwd_bf16_sm90": fwd_src,
                "flash_attn_dq_bf16": dq_src, "flash_attn_dq_bf16_sm90": dq_src,
                "flash_attn_dkv_bf16": dkv_src, "flash_attn_dkv_bf16_sm90": dkv_src}
    # each body's launches on its own main path: D = 64 (the LM) for the
    # Hopper bodies, D = 40 for the float32 body's bf16 instances
    paths = {name: ("lm_bf16_train", launches) for name in ATTN_SM90_KERNELS}
    paths.update({name: ("lm_bf16_d40_train", launches40) for name in ATTN_BF16_KERNELS})
    out = []
    for name, c in cases.items():
        tm = c["timed"]
        main_path, counts = paths[name]
        launched = counts[name]
        assert launched > 0, name
        by_path = {main_path: launched}
        if test_launches[name]:
            by_path["lm_bf16_test"] = test_launches[name]
        is_fwd = name.startswith("flash_attn_fwd")
        out.append({
            "name": name, "route": "cuda", "source": "paddle_tpu_torch/csrc/" + replaces[name][1],
            "replaces": replaces[name][0], "launches": launched,
            "max_abs_err": max(e["max_abs_err"] for e in c["cases"]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "bound_bf16_ms": tm["bound_ms"],
            "design_bound_ms": tm["design_bound_ms"], "library_ms": tm["library_ms"],
            "library_note": ("torch.nn.functional.scaled_dot_product_attention(q, k, v, "
                             "is_causal=True) in bf16 [B, H, T, D] at full lengths"
                             if is_fwd else
                             "the backward of bf16 scaled_dot_product_attention(q, k, v, "
                             "is_causal=True) by autograd (dq, dk and dv together), against "
                             "kernels 11 + 12"),
            "body": ("Hopper: bf16 wgmma over TMA tiles, D = 64 and 128"
                     if name in ATTN_SM90_KERNELS else
                     "the float32 body's bf16 instance: mma.sync TF32 on widened tiles"),
            "main_path": main_path, "operand_dtype": "bfloat16", "launches_by_path": by_path,
            "max_err_over_scale": max(e["err_over_scale"] for e in c["cases"]),
            **({"light_ms": tm["light_ms"]} if "light_ms" in tm else {}),
            **({"ms_again": tm["ms_again"]} if "ms_again" in tm else {}),
            **({"at_lm_shape": tm["at_lm_shape"]} if "at_lm_shape" in tm else {}),
            **({"max_err_ulps": {n_: max(e["err_ulps"][n_] for e in c["cases"])
                                 for n_ in c["cases"][0]["err_ulps"]},
                "one_piece_min_err_ulps": {n_: min(e["one_piece_err_ulps"][n_]
                                                   for e in c["cases"])
                                           for n_ in c["cases"][0]["err_ulps"]}}
               if name in ATTN_SM90_KERNELS else {}),
            **({"lse_max_abs_err": max(e["lse_max_abs_err"] for e in c["cases"]
                                       if "lse_max_abs_err" in e)}
               if is_fwd else
               {"bit_equal_launches": all(e["bit_equal_launches"] for e in c["cases"]
                                          if "bit_equal_launches" in e)}),
            "errors_by_case": c["cases"], "bytes": tm["bytes"], "flops": tm["flops"],
            "shape": c["shape"]})
    return out


def phase_nested(torch, dev, kernels):
    """The hierarchical document classifier over nested sequences
    (flagship.hierarchical_config) on the card: a B = 4 batch against the
    CPU, 8 Adam steps through Trainer between zeroed counts (one launch of
    kernels 7b and 8 a step, the sentence GRU's gru_step layers in the
    nested group's loop, no other kernel), then Trainer.test over 4
    batches (one launch of kernel 7a a batch)."""
    from paddle_tpu_torch.flagship import hierarchical_config, nested_doc_batch
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.trainer import Trainer

    t_phase = time.perf_counter()
    tc = hierarchical_config(vocab=NESTED["vocab"], emb_dim=NESTED["emb_dim"],
                             hidden=NESTED["hidden"], lstm_size=NESTED["lstm_size"])
    tc.opt_config.batch_size = NESTED["batch"]
    docs = {k: NESTED[k] for k in ("vocab", "max_sents", "min_words", "max_words", "zipf")}

    # a B = 4 batch (an empty sentence in it) on the card against the CPU,
    # at the CPU's init_params(seed=1)
    cpu = GradientMachine(tc.model_config, device="cpu")
    params_cpu = cpu.init_params(seed=1)
    card = GradientMachine(tc.model_config, device=dev)
    small = dict(docs, B=NESTED["cpu_batch"], seed=2)
    loss_c, grads_c, _, _ = cpu.grad_fn()(params_cpu, nested_doc_batch(device="cpu", **small))
    loss_g, grads_g, _, _ = card.grad_fn()({k: v.to(dev) for k, v in params_cpu.items()},
                                           nested_doc_batch(device=dev, **small))
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_err = {n: float((grads_g[n].cpu() - g).abs().max()) / max(1.0, float(g.abs().max()))
                for n, g in grads_c.items()}
    assert loss_err <= NESTED_LOSS_TOL and max(grad_err.values()) <= TRAIN_TOL, \
        (loss_err, grad_err)

    trainer = Trainer(tc)                             # the card (--use_tpu)
    batch = nested_doc_batch(device=dev, B=NESTED["batch"], seed=1, **docs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)
    losses, step_s = [], []
    for _ in range(NESTED["steps"]):
        t0 = time.perf_counter()
        loss = trainer.train_one_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches, routes = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    n = NESTED["steps"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    want = {k.symbol: 0 for k in kernels}
    want.update(lstm_fwd_train=n, lstm_bwd=n)
    assert launches == want, (launches, want)
    step_ms = 1e3 * statistics.median(step_s[1:])
    _, prof = profiled(torch, "nested_train_profile", lambda: trainer.train_one_batch(batch))
    words = int(batch["words"].sub_seq_lengths.sum())
    train = {"phase": "nested_train", "config": "flagship.hierarchical_config(vocab=30000, "
             "emb_dim=128, hidden=512, lstm_size=128)", "batch": NESTED["batch"],
             "sentences": int(batch["words"].seq_lengths.sum()), "words": words,
             "padded_grid": list(batch["words"].ids.shape),
             "empty_sentences": int(((batch["words"].sub_seq_lengths == 0)
                                     & (torch.arange(NESTED["max_sents"], device=dev)[None, :]
                                        < batch["words"].seq_lengths[:, None])).sum()),
             "steps": n, "losses": losses, "step_ms": step_ms,
             "step_ms_all": [1e3 * x for x in step_s],
             "docs_per_s": NESTED["batch"] / (step_ms / 1e3),
             "words_per_s": words / (step_ms / 1e3), "peak_memory_bytes": peak,
             "profiled_step": {k: prof[k] for k in ("wall_s", "device_ms", "device_busy_share",
                                                    "device_events")},
             "kernel_launches": launches, "eager_routes": routes,
             "cpu_batch": NESTED["cpu_batch"], "cpu_loss_rel_err": loss_err,
             "cpu_grad_max_err_over_scale": max(grad_err.values())}
    emit(train)

    batches = [nested_doc_batch(device=dev, B=NESTED["batch"], seed=10 + i, **docs)
               for i in range(NESTED["test_batches"])]
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    results = trainer.test_batches(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts(kernels)
    want = {k.symbol: 0 for k in kernels}
    want.update(lstm_fwd=NESTED["test_batches"])
    assert launches == want, (launches, want)
    assert np.isfinite(results["cost"]), results
    test = {"phase": "nested_test", "batches": NESTED["test_batches"], "wall_s": wall,
            "docs_per_s": NESTED["test_batches"] * NESTED["batch"] / wall, "results": results,
            "kernel_launches": launches, "eager_routes": routes,
            "phase_s": time.perf_counter() - t_phase}
    emit(test)
    return {"train": train, "test": test}


def test_batch_count(cfg):
    """The batches of one test pass, replayed on the host."""
    from paddle_tpu_torch.data.feeder import create_data_provider

    dp = create_data_provider(cfg.test_data_config, cfg.opt_config.batch_size,
                              cfg.model_config.input_layer_names, seed=1, for_test=True)
    return sum(1 for _ in dp.batches())


def demo_train(torch, dev, kernels, ws, demo, names, conf, config_args, train, test, passes):
    """One demo through the port's command line on the card from a
    checkpoint of the CPU's init_params(seed=1): `train` for ``passes``
    between zeroed counts, its first batch's cost against the CPU's."""
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    demo_workspace(ws, demo, names, "\n".join(train), "\n".join(test))
    cfg = parse_config(conf, config_args)
    cpu = GradientMachine(cfg.model_config, device="cpu")
    params0 = cpu.init_params(seed=1)
    init = ckpt.save_checkpoint(os.path.join(ws, "init"), 0, params0)
    first, samples = replay_batches(cfg)
    with torch.no_grad():
        cpu_loss = float(cpu.loss_fn(params0, first, seed=1)[0])
    del cpu, params0, first
    args = [f"--config_args={config_args}"] if config_args else []
    zero_counts(kernels)
    losses, tests, walls, wall = cli_train_probed(
        ["train", f"--config={conf}", "--save_dir=out", f"--num_passes={passes}",
         f"--init_model_path={init}", "--log_period=0"] + args, passes)
    launches, routes = read_counts(kernels)
    assert len(losses) == passes * len(samples) and all(np.isfinite(losses)), losses
    costs = [t["cost"] for t in tests]
    assert len(costs) == passes and all(np.isfinite(costs)) and costs[1] < costs[0], costs
    first_err = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    assert first_err <= TRAIN_TOL, (losses[0], cpu_loss)
    return cfg, {"part": demo, "passes": passes, "steps": len(losses),
                 "samples_per_pass": sum(samples), "test_batches": test_batch_count(cfg),
                 "first_batch_cost": {"card": losses[0], "cpu": cpu_loss, "rel_err": first_err},
                 "test_costs": costs, "test_results": tests,
                 "losses_first_last": [losses[0], losses[-1]],
                 **wall_stats(walls, samples, passes), "train_cli_s": wall,
                 "kernel_launches": launches, "eager_routes": routes}


def in_band(costs, pinned):
    return all(abs(c - p) <= 0.03 * p for c, p in zip(costs, pinned))


def demos_sentiment(torch, dev, kernels, ws):
    """demo/sentiment (stacked_lstm_net at its own widths: emb 128, hid_dim
    512, three ReLU lstmemory of 128, batch 128, sort_by_length) on its
    band's corpus: each step one launch of kernels 7b and 8 for each of
    the three LSTMs, each test batch one of kernel 7a for each."""
    cfg, line = demo_train(torch, dev, kernels, ws, "sentiment",
                           ("common.py", "dataprovider.py", "sentiment_net.py",
                            "trainer_config.py"), "trainer_config.py", "",
                           DEMOS["sentiment_train"], DEMOS["sentiment_test"],
                           DEMOS["sentiment_passes"])
    want = {k.symbol: 0 for k in kernels}
    want.update(lstm_fwd_train=3 * line["steps"], lstm_bwd=3 * line["steps"],
                lstm_fwd=3 * line["test_batches"] * line["passes"])
    assert line["kernel_launches"] == want, (line["kernel_launches"], want)
    err_key = next(e.name for e in cfg.model_config.evaluators) + ".classification_error"
    err = line["test_results"][-1][err_key]
    line.update(config="demo/sentiment/trainer_config.py (stacked_lstm_net: emb 128, "
                "hid_dim 512, 3 ReLU lstmemory of 128, batch 128, sort_by_length), "
                "seed-train-1,2 / seed-test-1 (1,600 / 800 reviews)",
                pinned_cpu_band=PINNED_SENTIMENT_COST,
                in_pinned_band=in_band(line["test_costs"], PINNED_SENTIMENT_COST),
                final_error=err, final_error_under_0_08=err < 0.08)
    return line


def demos_vgg(torch, dev, kernels, ws):
    """demo/image_classification/vgg_16_cifar.py small=1 through
    image_provider.py and the port's image_util: 3x3 convs only, so no
    kernel of this repository runs."""
    lists = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo",
                         "image_classification")
    train, test = (open(os.path.join(lists, f"{n}.list")).read().split()
                   for n in ("train", "test"))
    _, line = demo_train(torch, dev, kernels, ws, "image_classification",
                         ("image_provider.py", "vgg_16_cifar.py"), "vgg_16_cifar.py",
                         "small=1", train, test, DEMOS["vgg_passes"])
    assert not any(line["kernel_launches"].values()), line["kernel_launches"]
    line.update(config="demo/image_classification/vgg_16_cifar.py small=1 (two conv "
                "groups of 16 and 32 3x3 filters, batch 32), the demo's lists",
                pinned_cpu_band=PINNED_VGG_COST,
                in_pinned_band=in_band(line["test_costs"], PINNED_VGG_COST))
    return line


def demos_long_context(torch, dev, kernels, ws):
    """demo/long_context at the lm phases' widths: `train` 2 passes (two
    launches of each of kernels 10, 11 and 12 a step, two of kernel 10 a
    test batch), then `test` of the last pass (kernel 10 only)."""
    args = "vocab={vocab},seq_len={seq_len},dim={dim},heads={heads},blocks={blocks}," \
           "batch_size={batch}".format(**LM)
    cfg, line = demo_train(torch, dev, kernels, ws, "long_context",
                           ("dataprovider.py", "trainer_config.py"), "trainer_config.py", args,
                           DEMOS["lm_train"], DEMOS["lm_test"], DEMOS["lm_passes"])
    want = {k.symbol: 0 for k in kernels}
    steps, tb = line["steps"], line["test_batches"]
    want.update(flash_attn_fwd=2 * steps + 2 * tb * line["passes"], flash_attn_dq=2 * steps,
                flash_attn_dkv=2 * steps)
    assert line["kernel_launches"] == want, (line["kernel_launches"], want)
    probe = CliProbe()
    zero_counts(kernels)
    try:
        test_wall = run_cli(["test", "--config=trainer_config.py", f"--config_args={args}",
                             f"--init_model_path=out/pass-{line['passes'] - 1:05d}"])
        job = list(probe.tests)
    finally:
        probe.close()
    launches, routes = read_counts(kernels)
    want = {k.symbol: 0 for k in kernels}
    want.update(flash_attn_fwd=2 * tb)
    assert launches == want, (launches, want)
    assert len(job) == 1 and abs(job[0]["cost"] - line["test_costs"][-1]) <= \
        1e-4 * line["test_costs"][-1], (job, line["test_costs"])
    line.update(config=f"demo/long_context/trainer_config.py --config_args={args}",
                tokens_per_s=line["train_samples_per_s"] * LM["seq_len"],
                test_job={"wall_s": test_wall, "results": job[0], "kernel_launches": launches,
                          "eager_routes": routes})
    return line


def phase_demos(torch, dev, kernels):
    """The demos phase: sentiment, vgg_16_cifar and long_context through
    the port's command line on the card, each in a workspace of its own."""
    import tempfile

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cwd = os.getcwd()
    lines = {}
    for name, part in (("sentiment", demos_sentiment), ("vgg_16_cifar", demos_vgg),
                       ("long_context", demos_long_context)):
        with tempfile.TemporaryDirectory() as ws:
            os.chdir(ws)
            try:
                t0 = time.perf_counter()
                line = part(torch, dev, kernels, ws)
                line.update(phase="demos", part_s=time.perf_counter() - t0, card=smi)
            finally:
                os.chdir(cwd)
        emit(line)
        lines[name] = line
    emit({"phase": "demos", "phase_s": time.perf_counter() - t_phase, "card": smi})
    return lines


# the sparse phase: demo/ctr at 10 M users and 1 M ads (the demo's own
# emb_dim 16, batch 32, AdaGrad) over 4 list entries of 1,024 impressions
# (128 batches a pass), and demo/recommendation at its widths
SPARSE = dict(users=10_000_000, ads=1_000_000, small_users=100_000,
              lists=("impressions-seed-1", "impressions-seed-2", "impressions-seed-3",
                     "impressions-seed-4"), passes=2, mem_limit=8 << 20, ratio_limit=1.25,
              profile_steps=32, scan_steps=4, agree_steps=32, agree_tol=1e-5,
              decay_rate=0.01, decay_rate_l1=0.001, rec_passes=2, prune_share=0.5)
CTR_FILES = ("dataprovider.py", "trainer_config.py")
REC_FILES = ("common.py", "dataprovider.py", "trainer_config.py")


class StepMemory:
    """The allocator's peak over every train step but the run's first: at
    the first step's end the peak is reset and the bytes then allocated
    kept as the base (the tables, their slots, the batch in flight)."""

    def __init__(self, torch):
        from paddle_tpu_torch.trainer import Trainer

        self.torch, self.base = torch, None
        self.step = step = Trainer._step
        probe = self

        def _step(trainer, batch, seed):
            out = step(trainer, batch, seed)
            if probe.base is None:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                probe.base = torch.cuda.memory_allocated()
            return out

        Trainer._step = _step

    def close(self):
        from paddle_tpu_torch.trainer import Trainer

        Trainer._step = self.step
        return self.torch.cuda.max_memory_allocated() - self.base


def host_batches(cfg, n):
    """The train provider's first ``n`` batches on the host, from seed 1."""
    from paddle_tpu_torch.data.feeder import create_data_provider

    dp = create_data_provider(cfg.data_config, cfg.opt_config.batch_size,
                              cfg.model_config.input_layer_names, seed=1)
    out = []
    for b in dp.batches():
        out.append(b)
        if len(out) == n:
            break
    return out


def sparse_trainer(cfg, device=None):
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils.flags import _Flags

    return Trainer(cfg, _Flags(log_period=0), device=device)


def sparse_steps_profiled(torch, ws, users, indexed, steps):
    """ctr at ``users`` users in this process: 2 warm steps, then ``steps``
    steps under torch.profiler on the indexed path or the row scan (the
    dense gradient, as accumulation takes it); device and wall ms a step,
    the peak bytes over the profiled steps above the state before them."""
    from paddle_tpu_torch.config import parse_config

    cfg = parse_config("trainer_config.py", f"num_users={users},num_ads={SPARSE['ads']}")
    trainer = sparse_trainer(cfg)
    trainer._sparse_launch = indexed
    batches = [trainer._to_device(b) for b in host_batches(cfg, 8)]
    for b in batches[:2]:
        trainer.train_one_batch(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def run():
        for i in range(steps):
            trainer.train_one_batch(batches[i % len(batches)])

    tag = f"sparse_{'indexed' if indexed else 'row_scan'}_{users}"
    rows, summary = profiled(torch, tag, run, top=8)
    assert summary["device_ms"] is not None, "the profiler saw no device time"
    line = {"users": users, "path": "indexed" if indexed else "row_scan", "steps": steps,
            "device_ms_per_step": summary["device_ms"] / steps,
            "wall_ms_per_step": 1e3 * summary["wall_s"] / steps,
            "device_events_per_step": summary["device_events"] / steps,
            "device_busy_share": summary["device_busy_share"],
            "peak_bytes_above_state": torch.cuda.max_memory_allocated() - base,
            "table_and_slot_bytes": sum(
                t.numel() * t.element_size() for pn in {pn for pn, _ in trainer._sparse_plan}
                for t in [trainer.params[pn], *trainer.opt_state.slots[pn].values()])}
    del trainer, batches
    torch.cuda.empty_cache()
    return line


def state_err(a, b):
    """|a - b| over max(1, max |b|) for every parameter and float slot of
    two trainers, the worst first; whether every t_last is equal."""
    errs, t_equal = {}, True
    pairs = [(k, a.params[k], b.params[k]) for k in b.params]
    for pn, slots in b.opt_state.slots.items():
        for k, v in slots.items():
            if k == "t_last":
                t_equal &= bool((a.opt_state.slots[pn][k].cpu() == v.cpu()).all())
            else:
                pairs.append((f"{pn}/{k}", a.opt_state.slots[pn][k], v))
    for name, x, y in pairs:
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        errs[name] = float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
    return dict(sorted(errs.items(), key=lambda kv: -kv[1])), t_equal


def sparse_agreement(torch, dev):
    """At the demo's default size (120 users, 48 ads) with L2 and L1 decay
    on the tables: the indexed path against the row scan on the card, 32
    AdaGrad steps from one set of parameters; then the card against the
    CPU from the CPU's init_params(seed=1): the first batch's cost and the
    state after 32 steps."""
    from paddle_tpu_torch.config import parse_config

    cfg = parse_config("trainer_config.py")
    for p in cfg.model_config.parameters:
        if p.sparse_update:
            p.decay_rate, p.decay_rate_l1 = SPARSE["decay_rate"], SPARSE["decay_rate_l1"]
    host = host_batches(cfg, SPARSE["agree_steps"])
    cpu, cpu64 = sparse_trainer(cfg, "cpu"), sparse_trainer(cfg, "cpu")
    indexed, scan = sparse_trainer(cfg), sparse_trainer(cfg)
    for t, dtype in ((indexed, torch.float32), (scan, torch.float32), (cpu64, torch.float64)):
        # copies: the sparse tables update in place
        t.params = {k: v.to(t.device, dtype, copy=True) for k, v in cpu.params.items()}
        t.opt_state = t.updater.init_state(t.params)
    scan._sparse_launch = False
    losses = {"cpu": [], "card": []}
    for b in host:
        losses["cpu"].append(float(cpu.train_one_batch(b)))
        cpu64.train_one_batch(b)
        d = indexed._to_device(b)
        losses["card"].append(float(indexed.train_one_batch(d)))
        scan.train_one_batch(d)
    path_errs, path_t = state_err(indexed, scan)
    card_errs, card_t = state_err(indexed, cpu)
    # the CPU's own float32 steps against the same steps in float64: with
    # AdaGrad's epsilon at 1e-6 and lr 0.1, a gradient element below the
    # epsilon passes its absolute rounding on x1e5 into the update
    gap64, _ = state_err(cpu, cpu64)
    first_err = abs(losses["card"][0] - losses["cpu"][0]) / abs(losses["cpu"][0])
    line = {"part": "agreement", "steps": len(host),
            "decay": {"decay_rate": SPARSE["decay_rate"], "decay_rate_l1": SPARSE["decay_rate_l1"]},
            "indexed_vs_row_scan_err": max(path_errs.values()), "t_last_equal": path_t,
            "indexed_vs_row_scan_by_tensor": path_errs,
            "card_vs_cpu_first_cost": {"card": losses["card"][0], "cpu": losses["cpu"][0],
                                       "rel_err": first_err},
            "card_vs_cpu_state_err": max(card_errs.values()), "card_vs_cpu_t_last_equal": card_t,
            "card_vs_cpu_by_tensor": card_errs,
            "cpu_f32_vs_f64_by_tensor": gap64,
            "losses_first_last": [losses["card"][0], losses["card"][-1]]}
    tol = SPARSE["agree_tol"]
    line["card_vs_cpu_within_tol"] = line["card_vs_cpu_state_err"] <= tol
    # each tensor within tol, or within the CPU's own float32 gap to float64
    line["card_vs_cpu_over_cpu_gap"] = {k: e for k, e in card_errs.items()
                                        if e > max(tol, gap64[k])}
    assert line["indexed_vs_row_scan_err"] <= tol and path_t, line
    assert first_err <= tol and not line["card_vs_cpu_over_cpu_gap"] and card_t, line
    return line


def sparse_ctr_cli(torch, ws):
    """ctr at 10 M users through the command line, 2 passes: samples a
    wall second, the peak bytes above the state over the steps after the
    first, one kind=sparse record a pass, both checkpoints verified."""
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    args = f"num_users={SPARSE['users']},num_ads={SPARSE['ads']}"
    mem = StepMemory(torch)
    try:
        losses, _, walls, wall = cli_train_probed(
            ["train", "--config=trainer_config.py", f"--config_args={args}", "--save_dir=out",
             f"--num_passes={SPARSE['passes']}", "--log_period=0", "--metrics_path=run"],
            SPARSE["passes"])
    finally:
        peak_above = mem.close()
    per_pass = len(losses) // SPARSE["passes"]
    samples = [32] * per_pass
    assert per_pass == 128 and all(np.isfinite(losses)), (len(losses), losses[:4])
    assert peak_above < SPARSE["mem_limit"], peak_above
    recs = [r for r in run_records("run") if r.get("kind") == "sparse"]
    assert [r["pass"] for r in recs] == list(range(SPARSE["passes"])), recs
    assert all(r["rows_touched"] == 2 * sum(samples) for r in recs), recs
    for p in range(SPARSE["passes"]):
        problems = ckpt.verify_checkpoint(os.path.join("out", ckpt.PASS_FMT % p))
        assert not problems, problems
    return {"part": "ctr_cli", "config": "demo/ctr/trainer_config.py --config_args=" + args
            + " (emb_dim 16, batch 32, AdaGrad)", "lists": list(SPARSE["lists"]),
            "passes": SPARSE["passes"], "steps": len(losses),
            **wall_stats(walls, samples, SPARSE["passes"]), "train_cli_s": wall,
            "peak_bytes_above_state": peak_above, "mem_limit": SPARSE["mem_limit"],
            "sparse_records": recs, "losses_first_last": [losses[0], losses[-1]]}


def sparse_pruning(torch, ws):
    """A 50% mask on ctr's first fc weight (hooks.write_mask_file): after a
    pass through Trainer.train on the card, every pruned weight is 0."""
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.optimizer import hooks
    from paddle_tpu_torch.proto import ParameterUpdaterHookConfig
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils.flags import _Flags

    cfg = parse_config("trainer_config.py")
    fc = next(l for l in cfg.model_config.layers if l.type == "fc")
    name = fc.inputs[0].input_parameter_name
    pc = next(p for p in cfg.model_config.parameters if p.name == name)
    mask = np.random.RandomState(1).rand(*pc.dims) >= SPARSE["prune_share"]
    hooks.write_mask_file(os.path.join(ws, "prune.mask"), mask)
    pc.update_hooks.append(ParameterUpdaterHookConfig(
        type="pruning", purning_mask_filename=os.path.join(ws, "prune.mask")))
    trainer = Trainer(cfg, _Flags(log_period=0, num_passes=1))
    before = trainer.params[name].cpu().numpy()
    assert (before[~mask] == 0).all()
    trainer.train()
    after = trainer.params[name].cpu().numpy()
    moved = after[mask] != before[mask]
    assert (after[~mask] == 0).all() and moved.any(), moved.mean()
    return {"part": "pruning", "param": name, "shape": list(mask.shape),
            "pruned": int((~mask).sum()), "pruned_nonzero_after_pass": int((after[~mask] != 0).sum()),
            "kept_weights_moved_share": float(moved.mean())}


def sparse_gather_fault(ws):
    """`sparse.gather_fault=raise@3` ends `train` (a child on the card) with
    the named fault and a nonzero exit code."""
    log = os.path.join(ws, "fault.log")
    t0 = time.perf_counter()
    proc = loop_child(["train", "--config=trainer_config.py", "--num_passes=1",
                       "--log_period=0", "--fault_spec=sparse.gather_fault=raise@3"], ws, log)
    try:
        rc, out = child_end(proc, log, timeout=120)
    finally:
        stop_children(proc)
    assert rc != 0 and "sparse.gather_fault" in out, (rc, out[-2000:])
    return {"part": "gather_fault", "rc": rc, "child_s": time.perf_counter() - t0,
            "last_line": out.strip().splitlines()[-1][:200]}


def phase_sparse(torch, dev, kernels):
    """The sparse phase: demo/ctr at 10 M users through the command line,
    its step at 10 M and 100 k users and the row scan at 10 M profiled, the
    two paths and the card against the CPU at the demo's size, pruning, the
    gather fault, and demo/recommendation through the command line; none of
    the kernels may launch."""
    import tempfile

    from paddle_tpu_torch.sparse import clear_tables

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cwd = os.getcwd()
    lines = []

    def done(line):
        emit({"phase": "sparse", **line, "card": smi})
        lines.append(line)
    try:
        with tempfile.TemporaryDirectory() as ws:
            demo_workspace(ws, "ctr", CTR_FILES, "\n".join(SPARSE["lists"]), "")
            os.chdir(ws)
            zero_counts(kernels)
            t0 = time.perf_counter()
            ctr = sparse_ctr_cli(torch, ws)
            ctr["part_s"] = time.perf_counter() - t0
            # the two passes' 1.45 GB checkpoints are checked: the disk back
            shutil.rmtree(os.path.join(ws, "out"))
            big = sparse_steps_profiled(torch, ws, SPARSE["users"], True, SPARSE["profile_steps"])
            small = sparse_steps_profiled(torch, ws, SPARSE["small_users"], True,
                                          SPARSE["profile_steps"])
            scan = sparse_steps_profiled(torch, ws, SPARSE["users"], False, SPARSE["scan_steps"])
            ratio = big["device_ms_per_step"] / small["device_ms_per_step"]
            assert ratio <= SPARSE["ratio_limit"], (big, small)
            assert big["peak_bytes_above_state"] < SPARSE["mem_limit"], big
            ctr.update(indexed_10M=big, indexed_100k=small, device_ms_ratio_10M_to_100k=ratio,
                       row_scan_10M=scan,
                       row_scan_over_indexed=scan["device_ms_per_step"] / big["device_ms_per_step"])
            done(ctr)
            # the default sizes from here on
            with open("train.list", "w") as f:
                f.write("impressions-seed-1\n")
            done(sparse_agreement(torch, dev))
            done(sparse_pruning(torch, ws))
            done(sparse_gather_fault(ws))
            launches, routes = read_counts(kernels)
            assert not any(launches.values()), launches
        with tempfile.TemporaryDirectory() as ws:
            os.chdir(ws)
            zero_counts(kernels)
            t0 = time.perf_counter()
            _, rec = demo_train(torch, dev, kernels, ws, "recommendation", REC_FILES,
                                "trainer_config.py", "", ("seed1",), ("seed2",),
                                SPARSE["rec_passes"])
            assert not any(rec["kernel_launches"].values()), rec["kernel_launches"]
            rec.update(config="demo/recommendation/trainer_config.py (its widths: embeddings "
                       "of 64 and 8, fc 64, batch 64, RMSProp, six sparse_update tables), "
                       "seed1 / seed2 (2,000 samples each)", part_s=time.perf_counter() - t0)
            done(rec)
    finally:
        os.chdir(cwd)
        clear_tables()
    emit({"phase": "sparse", "phase_s": time.perf_counter() - t_phase, "card": smi})
    return lines



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.ops import fused_lstm as fl
    from paddle_tpu_torch.ops import flash_attention as fl_attn

    dev = resolve_device(None)                       # also turns TF32 off
    kernels = (list(fg.KERNELS) + list(fa.KERNELS) + list(fl.KERNELS) + list(fc.KERNELS)
               + list(fl_attn.KERNELS))
    phase_build(kernels)
    k = phase_kernels(torch, dev)
    k.update(phase_lstm_kernels(torch, dev))
    k.update(phase_conv_kernels(torch, dev))
    k.update(phase_attn_kernels(torch, dev))
    serve = phase_serve(torch, dev, kernels)
    phase_serve_surface(torch, dev, kernels)
    beam = phase_beam(torch, dev, kernels)
    phase_cli(torch, dev, kernels)
    phase_pass_loop(torch, dev, kernels)
    phase_layers(torch, dev)
    train = phase_train(torch, dev, kernels)
    bf16_rows = phase_bf16(torch, dev, kernels, train)
    lstm_train, trainer, batch, err_key, err_before = phase_lstm_train(torch, dev, kernels)
    lstm_test = phase_lstm_test(torch, dev, kernels, trainer, batch, err_key, err_before)
    del trainer, batch
    bf16_rows += phase_lstm_bf16(torch, dev, kernels, lstm_train,
                                 {name: k[name]["barrier_us"] for name in LSTM_KERNELS})
    phase_lstm_remat(torch, dev, kernels, lstm_train)
    resnet_train, resnet_params, resnet_cpu64 = phase_resnet_train(torch, dev, kernels)
    resnet_test = phase_resnet_test(torch, dev, kernels, resnet_params)
    bf16_rows += phase_resnet_bf16(torch, dev, kernels, resnet_train, resnet_test,
                                   resnet_params, resnet_cpu64)
    del resnet_params, resnet_cpu64
    lm_train, lm_trainer = phase_lm_train(torch, dev, kernels)
    lm_test = phase_lm_test(torch, dev, kernels, lm_trainer)
    lm_params = {k: v.cpu() for k, v in lm_trainer.params.items()}    # the test pass's
    del lm_trainer
    bf16_rows += phase_lm_bf16(torch, dev, kernels, lm_train, lm_test, lm_params)
    del lm_params
    nested = phase_nested(torch, dev, kernels)
    demos = phase_demos(torch, dev, kernels)
    phase_sparse(torch, dev, kernels)

    meta = {
        "gru_fwd": ("paddle_tpu_torch/csrc/gru_fwd.cu",
                    "paddle_tpu/ops/pallas_gru.py:75 (_fwd_kernel_light; pallas_call :178)"),
        "gru_fwd_train": ("paddle_tpu_torch/csrc/gru_fwd.cu",
                          "paddle_tpu/ops/pallas_gru.py:57 (_fwd_kernel; pallas_call :178)"),
        "gru_bwd": ("paddle_tpu_torch/csrc/gru_bwd.cu",
                    "paddle_tpu/ops/pallas_gru.py:91 (_bwd_kernel; pallas_call :206)"),
        "attention_gru_fwd": ("paddle_tpu_torch/csrc/attention_gru_fwd.cuh",
                              "paddle_tpu/ops/pallas_attention_gru.py:285 "
                              "(_fwd_kernel_light; pallas_call :266)"),
        "attention_gru_fwd_train": ("paddle_tpu_torch/csrc/attention_gru_fwd.cuh",
                                    "paddle_tpu/ops/pallas_attention_gru.py:199 "
                                    "(_fwd_kernel; pallas_call :266)"),
        "attention_gru_bwd": ("paddle_tpu_torch/csrc/attention_gru_bwd.cu",
                              "paddle_tpu/ops/pallas_attention_gru.py:298 "
                              "(_bwd_kernel; pallas_call :415)"),
        "lstm_fwd": ("paddle_tpu_torch/csrc/lstm_fwd.cu",
                     "paddle_tpu/ops/pallas_lstm.py:179 (_fwd_kernel_light; pallas_call :307)"),
        "lstm_fwd_train": ("paddle_tpu_torch/csrc/lstm_fwd.cu",
                           "paddle_tpu/ops/pallas_lstm.py:155 (_fwd_kernel; pallas_call :307)"),
        "lstm_bwd": ("paddle_tpu_torch/csrc/lstm_bwd.cu",
                     "paddle_tpu/ops/pallas_lstm.py:201 (_bwd_kernel; pallas_call :341)"),
        "conv1x1_stats": ("paddle_tpu_torch/csrc/conv1x1_bn.cu",
                          "paddle_tpu/ops/pallas_conv1x1_bn.py:115 (_kernel; pallas_call :159)"),
        "flash_attn_fwd": ("paddle_tpu_torch/csrc/flash_attn_fwd.cu",
                           "paddle_tpu/ops/pallas_attention.py:56 (_fwd_kernel; pallas_call :173)"),
        "flash_attn_dq": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                          "paddle_tpu/ops/pallas_attention.py:91 (_dq_kernel; pallas_call :202)"),
        "flash_attn_dkv": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                           "paddle_tpu/ops/pallas_attention.py:121 "
                           "(_dkv_kernel; pallas_call :215)"),
    }
    gru_note = ("no single PyTorch call computes this function (torch.nn.GRU applies the "
                "reset gate after the recurrent product, a different cell)")
    lstm_note = ("no single PyTorch call computes this function (torch.nn.LSTM has no "
                 "peepholes and fixes the activations)")
    conv_note = ("torch.addmm(b, x, w.t()) at each shape, summed over a step's 30 launches: "
                 "the product alone, since no single PyTorch call also returns the column "
                 "statistics")
    attn_notes = {
        "flash_attn_fwd": ("torch.nn.functional.scaled_dot_product_attention(q, k, v, "
                           "is_causal=True) in [B, H, T, D] at full lengths"),
        "flash_attn_dq": ("the backward of scaled_dot_product_attention(q, k, v, is_causal=True) "
                          "by autograd (dq, dk and dv together), against kernels 11 + 12"),
    }
    attn_notes["flash_attn_dkv"] = attn_notes["flash_attn_dq"]
    # each kernel's launches are counted on its own main path
    paths = {"serve": serve, "train": train, "lstm_train": lstm_train, "lstm_test": lstm_test,
             "resnet_train": resnet_train, "resnet_test": resnet_test, "lm_train": lm_train,
             "lm_test": lm_test}
    path_of = {name: ("train" if name in TRAIN_KERNELS else
                      "lstm_test" if name == "lstm_fwd" else
                      "lstm_train" if name in LSTM_KERNELS else
                      "resnet_train" if name == "conv1x1_stats" else
                      "lm_train" if name in ATTN_KERNELS else "serve") for name in k}
    by_path = {"lstm_train": lstm_train, "lstm_test": lstm_test, "lm_train": lm_train,
               "lm_test": lm_test, "nested_train": nested["train"],
               "nested_test": nested["test"], "sentiment_cli": demos["sentiment"],
               "long_context_cli": demos["long_context"],
               "long_context_test_job": demos["long_context"]["test_job"]}
    rows = []
    for name, r in k.items():
        # forward / Td = 1 (serve); not reversed (train); default acts; the LM's shape
        main_case = r["cases"][0]
        # kernel 9 runs at nine shapes: its row is one train step's 30 launches
        times = r.get("per_step", main_case)
        b_ms, b_by = bound(r["bytes"], r["flops"])
        if "per_step" in r:                     # each launch's bound, summed over the step
            b_ms = times["bound_ms"]
        err = max(c["max_abs_err"] for c in r["cases"])
        launches = paths[path_of[name]]["kernel_launches"][name]
        assert launches > 0, (name, path_of[name])
        if name in TC_KERNELS:
            extra = {"bound_tc_ms": times.get("bound_tc_ms", bound_tc(r["bytes"], r["flops"]))}
        elif "design_bound_ms" in r:              # kernels 1-8: the bound plus their barriers
            extra = {"design_bound_ms": r["design_bound_ms"], "barrier_us": r["barrier_us"],
                     "grid_barriers": main_case["grid_barriers"], "blocks": main_case["blocks"],
                     "smem_bytes_per_block": main_case["smem_bytes_per_block"],
                     "per_step_us": main_case.get("per_step_us")}
            if "device_ms" in main_case:          # kernels 1-4, 7a, 7b, 8: the host's enqueue hidden
                extra["device_ms"] = main_case["device_ms"]
            if name == "lstm_bwd":                # its row groups, and the alternatives timed
                extra.update({key: main_case[key] for key in (
                    "row_groups", "units_per_block", "ms_row_groups_1", "ms_runtime_acts")})
            if name in ("lstm_fwd", "lstm_fwd_train"):
                extra.update({key: main_case[key] for key in (
                    "row_groups", "units_per_block", "w_in_smem", "ms_row_groups")})
            if "phase_us_per_step" in r:
                extra["phase_us_per_step"] = r["phase_us_per_step"]
            if name == "gru_fwd":                 # each admission size, and the wrapper's host time
                extra["launches_by_path"] = {
                    "serve": launches,
                    **{f"beam_B{B}": run["kernel_launches"]["gru_fwd"]
                       for B, run in beam["runs"].items()}}
                extra["by_batch"] = [{key: c[key] for key in (
                    "B", "reverse", "ms", "device_ms", "per_step_us", "smem_bytes_per_block",
                    "w_in_smem", "bound_ms", "design_bound_ms")} for c in r["cases"] if "B" in c]
                extra["back_to_back_ms"] = r["back_to_back_ms"]
            if name == "attention_gru_fwd":       # what a Td = 1 launch pays besides the step
                extra.update({key: r[key] for key in (
                    "empty_launch_ms", "launch_and_slice_load_ms", "slice_load_ms",
                    "back_to_back_ms")}, ms_at_Td8=r["cases"][1]["ms"])
        else:
            extra = {}
        if name in LSTM_KERNELS + ATTN_KERNELS:   # every path that launches it
            extra["launches_by_path"] = {
                path: run["kernel_launches"][name] for path, run in by_path.items()
                if run["kernel_launches"][name]}
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches,
            "max_abs_err": err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, **extra, "library_ms": times.get("library_ms"),
            "library_note": (conv_note if name == "conv1x1_stats" else
                             attn_notes[name] if name in ATTN_KERNELS else
                             lstm_note if name in LSTM_KERNELS else gru_note),
            "main_path": path_of[name],
            "max_err": err, "kernel_ms": times["ms"], "bytes": r["bytes"],
            "flops": r["flops"], "shape": r["shape"],
            **({"timed_over": "one train step (30 launches)",
                "launches_per_step": launches / RESNET["steps"]} if "per_step" in r else {}),
        })
    # 13 float32 rows, the bf16 instances of 1-3 and 5-12 and the Hopper
    # bodies of 6, 8, 10, 11 and 12 after them
    assert len(rows) == 13 and len(bf16_rows) == 17, ([r["name"] for r in rows + bf16_rows])
    emit({"kernels": rows + bf16_rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
