#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):

1. build   — nvcc builds every kernel of the serving, training and tuning
             paths from ``mxnet_tpu_torch/csrc`` (one process per source,
             in parallel, every legal tile instantiated), printing each
             source's seconds, ptxas's registers and spill bytes of the
             flash_fwd, flash_bwd_dq and flash_bwd_dkv instances at head
             dim 64 and the tensor-core (HMMA) instructions cuobjdump finds
             in each of the three libraries (at least one in each);
2. kernels — each kernel's wrapper against its plain PyTorch version on
             the card, inputs from a numpy seed: flash-attention forward at
             GPT-2 prefill and training shapes (causal + segment ids with
             right-padded tails and a fully masked row, T up to 1024;
             Tq != Tk non-causal), fp32 max |diff| <= 1e-4 on out and LSE,
             bf16 at (4*12, 512) within one bf16 step of the largest value;
             its times also from CUDA-graph replays, beside SDPA's, and its
             bound at the tensor cores' 3xTF32 (fp32) or bf16 rate with the
             CUDA-core bound beside it; LayerNorm at (rows, 768), max |diff|
             <= 1e-5; the two flash-attention backward kernels (dK/dV, dQ)
             at GPT-2 training shapes (4*12, 1024, 64) causal, 512 with
             padding ids and a fully masked row, ragged 384 and 1000,
             Tq=384/Tk=1000 non-causal), max |diff| <= 1e-4 on dq, dk, dv,
             and bf16 at (4*12, 1024, 64) causal within one bf16 step of
             each gradient's largest value, with CUDA-graph times beside
             the CUDA-event and profiler ones; keys that no query sees get
             exact zeros, and dK/dV in fp32 is also held against a float64
             answer beside the plain version; the bf16 instances of the
             three flash kernels at the AMP training shape (4*12, 1024, 64)
             causal get rows of their own (``name:bf16``) beside SDPA's bf16
             times (``is_causal``), and LayerNorm with bf16 x and fp32
             gamma/beta at (4096, 768) one beside ``F.layer_norm``'s, held
             with the plain version to a float64 answer;
             softmax at (4096, 768), (64, 50257), (1, 50257), ragged row
             counts and both sides of the wide path's threshold (d = 4095,
             4096, 4097, 8191: one warp a row below 4096, one cluster of
             eight blocks a row from it), fp32 max |diff| <= 1e-6, bf16
             |diff| <= 8e-3 |ref| + 1e-7 (one ulp of the value; absolute
             1e-2 would pass zeros at vocabulary width), with
             ``torch.softmax``'s device time beside the kernel's at
             (4096, 768) and (64, 50257) fp32 and bf16; then every kernel once at
             each tile of its legal set (flash (block_q, block_k) in
             {16, 32, 64}^2 at (4*12, 512, 64) causal + ids; LayerNorm and
             softmax block_rows in {1, 2, 4, 8, 16, 32} at (2000, 768)) at
             the same tolerances; kernel, plain and library (SDPA with a
             boolean mask, its autograd backward, F.layer_norm,
             torch.softmax) times, medians of CUDA-event timings; then the
             float16, float8_e4m3fn and float8_e5m2 instances of the three
             flash kernels (rows ``name:fp16``, ``:e4m3``, ``:e5m2``) at
             (4*12, 1024, 64) causal, BERT-Base's (32*12, 128, 64)
             non-causal with key-padding ids and a row that sees no key,
             and every legal tile at (4*12, 512, 64) causal + ids, the
             forward against ``attention_tiled_plain`` (the reference
             kernel's roundings) at the kernel's key tile, the backward
             against ``attention_bwd_plain``, within
             tests/torch_flash_limits.py's limits (2u/(1-u) |want| + the
             format's subnormal step + twice each element's own bound on
             the two values' distance before rounding); at the (4*12,
             1024, 64) shape the faults of that file planted in the
             kernels (a key tile hidden, V's or G's tiles reversed,
             outputs zero past the first tile), each of which must land
             over the limit; beside SDPA's float16 times on the same
             values, bounds at the fp16 or fp8 tensor-core rate;
             LayerNorm with float16 x (fp32 gamma/beta, and float16: 8u, the
             plain version rounds five times) at (4096, 768) and softmax
             at float16, narrow and wide, within one fp16 step, at every
             row tile (``layer_norm:fp16``, ``softmax:fp16``);
3. serve   — GPT-2 small (12 x 768, 12 heads, vocab 50257, max_length
             1024, fp32, weights from a numpy seed loaded through
             ``params_from_mxnet_tpu``) served by ``DecodeEngine`` (8 slots,
             128-token pages, prefix cache), tuning off, its program table
             captured as CUDA graphs by ``warmup()`` (43: the tick and 7
             lengths x 3 batches of each prefill family; captures, warmup
             seconds, the graph pool's bytes and peak memory printed): 8
             ragged prompts of 16-500 tokens, 32 new tokens each, two
             sharing a 300-token prefix so the prefix-join program runs.
             Checks: each program's captured launches (12 flash forward in a
             prefill, 25 LayerNorm in every program), the replays while
             serving times those launches against 12 x plain prefills and
             25 x program runs, no capture and no counter move while
             serving, every launch at the default tile, each request's
             last-token prefill logits against the same weights on the CPU
             (relative max |diff| <= 1e-3), and the engine's greedy tokens
             against ``generate(use_cache=False)`` on the card up to the
             first near tie (top-2 logit margin < 1e-3). Then the tick and
             the (4, 512) prefill alone: run wall against device busy and
             the idle share, replay ms, and a replay's tokens and pools
             bit-equal to the eager body's on the same operands; the same 8
             requests through an engine whose programs run their bodies
             eagerly (a private switch), whose tokens must equal the
             captured engine's; and 64 ragged clients on 8 threads (prompts
             of 1-500 tokens, half sharing a 128-token prefix, 1-6 new
             tokens, K = 4, prefix cache) with no capture after warmup and
             stats and counters that add up;
4. train   — GPT-2 small (the same width and depth, GPT-2's N(0, 0.02)
             initialisation from a numpy seed, loaded through
             ``params_from_mxnet_tpu``) trained through
             ``autograd.record`` / ``autograd.backward`` /
             ``gluon.Trainer("adamw").step``, tuning off: one step's
             gradients of every parameter at B=2, T=128 (one row
             right-padded through ``valid_length``, dropout 0) against the
             same weights on the CPU (relative max |diff| <= 1e-3); then 30
             steps at B=4, T=1024 (AdamW with warm-up and a cosine schedule)
             with dropout 0.1 from ``mxnet_tpu_torch.random`` on a
             cyclic-sequence task made from the seed, whose loss must fall
             below half its first value, with 12 launches each of the
             flash forward, dK/dV and dQ kernels and 25 LayerNorm launches
             in every step, all at the default tile; prints step ms,
             training tokens/s and peak device memory;
4b. train (compiled) — the same model through ``trainer.compile_step``
             (one CUDA graph replay a step after a warm step and the
             capture): (i) three compiled and three eager AdamW steps at
             B=4, T=1024, dropout 0, whose losses, weights and Adam states
             agree within rtol 2e-4, atol 1e-6 (the reference's
             cross-program bound); (ii) 30 steps as phase 4's (dropout 0.1)
             whose loss falls below half its first value, one capture, the
             captured body's launches (12 flash forward, 12 dK/dV, 12 dQ,
             25 LayerNorm), no launch outside the warm step and the capture,
             and those kernels found by name in one replay by the profiler;
             (iii) two overflowing ``DynamicLossScaler`` steps (warm and
             replay) leave every weight bitwise and ``num_update`` as they
             were and halve the scale each; (iv) eager and compiled runs in
             the order A B B A, each run's step ms (median of steps 3-30),
             training tokens/s and peak device memory printed beside the
             card's name and power limit;
4c. train (AMP) — the same model and task under
             ``amp.autocast("bfloat16")`` (the reference's cast at the op:
             logits, loss and the flash kernels in bf16, LayerNorm on the
             fp32 residual stream): (i) one eager step at B=2, T=128 (one
             row right-padded, dropout 0): logits and loss bf16, gradients
             fp32 within 3e-2 of each gradient's largest entry of the same
             step on the CPU, 12 bf16 launches of each flash kernel and 25
             fp32 LayerNorm launches; (ii) three compiled and three eager
             AMP steps at B=4, T=1024, dropout 0, within phase 4b (i)'s
             bound, bit-equality printed; (iii) 30 compiled AMP steps as
             4b (ii), whose loss falls below half its first value and ends
             within 1.25x phase 4b (ii)'s last loss, one capture, captured
             launches 12 / 12 / 12 bf16 and 25 fp32 LayerNorm, the bf16
             flash instances found by name in one replay by the profiler;
             (iv) a fresh model through ``amp.convert_hybrid_block`` with
             multi-precision AdamW, 10 eager AMP steps: non-norm weights
             bf16 with fp32 masters, the loss falls, 25 LayerNorm launches
             a step with bf16 x and fp32 gamma/beta; (v) fp32 compiled (A)
             and AMP compiled (B) runs in the order A B B A, step ms,
             training tokens/s and peak memory beside the card's name and
             power limit. bf16 GEMMs sum in fp32
             (``allow_bf16_reduced_precision_reduction`` off, as the MXU);
4e. amp16 — GPT-2 small under ``amp.autocast("float16")`` (also
             ``python3 chip_smoke.py amp16``, from the seed's batches):
             (i) one eager step at B=2, T=16 (the CPU's float16
             products are slow) through ``scale_loss`` (a static 2^12)
             and ``unscale``: logits and loss float16,
             gradients float32 within 1e-2 of the CPU's largest entry, 12
             float16 launches of each flash kernel and 25 fp32 LayerNorm;
             (ii) three compiled against three eager steps at B=4, T=1024
             within phase 4b (i)'s bound; (iii) 30 compiled steps on phase
             4b (ii)'s batches, weights and dropout seed with a
             DynamicLossScaler (2^16, window 10) and the scale forced past
             float16's range at step 21: the overflowing steps skipped with
             every weight bitwise and the scale halved, the scale doubled
             after 10 clean steps, num_update the clean steps, the loss
             below half its first value, one capture of the float16
             instances; (iv) ``convert_hybrid_block(net, "float16")`` with
             multi-precision AdamW: 25 float16-x LayerNorm launches a step;
             (v) DecodeEngines (128-token prompts, no prefix cache) built
             under ``autocast("float16")`` and ``("bfloat16")`` and over a
             converted bf16 model: a float32 KV cache as the reference's,
             the prefill's flash launches of the AMP dtype's instance alone,
             tokens equal to ``generate(use_cache=False)`` under the same
             state up to the first near tie (top-2 margin below eight steps
             of the format at the largest logit); (vi) the flash op forward
             and backward under ``autocast("float8_e4m3fn")`` and
             ``("float8_e5m2")`` at (4*12, 1024, 64) causal: one launch of
             each fp8 instance, gradients float32 and finite, within
             tests/torch_flash_limits.py's limits of the plain versions. No plain flash or softmax
             version runs on the card and no library lowering is taken
             (a spy counts them); the phase within 60 s;
4d. nd    — the NDArray layer (``mx.np``, ``mx.npx``, the op registry)
             on the card: (i) GPT-2 small from phase 4's weights and
             batches at B=4, T=1024 (the last row right-padded by 128),
             fp32, dropout 0, AdamW: 3 steps from NDArrays
             (``mx.np.array(..., ctx=mx.gpu())``, ``autograd.record``,
             ``loss.backward()``, ``trainer.step(B)``) and 3 tensor-path
             steps in the same process, whose per-sample losses and step-1
             gradients of every parameter must be bitwise equal or within
             1e-6 of the largest entry (which case held is printed), with
             12 flash forward, 12 dK/dV, 12 dQ and 25 LayerNorm launches in
             each NDArray step as in each tensor step; one AMP (bf16) step
             each way whose losses are bitwise equal; (ii)
             ``npx.multihead_attention`` at (4, 1024, 768), 12 heads,
             causal, and with a right-padding mask routed to segment ids,
             under ``record()`` with ``backward()``: output and q/k/v
             gradients within 1e-4 of the plain version, one launch of each
             flash kernel; ``npx.layer_norm`` at (4096, 768) within 1e-5;
             ``npx.pick`` / ``npx.embedding`` at indices -17, -16, -1, 15,
             16 of 16 give NaN where the reference's rule does and a later
             CUDA op still runs; (iii) host µs a call of ``mx.np.add``
             (``invoke``) beside ``torch.add`` on (1,) operands (median of
             100 blocks of 100 calls, A B B A), and the eager step's wall
             through the NDArray door (B) against the tensor path (A),
             dropout 0.1, medians of steps 3-12, A B B A, beside the
             card's name and power limit; the phase's seconds;
5. tune    — the tuning workflow at GPT-2 small's width with
             ``MXTPU_TUNE=1`` and a temporary cache file: warm phase 3's
             engine (same weights and arguments) with an empty cache, read
             ``tune.missed()`` (flash_fwd and layer_norm keys), tune exactly
             those plus the flash_bwd and softmax specs of
             ``ladder_specs((1, 4, 8), (128, 512, 1024), 12, 64, 768)``
             (3 trials, 2 tiles an axis, device time from CUDA-graph
             replays), ``save()``; then ``tune.reset()``, a fresh engine,
             ``warmup()`` (which preloads) and phase 3's 8 requests. Checks:
             no cache miss after the preload, ``tune.measurements`` flat
             while serving, the tokens equal to phase 3's up to each
             request's first near tie; prints each spec's winner with its
             default, best and library (``"xla"``) µs, their geometric mean
             default/best, and the library calls. Then the same requests
             through fresh engines untuned (A), tuned (B) and tuned with
             every LayerNorm on its kernel at the default tile (C), in the
             order A B C C B A, each run's tick and prefill medians printed
             and its tokens checked as above;
6. rtc     — the JAX package's rtc test kernel (axpy) as CUDA C through
             ``rtc.CudaModule``, launched at n = 4 and n = 2**24 and held to
             torch's ``2 * x + y`` (relative 1e-6); compile seconds, launch
             ms and the bytes bound.
7. resnet  — ResNet-50 v1 at full width (224 x 224, 1000 classes, the
             reference's architecture; weights from a numpy seed loaded
             through ``load_dict`` into the deferred placeholders), through
             the registry's ``convolution``/``pooling``/``batch_norm`` (cuDNN
             and the reference's BatchNorm formula; no port kernel: the five
             kernels' counters stay 0, printed before and after): (i) one
             fp32 training step at batch 8 (forward in training mode,
             ``SoftmaxCrossEntropyLoss``, backward, ``SGD(momentum=0.9)``)
             on the card and on the CPU, TF32 off: logits, loss and every
             running statistic within 1e-3 of each one's largest entry,
             every gradient within 5e-2 of the net's largest gradient and
             every weight's update within 5e-2 of lr times it over the
             batch (each gradient's error over its own largest entry is
             printed beside);
             (iii) ``bench.py``'s training: ``amp.init("bfloat16")``,
             ``compile_step``, batch 128 of bf16 images, SGD(0.1, 0.9):
             three compiled steps against three eager ones (losses, weights,
             statistics and momenta within 2e-2 of each largest entry), then
             20 compiled steps on 4 cyclic batches of a 10-class template
             task whose last cycle's mean loss must fall below 0.7 of the
             first loss, one
             capture and no memory reserved after it; step wall and device
             busy ms, img/s, MFU (``bench.py``'s FLOPs over the dense bf16
             peak), peak memory, the device time by kind and the ten
             heaviest kernels, and the eager step's forward+backward and
             optimizer device ms; (ii) ``bench.py``'s inference on the
             trained weights: ``cast("bfloat16")``, predict mode, batch 128,
             within 5e-2 of the fp32 predict's largest logit; img/s, device
             busy ms a batch and the idle share; the phase's seconds.
8. predictor — the ``serve.Predictor`` serving hybridized blocks at full
             width, each bucket one CUDA graph: (i) ResNet-50 v1 (phase 7's
             weights, ``cast("bfloat16")``, ``hybridize()``) with the ladder
             1, 2, ..., 64: ``warmup()`` captures 7 programs and serving
             captures none; 256 single-image submits from 16 threads, then
             predicts of 1, 3, 64 and 100 rows, every served row bitwise
             equal to the eager block's forward of the same padded bucket
             batch; then ``bench.py``'s ``bench_resnet_infer`` body through
             the port's ``cached_op.trace`` at batch 128 (bitwise equal to
             the eager forward); (ii) BERT-Base (12 x 768, 12 heads, vocab
             30522, max_length 512, weights from a numpy seed, dropout 0.1,
             inert in predict mode) behind a Predictor of 128 int32 tokens,
             128 int32 token types and a float32 valid length an item,
             max_batch 32, in fp32 and then after ``cast("bfloat16")``: 128
             requests of valid lengths 16-128 from 16 threads, every served
             row against the same row predicted alone (fp32 within 1e-4,
             bf16 within 3e-2 of the largest entry), 12 flash-forward and
             25 LayerNorm launches in every capture, no counter moving while
             serving and the launches while serving (replays x captured)
             non-zero; (iii) warmup seconds, captures, graph-pool bytes,
             request p50/p99, img/s and tokens/s served and, at buckets 1, 8
             and the top one, a program run's wall, device busy and idle
             share beside the eager block's, each beside the card's name
             and power limit. The kernels phase holds the flash forward at
             BERT's shape, (32*12, 128, 64) non-causal with key-padding ids
             and a length-0 row, fp32 and bf16, to its plain version at
             every legal tile, and the two backward kernels at BERT
             pretraining's shapes, (32*12, 128, 64) and (8*16, 128, 64),
             non-causal, kv ids 112 of 128 valid and a length-0 row, fp32
             and bf16, at every legal tile (the length-0 row's and the
             padded keys' gradients exact zeros), with SDPA's masked
             backward beside them.
9. bert_pretrain — BERT pretraining through ``parallel.Learner`` (one CUDA
             graph a step): (i) one fp32 Learner step of the padded
             BERT-Base (``bert_base(max_length=128, dropout=0)``, vocab
             30522, a 112-of-128 valid length, weights from a numpy seed,
             B = 8, SGD(0.1, momentum 0.9)) on the card and on the CPU: loss
             within 1e-4, the word embedding's and layer 0's qkv weight's
             updates within 1e-3 of each one's largest entry; (ii)
             ``bench.py``'s ``bench_bert_pretrain("base")`` with only its
             imports changed (B = 32, T = 128, dropout 0.1, AMP bf16,
             AdamW(1e-4, wd 0.01), 2 warm-up and 8 timed steps): tokens/s,
             MFU (6 x 110e6 x tokens/s over the 989 TFLOP/s dense bf16
             peak), a step's wall, device busy and idle share, one capture
             and no counter moving while it replays, launches a step (12
             flash forward, 12 dK/dV, 12 dQ, all bf16, 26 LayerNorm), peak
             memory, first and last loss; then, at dropout 0 from one
             state, a replayed step bitwise equal to the same step run
             eagerly (loss, parameters, optimizer states); (iii)
             ``bench_bert_pretrain("large")`` (B = 8, ``remat=True``: 48
             flash forward and 100 LayerNorm launches a step) with the same
             numbers, and a ``remat=False`` run at the same batch, whose
             peak memory must be higher; (iv) the generic Gluon loop on a
             hybridized padded BERT-Base (fp32, dropout 0, B = 8):
             ``autograd.record()``, ``backward()``, ``Trainer.step`` for 5
             steps beside the un-hybridized block, every loss and gradient
             bitwise equal, one forward and one backward capture with 12
             dK/dV and 12 dQ launches inside the captured backward, and a
             step's wall, device busy and idle share both ways; each
             beside the card's name and power limit.

10. graph — the graph layer: (i) BERT-Base (``bert_base(max_length=128,
             dropout=0)``, vocab 30522, weights from a numpy seed, fp32),
             hybridized, run at B = 32, T = 128 with token types and valid
             lengths 16-128 and one of 0, then ``export``ed and loaded back
             by ``gluon.SymbolBlock.imports``: the hybridized import's
             sequence and pooled outputs within 1e-5 of the block's largest
             entry (the same kernels in the same order), 12 attention nodes
             carrying the key-padding mask, 12 flash-forward and 25
             LayerNorm launches in its one captured program; a Predictor
             over it (ladder 1-32, 128 requests from 16 threads) whose
             bucket-32 predict equals the block's within 1e-5 and whose rows
             agree within 1e-4, and the bucket-32 program's wall, device
             busy and idle share beside the hybridized block's; (ii)
             ResNet-50 v1 at batch 8, 224 x 224, fp32, predict mode,
             exported and imported, within phase 7's 1e-3 (no port kernel
             runs); (iii) ``optimize_for("tpu")`` on the reference's
             hand-written attention (``_ManualAttention``, through
             ``mx.np``/``mx.npx``) at (4, 12, 1024, 64) fp32, unmasked and
             with a (4, 1, 1, 1024) key-padding mask of 3/4 valid keys: one
             ``flash_attention`` node and no softmax, forward within
             FLASH_TOL and dq/dk/dv within GRAD_RTOL of the unfused graph
             (``optimize_for("default")``: the same trace without the
             pass) under ``record()``, the recorded program's
             captured launches 1 flash forward and 1 each of dK/dV and dQ,
             device ms fused against unfused; (iv) an ``mx.sym`` MLP
             (FullyConnected 768 -> 3072, relu, -> 768, batch 64) through
             ``simple_bind`` on the card, ``forward(is_train=True)`` and
             ``backward``, outputs and gradients within 1e-5 of the CPU's.
11. script — reference-style Gluon code: ``tests/torch_script_gpt.py``'s
             ``ScriptGPT`` (the JAX package's GPT body with only its
             imports changed: ``mx.np``/``npx`` on layer outputs, the tied
             head through ``tok_embed.weight.data()``) at GPT-2 small's
             full width and depth, fp32, B = 4, T = 1024: (i) built on the
             CPU, ``initialize(Normal(0.02), ctx=mx.gpu())`` moves every
             parameter to the card, ``load_parameters(f, ctx=mx.gpu())``
             reads phase 4's weights, ``collect_params('.*weight')`` has 50
             entries, ``p.data()`` shares the parameter's memory,
             ``p.grad()`` equals torch's ``.grad`` after a backward,
             ``summary()`` prints a line a parameter; (ii) at dropout 0,
             logits, loss and every gradient (``tok_embed.weight``'s, by two
             routes, by name) against the port's ``gpt2_small()`` with the
             same weights and against the model hybridized (its replayed
             forward and backward graphs), within 1e-6 (logits, loss) and
             1e-5 (gradients) of each largest entry; (iii) ten hybridized
             AdamW steps (phase 4's trainer) at dropout 0.1 on phase 4's
             batches: the loss falls and ends within 1.25x of phase 4's
             tenth, one forward and one backward capture; (iv) an eager step
             launches 12 flash forward, 12 dK/dV, 12 dQ and 25 LayerNorm
             kernels, the captured forward and backward the same between
             them, replays x captured launches account for the run, every
             launch at the default tile; then eager and hybridized steps'
             wall, device busy and idle share; (v) a hybridized block whose
             body builds ``mx.np.array(-1e30)`` for a masked fill, captured
             once, its replays bitwise equal to eager; (vi) the body
             ``mx.np.tanh(Dense(x))`` under ``record()``, eager and
             hybridized, x's and the weight's gradients within 1e-6 of the
             CPU's and nonzero.
12. optim — the optimizers, norms and losses: (i) phase 9's
             ``bench_bert_pretrain("large")`` (B = 8, T = 128, bf16, remat,
             2 warm steps and 8 replays) with ``LAMB(1e-4, wd=0.01)`` in
             AdamW's place: one capture, the flash and LayerNorm launches
             of phase 9's Large run, the float32 predict-mode loss on the
             bench's batch falling over its 10 steps; wall, busy, idle,
             kernels a step, tokens/s, MFU and peak memory beside phase 9's
             AdamW numbers, device ms by kind (the trust ratio's norms);
             (ii) one fp32 Learner step of BERT-Base (B = 2) with LAMB on
             the card, its gradients through the CPU's LAMB chain from the
             same parameters: moments within 1e-6, each weight within 2 x
             (an fp32 ulp of the larger of it before and after + 1e-6 of its
             update); (iii) the
             19 registered optimizers, 3 steps on
             BERT-Large-shaped parameters (the (30522, 1024) word
             embedding, a (4096, 1024) and a (1024, 4096) weight, a bias
             and a gamma) from seeded gradients, fp32 and, for the
             elementwise ones, bf16 under ``multi_precision``, through the
             fused ``Trainer`` and a captured ``compile_step``, each against
             the per-parameter update on the CPU (fp32 within 1e-5 of each
             largest entry, bf16 weights within 2^-7; the CPU runs LAMB,
             LARS and LANS on the whole tensors, the other, elementwise or
             row-wise, recurrences on every 16th row); SGLD by its noise's
             mean and variance, and its compiled step taking the eager
             fallback; (iv) ``GroupNorm(32)`` at (32, 256, 56, 56),
             ``InstanceNorm`` and ``ReflectionPad2D(3)`` at (8, 64, 256,
             256), ``RMSNorm`` at (8192, 4096), fp32 and bf16, and the 14
             losses at (1024, 1000) (CTC at T = 400, B = 32, V = 29, labels
             up to 100, an infeasible row), forward and the input's
             gradient on the card against the CPU: fp32 norms within 1e-5
             (forward) and 1e-4 (gradient), bf16 within 2^-7 and 2^-6, the
             losses within 1e-5 (CTC 2e-4, SDML 5e-4) of each largest entry.
13. data — the input pipeline (``gluon.data``, ``metric``, ``callback``,
             ``io``): (i) ``tests/torch_script_mnist.py`` (the JAX package's
             ``examples/gluon_mnist.py``, imports changed, ``mx.gpu()``):
             synthetic MNIST (8192 / 1024), ``DataLoader(num_workers=2)``
             with spawned workers, the hybridized MLP, adam,
             ``metric.Accuracy``, 2 epochs: the loss falls and validation
             accuracy reaches 0.9; (ii) GPT-2 small (fp32, dropout 0, B = 4,
             T = 1024) fed 34 batches of seeded token windows by
             ``DataLoader(batch_size=4, sampler=RandomSampler(n, rng=0),
             num_workers=4, pin_memory=True).device_prefetch(4)`` into
             ``compile_step(...).compile_multi_step(4)``: 8 groups of 4 and
             a trailing group of 2, one capture (the trailing group replays
             the one-step program), ``metric.Loss`` over the losses,
             ``callback.Speedometer(4, frequent=4)`` on ``BatchEndParam``,
             ``metric.Perplexity`` over a 4-batch validation loader through
             the predict-mode forward; flash forward, dK/dV, dQ and
             LayerNorm launches under the ``data`` path; losses and weights
             bitwise equal to a twin fed the same batches by a serial loader,
             stacked by hand on the card; then the step fed by the
             prefetcher (A) and from groups staged before (B), A B B A: wall,
             busy and idle a group, the top kernels of a profiled group, and
             the streams of the H2D copies and their overlap with kernels on
             other streams; (iii) batches a second of the serial, 4-thread
             and 4-process loaders on the token windows and on MNIST through
             ``ToTensor`` and ``Normalize``, and ``Perplexity.update``'s time
             and bytes to the host against ``.asnumpy()`` of the same
             probabilities; (iv) the spawned workers' own reports (no CUDA
             initialised, no GPU visible, no kernel library, arrays on the
             CPU) and ``nvidia-smi --query-compute-apps`` listing none of
             them, a mid-epoch ``state_dict``/``load_state_dict`` resume of
             the prefetcher giving exactly the unconsumed groups, and no
             ``psm_*`` shared-memory segment left in ``/dev/shm``.
14. sparse — A4's remainder, fp32 on the card: (i)
             ``tests/torch_script_sparse.py`` (the JAX package's
             ``examples/sparse_linear.py``, imports changed) at Avazu's
             shape: a synthetic LibSVM file from the seed (262,144 rows,
             1,000,000 features, 15 nonzeros a row, batches balanced),
             ``LibSVMIter(sparse=True)`` through the native parser,
             ``sparse.dot``, the ``nd`` loss, 5 epochs at batch 8192: train
             accuracy > 0.9, the first epoch's losses within 1e-5 of the
             CPU's, every loss within 1e-5 and the accuracy within 1e-3 of
             the same loop in float64 numpy (which also gives the accuracy
             on ``make_synthetic``'s i.i.d. labels), peak memory far under
             a dense batch; parse seconds, rows/s, steps/s, a step of the
             script's loop: wall against device busy and the top device
             operations; (ii) the lazy row-sparse updates of
             SGD, AdaGrad, Adam, Ftrl and GroupAdaGrad on a (1,000,000, 64)
             table, 3 steps whose rows are the feature ids of (i)'s batches,
             through ``Optimizer.update`` and a ``Trainer``: untouched rows
             and states bitwise, touched ones within 1e-6 of the CPU, no
             ``todense`` (also with a bf16 weight under
             ``multi_precision``), ms a step beside the dense update; (iii)
             the sequence ops at (35, 32, 200), DCGAN's generator built of
             ``nn.Conv2DTranspose`` layers (batch 64, z 100 -> 64x64x3):
             each layer forward and backward, the chain's forward eager and
             hybridized, the chain recorded and hybridized, SSD-300's ``box_nms`` (8 x 8,732 x 21 rows,
             top 400, bitwise), ``box_encode``/``decode``, ``roi_align``
             (with its gradient) and ``roi_pooling`` over (2, 256, 50, 50)
             with 256 ROIs an image, ``upsampling``, ``bilinear_resize_2d``
             and ``moments`` at (8, 256, 64, 64), card against CPU within
             1e-5 with their ms, and ``mx.nd.save``/``load`` round-tripped;
             (iv) ``npx.foreach`` over a 2-layer LSTM cell in ``mx.np``
             (word_lm's T 35, B 32, H 200) eagerly (outputs and gradients
             into the data and initial states within 1e-5 of the CPU),
             hybridized (one CUDA graph) and hybridized under ``record()``
             (forward and backward ms),
             ``while_loop`` (``max_iterations``) and ``cond`` hybridized:
             one capture each, replays equal to eager.
15. vision — A9's vision part, fp32 on the card: (i)
             ``ssd_300_mobilenet(num_classes=20)`` at VOC's size (32, 3,
             300, 300; 1944 anchors; labels (32, 8, 5) with 1-8 seeded boxes)
             trained by tests/test_ssd_model.py's loop (``ssd_target``,
             masked NLL plus ``smooth_l1``, SGD with momentum) 10 steps eager
             and 10 hybridized (forward and backward one CUDA graph): the
             losses fall and the two first-step losses agree; a step's wall
             against device busy, img/s and the top device operations;
             ``ssd_detect`` (nms_topk 400) ms at batch 32; at batch 2 the card
             against the CPU: the three outputs, one step's parameter
             gradients held to a float64 CPU twin (within 4x the CPU fp32
             run's own distance from it: a batch-2 training step is
             ill-conditioned in fp32), ``ssd_target`` and
             ``multibox_detection`` on identical inputs (integers bitwise);
             (ii) every name ``get_model`` registers for these families at
             ImageNet input (``inceptionv3`` at 299), batch 32: the output's
             shape, img/s eager and hybridized; one name of each family at
             batch 2, predict and train mode card against CPU, gradients
             against the float64 twin; (iii) the deformable convolution
             layers (DCN's res5 3x3, (1, 512, 38, 63), dilation 2, deformable
             groups 1 and 4), ``psroi_pooling`` and
             ``deformable_psroi_pooling`` on R-FCN's score maps (300 ROIs),
             ``correlation`` at FlowNetC's conv3 (441 displacements),
             ``bilinear_sampler`` and ``grid_generator`` at (16, 64, 96, 96),
             ``PixelShuffle2D`` through SRResNet's two sub-pixel layers
             (bitwise) and ``PixelShuffle1D/3D``: forward and backward, card
             against CPU, with their ms; (iv) the JAX package's STN example
             (tests/torch_script_stn.py) at its own size, hybridized: STN
             accuracy > 0.9 and 0.05 above the fixed warp. The phase's
             seconds are checked against a limit.
16. rnn — A9's RNN stack, fp32 on the card: (i) the PTB-medium LSTM
             language model (``rnn_lm(vocab 10000, embed 650, hidden 650,
             2 layers, dropout 0.5, tied)``, MXNet's word_language_model
             "medium" setting) trained by tests/torch_script_word_lm.py's
             loop (``adam``, ``clip_gradient`` 0.25, states detached
             between batches) at B = 32, T = 35 on a Zipfian synthetic
             stream from the seed, 20 steps eager and 20 hybridized (forward
             and backward one CUDA graph each): the losses fall, the two
             first-step losses agree; a step's wall against device busy,
             the idle share, tokens/s, peak memory, device kernels and host
             launch calls a step, the top device operations; at B = 2 with
             dropout 0 the card's logits and states within 1e-5 of the
             CPU's and each gradient within 1e-4 of its largest (else held
             to a float64 twin); (ii) the ``rnn`` op alone at (35, 32, 650),
             every mode, one and two layers, one and two directions: forward
             and forward+backward ms eager and replayed from a CUDA graph,
             beside cuDNN's (``torch.nn.LSTM``/``GRU``/``RNN`` holding the
             same weights, a measurement only), outputs within 1e-5 of
             cuDNN's; (iii) every cell's ``unroll`` card against CPU, and
             tests/torch_script_word_lm.py at its defaults for one epoch:
             its loss and perplexity. The phase's seconds are checked
             against a limit.
17. legacy — A9 (b)'s legacy tensor tier, fp32 on the card: (i) MXNet's
             legacy-symbol AlexNet (example/image-classification/symbols/
             alexnet.py with LRN after relu1 and relu2, its loss head
             spelled out as MakeLoss; tests/torch_script_legacy_alexnet.py)
             trained at batch 128, 224², 1000 classes through
             ``simple_bind`` / ``forward(is_train=True)`` / ``backward`` /
             ``get_updater(SGD)`` for 12 steps over four seeded batches:
             the loss of the last pass over the batches below the first's;
             a step's wall against device busy, the idle share, img/s,
             peak memory, device kernels and host launch calls a step, the
             top device operations; the predict-mode bind
             (``SoftmaxActivation``) in img/s with rows summing to 1; at
             batch 2 with dropout 0 the loss and probabilities within 1e-5
             of the CPU's and each gradient held to a float64 twin; (ii)
             every name of the tier (tests/torch_legacy_cases.py) card
             against CPU, forward and gradients, and the data-dependent
             names refused with ``MXNetError`` inside a CUDA graph
             capture; (iii) LRN at AlexNet's two sites beside
             ``F.local_response_norm`` (a measurement only), ``linalg_gemm2``,
             ``potrf``, ``trsm``, ``potri`` and ``syevd`` on (256, 64, 64)
             SPD against float64, ``rroi_align`` with 512 rotated ROIs,
             ``boolean_mask`` of BERT's masked rows and ``unique`` of 2^20
             token ids, card against CPU with their ms. The phase's seconds
             are checked against a limit.
18. interleaved — A9 (b)'s ``extra.py`` and ``optimizer_ops.py`` on the
             card: (i) a GluonNLP-style BERT-Base (tests/
             torch_script_interleaved_bert.py: 12 x 768, 12 heads, FFN 3072,
             vocabulary 30522, time-major, one fused QKV ``FullyConnected``
             a layer read by ``interleaved_matmul_selfatt_qk`` /
             ``masked_softmax`` / ``interleaved_matmul_selfatt_valatt``,
             ``arange_like`` positions, ``softmax_cross_entropy`` losses,
             the registry's ``layer_norm`` on the LayerNorm kernel) at B 32
             x T 128 with seeded valid lengths and masked positions, weights
             from a seeded zoo ``.params`` file with ``attn_qkv`` permuted to
             (H, 3, D): (a) the fp32 encoder against the zoo ``bert_base``
             (its flash-attention route) on the same weights within 1e-4 of
             the largest entry; (b) 10 bf16 steps (fp32 masters, ``amp_cast``
             at the embedding output and the logits, ``autograd.record``,
             ``multi_all_finite`` with a dynamic loss scale, one
             ``multi_mp_lamb_update`` written back through ``out=``): the loss
             falls, every step finite; a step's wall against device busy,
             the idle share, tokens/s, peak memory, device kernels and host
             launch calls a step, the top device operations and
             ``multi_mp_lamb_update``'s share of the step, beside phase 9's
             zoo BERT-Base step; (c) at B 2, fp32, the loss within 1e-4 of
             the CPU's, every gradient held to a float64 twin, and the
             masters after one ``multi_mp_lamb_update`` of the same
             gradients within 1e-5; (d) the LayerNorm kernel's launches on
             the steps (26 a step); (ii) every one of the 80 names
             (tests/torch_extra_cases.py) card against CPU, and at model
             sizes with their ms: the interleaved quartet at BERT-Base's
             self-attention and Transformer-base's cross-attention,
             ``im2col``/``col2im`` at a ResNet-50 stage (bitwise with
             ``F.unfold``, beside ``F.fold``), ``multi_mp_lamb_update`` and
             ``multi_mp_adamw_update`` over BERT-Base's tensors beside the
             ``Learner``'s LAMB. The phase's seconds are checked against a
             limit.
19. quantized — A9 (b)'s quantized tier, int8 inference after training:
             (i) BERT-Base (``bert_base(dropout=0)``: 12 x 768, 12 heads,
             FFN 3072, vocabulary 30522, max_length 512, weights from a
             numpy seed) behind a one-argument block that unpacks tokens
             and valid lengths, calibrated by ``contrib.quantization.
             quantize_net(calib_mode="entropy")`` on 2 batches of 8 x 128
             (its 49 ``Dense`` layers to int8 x int8 -> int32 products on
             ``torch._int_mm``) and served at B 32 x T 128: (a) the same
             calibration on the CPU, every layer's scale equal to the
             card's within 1e-5 or, where the KL minimum fell on another
             candidate threshold, within 0.1 (those layers listed); at B 2
             the fp32 sequence outputs within 1e-4 of the largest entry, and
             the CPU's int8 model with the card's scales: the sequence
             output no farther from the CPU's than the CPU's int8 output is
             from its fp32 one (a code that falls on the other side of a
             half moves the next layer's inputs, and more codes fall over
             layer after layer: the share of each layer's codes that differ
             is printed), the first ``attn_qkv``'s input codes differing in
             at most 1e-3 of the entries, every layer's int8 weights and its
             int32 accumulators from the CPU's codes bitwise; (b) the int8
             sequence output against
             the fp32 model's on the card: the largest relative error and
             the cosine, finite; (c) fp32 and int8 forwards eager and
             hybridized (one CUDA graph; the int8 replay equal to eager):
             wall against device busy, idle share, tokens/s, peak memory,
             the int8 GEMMs' share of busy, the top device operations, and
             ``torch._int_mm`` at (4096, 768) x (768, 3072) beside fp32 (TF32
             off) and bf16 ``torch.matmul``; (d) the LayerNorm kernel's
             launches on the int8 path non-zero (the flash forward's
             printed); (ii) ResNet-50 v1 at 224^2 calibrated (``naive``) on
             one batch of 32, its 53 convolutions through the reference's
             route (codes in float32 through cuDNN) and its Dense in int8:
             naive scales card vs CPU within 1e-5; at batch 2 the fp32 logits
             within 1e-3 of the largest and the int8 logits with the card's
             scales no farther from the CPU's than the CPU's int8 logits are
             from its fp32 ones; img/s int8 beside fp32, eager; (iii)
             the 43 names (tests/torch_quantized_cases.py) card against CPU,
             integer outputs bitwise, and at model sizes with their ms:
             ``quantized_conv`` at ResNet-50's stage-2 3x3 (32, 128, 28, 28)
             x (128, 128, 3, 3) beside fp32 ``F.conv2d``,
             ``quantized_fully_connected_v2`` and ``intgemm_fully_connected``
             at BERT-Base's FFN (4096, 768) x (3072, 768), bitwise. The
             phase's seconds are checked against a limit.
20. image — A10 (3)'s image pipeline and ``ops/graph_image_ops.py``: (i)
             1,280 seeded photo-like JPEGs (300-499 px a side, quality 95,
             labels in [0, 1000)) packed by the port's ``recordio`` into an
             indexed ``.rec`` (tests/torch_image_cases.py), read by
             ``io.ImageRecordIter`` at MXNet's ImageNet recipe (224 crops of
             the shorter edge resized to 256, random crop and mirror, the
             ImageNet mean and std, batch 128, shuffled): img/s of the
             iterator alone at 1, 4 and 8 decode threads beside the host's
             cores, batches of 1 and 8 threads bitwise equal, one image's
             stages on one thread (the draws, PIL's decode, the whole
             decode and augmentation), a batch landed on the card equal to
             the host's; then ResNet-50 v1 (full width and depth, weights
             from a numpy seed) through phase 7's AMP ``compile_step``, 8
             steps fed by the iterator (at the thread count that read
             fastest) and the same 8 on pre-staged batches: step wall, device busy, idle share,
             img/s and peak memory of each, losses finite, one capture;
             (ii) 256 VOC-sized (500 x 375) JPEGs with 1-6 boxes in the
             reference's detection label layout, read through
             ``ImageRecordDataset`` and GluonCV's SSD training transform as
             ``gluon.contrib.data.vision`` blocks (expand, crop with
             constraints, flip, resize 300) by ``ImageBboxDataLoader``
             (batch 32, 4 spawned workers, Python's ``random`` seeded a
             sample): the pool's start seconds and batches/s, the workers'
             first batch equal to a serial loader's, and 4 steps of phase
             15's hybridized ``ssd_300_mobilenet(20)`` fed by it with each
             step's wall, busy and idle share; (iii) the 40 names card
             against CPU: ``sldwin_atten_score`` -> ``_context`` forward and
             backward at (1, 512, 12, 64), w 128, dilations 1-4 by head,
             symmetric and causal, within 1e-5; their ms and peak memory at
             Longformer-base's (1, 4096, 12, 64), w 256, beside a dense
             masked ``torch.matmul`` attention's ms (a reference point, not
             a bound); the DGL ops on a seeded CSR of 20,000 vertices and
             200,000 edges (the adjacency of a 2,000-vertex subgraph) and the
             image and cv ops on a 500 x 375 image, bitwise. No port kernel
             lies on the path: the launch counters stay 0. The phase's
             seconds are checked against a limit.

``python3 chip_smoke.py kernels bert_pretrain`` (or any of ``kernels``,
``resnet``, ``predictor``, ``bert_pretrain``, ``graph``, ``script``,
``optim``, ``data``, ``sparse``, ``vision``, ``rnn``, ``legacy``,
``interleaved``, ``quantized``, ``image``; ``script`` runs phase 4 first, for its weights,
batches and losses, and ``optim`` phase 9's AdamW Large bench) runs the
build and the named phases only, and prints no result line. The lines before the last give the card's name and
power limit and a JSON object of every kernel's numbers with its launches on
each path (serve, train, train_compiled, train_amp and nd (serve: the warm
call and the capture of each program; the compiled steps: the warm step and
the capture; replays move no counter), train_amp_converted, tune, rtc,
resnet (all 0), predictor (the traces, warm calls and captures),
bert_pretrain (the two benches' warm steps and captures), graph (the
traces, warm calls and captures; also the row's ``graph`` key), script
(phase 11: its eager steps, warm calls and captures; also the row's
``script`` key), optim (phase 12 (i)'s bench and (ii)'s step: warm steps
and captures; also the row's ``optim`` key), data (phase 13 (ii): the
compiled step's warm step and capture and the predict-mode forwards; also
the row's ``data`` key), sparse (phase 14: no port kernel
on it; also the row's ``sparse`` key), vision (phase 15: no port kernel on it;
also the row's ``vision`` key), rnn (phase 16: no port kernel on it; also
the row's ``rnn`` key), legacy (phase 17 (i): no port kernel on it; also
the row's ``legacy`` key), interleaved (phase 18 (i) (b)'s steps: the
LayerNorm kernel; also the row's ``interleaved`` key), quantized (phase 19
(i)'s int8 BERT-Base forwards, eager, and the hybridized warm call and
capture: the flash forward and LayerNorm kernels; also the row's
``quantized`` key), image (phase 20 (i) and (ii)'s training: no port kernel
on it; also the row's ``image`` key); a row
counts the launches of its dtype instance: fp32 x, or bf16 x for a ``:bf16``
row); the last line is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as onp

SEED = 0
PEAK_FP32_FLOPS = 67e12    # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM tensor cores, TF32, dense
PEAK_BF16_FLOPS = 989e12   # H100 SXM tensor cores, bf16 and fp16, dense
PEAK_FP8_FLOPS = 1979e12   # H100 SXM tensor cores, fp8, dense
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FLASH_TOL = 1e-4
LN_TOL = 1e-5
SOFTMAX_TOL = 1e-6
BF16_RTOL = 8e-3           # one bf16 ulp of the value: a relative limit
BF16_ATOL = 1e-7
RTC_RTOL = 1e-6
LOGIT_RTOL = 1e-3
GRAD_RTOL = 1e-3
NEAR_TIE = 1e-3
TRAIN_STEPS = 30
TRAIN_LR = 3e-4            # AdamW peak, GPT-3's beta2 = 0.95, 5 warm-up
TRAIN_WARMUP = 5           # steps, then a cosine to TRAIN_LR / 10
TRAIN_SHAPE = (4, 1024)    # batch rows x tokens: GPT-2's own context
TRAIN_WANT = {"flash_fwd": 12, "flash_bwd_dkv": 12, "flash_bwd_dq": 12,
              "layer_norm": 25, "softmax": 0}   # launches a training step
COMPILED_RTOL = 2e-4       # compiled vs eager step: the reference's
COMPILED_ATOL = 1e-6       # cross-program bound (tests/test_train_step.py)
DEV = "cuda"


# launches by (kernel, operand dtypes) of each path's run, for the JSON line
PATH_DTYPES = {}


class SmokeError(Exception):
    pass


def read_counts(path):
    """The kernels' launches since the last reset (``launch_counts``); their
    launches by operand dtypes are kept under ``path`` for the JSON line."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    PATH_DTYPES[path] = ck.dtype_counts()
    return ck.launch_counts()


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=50, rounds=5):
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, the median of ``rounds`` such bursts. Where the
    host launches slower than the card runs, this is the launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_ms(fn, kernel_name, reps=20):
    """Device time per call of the CUDA kernel whose name contains
    ``kernel_name``, in any case (launched once a call), from ``torch.profiler``
    (CUPTI); None when the profiler records no device time for it on this
    machine. CUPTI can drop kernel records: the mean is over the records
    kept, and a shortfall is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name.lower() in evt.key.lower():
            us += getattr(evt, "device_time_total",
                          getattr(evt, "cuda_time_total", 0.0))
            n += evt.count
    if n != reps:
        log(f"[profiler] {kernel_name}: {n} kernel records for {reps} calls")
    return us / n / 1e3 if us > 0 else None


def device_total_ms(fn, reps=10):
    """Device time per call of every kernel ``fn`` launches, summed, from
    ``torch.profiler`` (CUPTI); None when the profiler recorded no kernel
    (CUPTI can drop records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def bound_ms(n_bytes, n_flops, peak=PEAK_FP32_FLOPS):
    """Least time on the card: bytes at the memory rate or operations at
    ``peak`` (default the fp32 CUDA-core rate), whichever is longer."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def attention_bound_ms(n_bytes, n_flops, dtype):
    """The least time for attention at its dtype's accuracy: fp32-accurate
    products on the tensor cores take three TF32 products each (3xTF32),
    bf16 and fp16 one product at their rate, fp8 one at fp8's. Returns
    (ms, "bytes" or "operations", the CUDA-core bound of the same work at
    the fp32 rate)."""
    import torch

    if dtype == torch.float32:
        ms, by = bound_ms(n_bytes, 3 * n_flops, PEAK_TF32_FLOPS)
    elif dtype.itemsize == 1:
        ms, by = bound_ms(n_bytes, n_flops, PEAK_FP8_FLOPS)
    else:
        ms, by = bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS)
    return ms, by, bound_ms(n_bytes, n_flops)[0]


def graph_ms(fn, reps=20, rounds=5):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed between CUDA events, the median of ``rounds``
    replays. The host's launch cost is out of it, so a kernel faster than
    the host launches it reads at its own time."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build():
    """Build every kernel; returns what ptxas and cuobjdump report for each
    tensor-core kernel: the registers and spill line of the default
    (32, 32) fp32 instance at D = 64, the most registers and spill bytes of
    any instance, and the HMMA count."""
    from mxnet_tpu_torch.ops import _build

    info = {}
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(_build.SOURCES)} libraries in "
        f"{time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for name, cmd, secs, report in _build.build_log:
        log(f"[build] {name}: {secs:.2f} s: {' '.join(cmd)}")
        entries = _ptxas_entries(report)
        regs = [r for _, r, _ in entries]
        spills = [f"{e}: {sp}" for e, _, sp in entries
                  if sp and " 0 bytes spill stores" not in sp]
        log(f"[build]   {len(regs)} kernel instances, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{len(spills)} spill")
        for sp in spills:
            log(f"[build]   spills: {sp}")
        if name in TENSOR_CORE_KERNELS:
            info[name] = _tensor_core_build_report(name, entries, libs[name])
    return info


TENSOR_CORE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _ptxas_entries(report):
    """(entry, registers, spill line) of each kernel in a ptxas -v report:
    "Function properties for <entry>", then its stack and spill line, then
    "Used N registers"."""
    entries, entry, spill = [], None, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            entry, spill = line.split("for", 1)[1].strip(), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            entries.append((entry, int(line.split("Used", 1)[1].split()[0]),
                            spill))
    return entries


def _tensor_core_build_report(name, entries, lib):
    """ptxas's registers and spill bytes of the tensor-core kernel
    ``name``'s instances at head dim 64, and the tensor-core (HMMA)
    instructions cuobjdump finds in its library, where the toolkit has
    cuobjdump; fails if it finds none. Returns the numbers for the JSON
    line."""
    from pathlib import Path

    from mxnet_tpu_torch.ops import _build

    pattern = re.compile(
        name + r"_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E")
    info = {"registers_max": max((r for _, r, _ in entries), default=0),
            "spill_bytes_max": max((int(sp.split(",")[1].split()[0])
                                    for _, _, sp in entries
                                    if "spill stores" in sp), default=0)}
    for entry, regs, spill in entries:
        m = pattern.search(entry or "")
        if m and m.group(2) == "64":
            dtype, _, bq, bk = m.groups()
            log(f"[build]   {name} {'fp32' if dtype == 'f' else 'bf16'} "
                f"D=64 block_q={bq} block_k={bk}: {regs} registers; {spill}")
            if (dtype, bq, bk) == ("f", "32", "32"):
                info["registers_fp32_d64_default"] = regs
                info["spill_fp32_d64_default"] = spill
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        log(f"[build]   {name}: no cuobjdump beside nvcc ({tool}): the "
            f"tensor-core instructions are not counted")
        return info
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma = re.findall(r"\bHMMA\.\S+", sass)
    log(f"[build]   {name} library: {len(hmma)} tensor-core (HMMA) "
        f"instructions, {sorted(set(hmma))}, in "
        f"{sass.count('Function : ')} kernel instances")
    check(hmma, f"{name}: no tensor-core instruction in the library")
    info["hmma"] = len(hmma)
    return info


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg):
    import torch

    q, k, v = (torch.from_numpy(rng.randn(B, H, T, D).astype("float32"))
               .to(dev) for T in (Tq, Tk, Tk))
    if not seg:
        return q, k, v, None, None
    # right-padded tails of different lengths, as a prefill batch has
    valid = [Tk - (i * Tk) // (2 * B) for i in range(B)]
    ks = onp.zeros((B, Tk), "int32")
    for i, n in enumerate(valid):
        ks[i, :n] = 1
    qs = onp.ones((B, Tq), "int32")
    qs[B - 1, 0] = 7    # a query row whose id no key shares: fully masked
    return (q, k, v, torch.from_numpy(qs).to(dev),
            torch.from_numpy(ks).to(dev))


def _visible_pairs(qs, ks, B, H, Tq, Tk, causal):
    import torch

    dev = qs.device if qs is not None else "cuda"
    mask = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
    if causal:
        mask &= torch.ones((Tq, Tk), dtype=torch.bool,
                           device=dev).tril(Tk - Tq)
    if qs is not None:
        mask &= qs[:, :, None] == ks[:, None, :]
    return mask, int(mask.sum()) * H


def _sdpa_mask_args(mask, causal, seg, Tq, Tk):
    """SDPA's mask arguments for the visible pairs ``mask`` (B, Tq, Tk):
    ``is_causal`` where the mask is causal alone, else the boolean mask."""
    if causal and not seg and Tq == Tk:
        return {"is_causal": True}
    return {"attn_mask": mask[:, None]}


def _dtype_row(row, suffix, dtype, numbers, err):
    """The JSON row of a kernel's ``dtype`` instance: ``row``'s name with
    ``:suffix``, its source and what it replaces, and ``numbers``."""
    out = {"name": f"{row['name']}:{suffix}", "route": row["route"],
           "source": row["source"], "replaces": row["replaces"],
           "max_abs_err": err, "dtype": dtype}
    out.update(numbers)
    return out


def _bf16_row(row, numbers, err):
    """The JSON row of a kernel's bf16 instance at the AMP training shape."""
    return _dtype_row(row, "bf16", "bfloat16", numbers, err)


def dkv_float64(q, k, v, g, qs, ks, scale, causal):
    """dK and dV in float64 on the card from the dense identities, the
    ground truth that the kernel and the plain fp32 version round away
    from; (B, H, Tk, D) each."""
    import torch

    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    mask = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)[0][:, None]
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    s = torch.where(mask, s, torch.full_like(s, -1e300))
    p = torch.softmax(s, dim=-1) * mask
    delta = (gd * torch.matmul(p, vd)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gd, vd.transpose(-1, -2)) - delta) * scale
    return (torch.matmul(ds.transpose(-1, -2), qd),
            torch.matmul(p.transpose(-1, -2), gd))


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    rng = onp.random.RandomState(SEED)
    results = {}

    results["flash_fwd"], results["flash_fwd:bf16"] = _flash_fwd_rows(rng,
                                                                      dev)

    # -- fused LayerNorm ----------------------------------------------------
    d = 768
    main = None
    ln_err = 0.0
    for rows in (1, 8, 2000, 2048, 4096):
        x = torch.from_numpy((rng.randn(rows, d) * 2 + 0.5)
                             .astype("float32")).to(dev)
        g = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
        b = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
        out = ck.layer_norm_cuda(x, g, b, 1e-5)
        ref = ck.layer_norm_plain(x, g, b, 1e-5)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(err <= LN_TOL,
              f"layer_norm rows={rows}: max |diff| {err:.3g} > {LN_TOL}")
        ln_err = max(ln_err, err)
        def kernel():
            ck.layer_norm_cuda(x, g, b, 1e-5)

        ms = time_ms(kernel)
        dev_ms = device_ms(kernel, "layer_norm_kernel")
        plain_ms = time_ms(lambda: ck.layer_norm_plain(x, g, b, 1e-5))
        def library():
            F.layer_norm(x, (d,), g, b, 1e-5)

        lib_ms = time_ms(library)
        lib_dev_ms = device_ms(library, "layer_norm")
        bms, by = bound_ms(4 * (2 * rows * d + 2 * d), 8 * rows * d)
        log(f"[kernels] layer_norm rows={rows} d={d}: max|diff| {err:.3g};"
            f" kernel {ms:.4f} ms (device {dev_ms}), plain {plain_ms:.4f} "
            f"ms, F.layer_norm {lib_ms:.4f} ms (device {lib_dev_ms}), bound "
            f"{bms:.5f} ms ({by})")
        if rows == 2048:
            main = (ms, plain_ms, lib_ms, bms, by, dev_ms, lib_dev_ms)
    results["layer_norm"] = {
        "name": "layer_norm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/layer_norm.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:866",
        "max_abs_err": ln_err, "ms": main[0], "plain_ms": main[1],
        "library_ms": main[2], "bound_ms": main[3], "bound_by": main[4],
        "device_ms": main[5], "library_device_ms": main[6],
        "shape": "x (4*512, 768) fp32, gamma/beta (768,) fp32"}
    results["layer_norm:bf16"] = _layer_norm_bf16_row(rng, dev,
                                                      results["layer_norm"])
    # BERT's serving instance: bf16 gamma/beta (a cast block) at eps 1e-12
    # on the rows of bucket 32 (32 x 128 tokens)
    bert_ln = _layer_norm_bf16_row(rng, dev, results["layer_norm"],
                                   rows=32 * 128, gamma_dtype="bfloat16",
                                   eps=1e-12)
    results["layer_norm:bf16"]["more"] = [
        {k: bert_ln[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                                 "device_ms", "plain_ms", "library_ms",
                                 "library_device_ms", "bound_ms",
                                 "bound_by")}]
    results.update(_flash_bwd_rows(rng, dev))
    results["softmax"] = _softmax_row(rng, dev)
    _every_tile(rng, dev)
    results["flash_fwd"]["more"].extend(_flash_fwd_bert_tiles(rng, dev))
    for (name, dtype), more in _flash_bwd_bert_tiles(rng, dev).items():
        row = results[name if dtype == torch.float32 else name + ":bf16"]
        row.setdefault("more", []).extend(more)
    _low_precision_rows(rng, dev, results)
    return results


def _layer_norm_bf16_row(rng, dev, row, rows=4096,
                         gamma_dtype="float32", eps=1e-5):
    """LayerNorm with bf16 x and fp32 gamma/beta, as a block converted by
    ``amp.convert_hybrid_block`` runs it, at the training step's rows
    (4*1024, 768); or with bf16 gamma/beta (``gamma_dtype``), as a block
    cast to bf16 runs it (BERT served after ``cast``, eps 1e-12): the
    kernel's other load path. The kernel normalises in fp32 and rounds
    once; the plain version (the reference's ``_ln_reference``) rounds
    x - mean and its product with 1/sigma to bf16 first, and with bf16
    gamma/beta also the product with gamma and the sum with beta. So both
    are held to a float64 answer from the same bf16 x and the same gamma
    and beta: the kernel within one bf16 rounding (2^-8 |exact|) plus
    fp32's error (2^-18 of the scale below), the plain version within four
    bf16 roundings with fp32 gamma/beta, six with bf16 ones (2^-8 each of
    the scale (|x_hat| + |mean| / sigma) |gamma| + |beta|), and to each
    other by the sum of the two, each with 1e-6 beside it."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    d = 768
    gdt = getattr(torch, gamma_dtype)
    x = torch.from_numpy((rng.randn(rows, d) * 2 + 0.5).astype("float32")) \
        .to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.randn(d).astype("float32")).to(dev, gdt)
    b = torch.from_numpy(rng.randn(d).astype("float32")).to(dev, gdt)
    out = ck.layer_norm_cuda(x, g, b, eps)
    ref = ck.layer_norm_plain(x, g, b, eps)
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    sigma = torch.sqrt(xd.var(-1, unbiased=False, keepdim=True) + eps)
    xhat = (xd - mu) / sigma
    exact = xhat * g.double() + b.double()
    # what the plain version's roundings are relative to: x_hat gamma,
    # beta, and the bf16 mean's rounding carried through gamma / sigma
    scale = (xhat.abs() + mu.abs() / sigma) * g.double().abs() + \
        b.double().abs()
    check(out.dtype == ref.dtype == torch.bfloat16,
          f"layer_norm bf16 x: output dtypes {out.dtype}, {ref.dtype}")
    lim_k = 2 ** -8 * exact.abs() + 2 ** -18 * scale + 1e-6
    lim_p = (4 if gdt == torch.float32 else 6) * 2 ** -8 * scale + 1e-6
    over_k = float(((out.double() - exact).abs() - lim_k).max())
    over_p = float(((ref.double() - exact).abs() - lim_p).max())
    over_kp = float(((out.double() - ref.double()).abs()
                     - (lim_k + lim_p)).max())
    err = float((out.float() - ref.float()).abs().max())
    what = (f"bf16 x, {dict(float32='fp32', bfloat16='bf16')[gamma_dtype]} "
            f"gamma/beta, eps {eps:g}")
    check(max(over_k, over_p, over_kp) <= 0.0,
          f"layer_norm {what}: beyond the limits by "
          f"kernel {over_k:.3g}, plain {over_p:.3g}, kernel vs plain "
          f"{over_kp:.3g}")

    def kernel():
        ck.layer_norm_cuda(x, g, b, eps)

    g16, b16 = g.to(x.dtype), b.to(x.dtype)

    def library():
        F.layer_norm(x, (d,), g16, b16, eps)

    ms = time_ms(kernel)
    dev_ms = device_ms(kernel, "layer_norm_kernel")
    plain_ms = time_ms(lambda: ck.layer_norm_plain(x, g, b, eps))
    lib_ms = time_ms(library)
    lib_dev_ms = device_total_ms(library)
    bms, by = bound_ms(2 * 2 * rows * d + g.element_size() * 2 * d,
                       8 * rows * d)
    log(f"[kernels] layer_norm rows={rows} d={d} {what}: over the limits "
        f"by kernel {over_k:.3g}, plain {over_p:.3g}, kernel vs plain "
        f"{over_kp:.3g}; "
        f"max|diff| from plain {err:.3g}; kernel {ms:.4f} ms (device "
        f"{dev_ms}), plain {plain_ms:.4f} ms, F.layer_norm (gamma/beta in "
        f"bf16) {lib_ms:.4f} ms (device {lib_dev_ms}), bound "
        f"{bms:.5f} ms ({by})")
    out_row = _bf16_row(row, {
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
        "bound_ms": bms, "bound_by": by,
        "shape": f"x ({rows}, {d}) bf16, gamma/beta ({d},) "
                 f"{gamma_dtype}, eps {eps:g}"}, err)
    out_row["dtype"] = f"bfloat16 x, {gamma_dtype} gamma/beta"
    return out_row


FWD_DESIGN = ("mma.sync m16n8k8 TF32 tensor cores for S = QK^T and PV, "
              "fp32 as 3xTF32 (hi/lo split, three products), bf16 one "
              "product; a warp per 16 query rows, K/V tiles by cp.async "
              "into a two-stage shared-memory ring, online softmax on the "
              "accumulator fragments (log2 units), P fed from the S "
              "fragments in a permuted key order")


def _flash_fwd_rows(rng, dev):
    """The flash-attention forward against its plain version at GPT-2
    prefill and training shapes, fp32 held to FLASH_TOL, bf16 to one bf16
    step of the largest value (LSE to FLASH_TOL); times by CUDA events
    (back to back and CUDA-graph replays) and the profiler, beside SDPA's.
    (48, 512, 64) fp32 causal + ids gives the JSON row; (48, 1024, 64) fp32
    and (48, 512, 64) bf16 stand in it under "more". The bf16 instance at
    the AMP training shape, (48, 1024, 64) causal, gives a row of its own
    (returned second), beside SDPA's bf16 device time. Where the mask is
    causal alone, SDPA runs with ``is_causal=True`` (its fastest form of
    the same function), else with the boolean mask."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, D = 4, 12, 64
    f32, bf16 = torch.float32, torch.bfloat16
    err = bf16_err = 0.0
    rows = {}
    for Tq, Tk, causal, seg, dtype in [(128, 128, True, True, f32),
                                       (384, 384, True, True, f32),
                                       (512, 512, True, True, f32),
                                       (1000, 1000, True, True, f32),
                                       (1024, 1024, True, True, f32),
                                       (384, 1000, False, False, f32),
                                       (512, 512, True, True, bf16),
                                       (1024, 1024, True, False, bf16)]:
        q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        scale = 1.0 / D ** 0.5
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)
        ref, ref_lse = ck.attention_plain(q, k, v, scale, causal, qs, ks)
        torch.cuda.synchronize()
        e_out = float((out.float() - ref.float()).abs().max())
        e_lse = float((lse - ref_lse).abs().max())
        what = f"flash_fwd T=({Tq},{Tk}) causal={causal} {dtype}"
        if dtype == f32:
            check(max(e_out, e_lse) <= FLASH_TOL, f"{what}: max |diff| out "
                  f"{e_out:.3g}, lse {e_lse:.3g} > {FLASH_TOL}")
            err = max(err, e_out, e_lse)
        else:
            # both sides round one fp32 value to 8 bits: one bf16 step
            step = 2 ** -7 * max(float(ref.float().abs().max()), 1.0)
            check(e_out <= step and e_lse <= FLASH_TOL,
                  f"{what}: max |diff| out {e_out:.3g} (limit {step:.3g}), "
                  f"lse {e_lse:.3g} (limit {FLASH_TOL})")
            bf16_err = max(bf16_err, e_out, e_lse)
        if seg:
            check(float(out[B - 1, :, 0].float().abs().max()) == 0.0,
                  f"{what}: the fully masked row is not zero")
        mask, pairs = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)
        sdpa_args = _sdpa_mask_args(mask, causal, seg, Tq, Tk)

        def kernel():
            ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, scale=scale, **sdpa_args)

        ms = time_ms(kernel)
        g_ms = graph_ms(kernel)
        dev_ms = device_ms(kernel, "flash_fwd_kernel")
        plain_ms = time_ms(lambda: ck.attention_plain(q, k, v, scale,
                                                      causal, qs, ks))
        lib_ms = time_ms(sdpa)
        lib_g_ms = graph_ms(sdpa)
        n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                      + out.numel()) + 4 * lse.numel() + (
            4 * (qs.numel() + ks.numel()) if seg else 0)
        bms, by, core_ms = attention_bound_ms(n_bytes, 4 * D * pairs, dtype)
        log(f"[kernels] flash_fwd B*H={B * H} Tq={Tq} Tk={Tk} D={D} "
            f"causal={causal} seg={seg} {dtype}: max|diff| out {e_out:.3g}, "
            f"lse {e_lse:.3g}; kernel {ms:.4f} ms (graph {g_ms:.4f}, "
            f"profiler {dev_ms}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
            f"ms (graph {lib_g_ms:.4f}), bound {bms:.4f} ms ({by}; "
            f"{'3xTF32' if dtype == f32 else 'bf16'} tensor cores, "
            f"{100 * bms / g_ms:.1f} % reached; CUDA-core bound "
            f"{core_ms:.4f} ms), {pairs} visible pairs")
        if (seg and Tq == Tk and Tq in (512, 1024)) or (
                dtype == bf16 and Tq == 1024):
            rows[(Tq, dtype)] = {
                "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_graph_ms": lib_g_ms, "bound_ms": bms,
                "bound_by": by, "cuda_core_bound_ms": core_ms,
                "shape": f"q/k/v ({B}*{H}, {Tq}, {D}) "
                         f"{'fp32' if dtype == f32 else 'bf16'}, causal"
                         f"{' + segment ids' if seg else ''}"}
            if not seg:
                lib_dev = device_total_ms(sdpa)
                rows[(Tq, dtype)]["library_device_ms"] = lib_dev
                log(f"[kernels] flash_fwd {dtype} T={Tq} causal: SDPA "
                    f"(is_causal) device {lib_dev} ms")
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/flash_fwd.cuh",
           "replaces": "mxnet_tpu/ops/pallas_kernels.py:163",
           "max_abs_err": err, "design": FWD_DESIGN}
    row.update(rows[(512, f32)])
    row["more"] = [rows[(1024, f32)], rows[(512, bf16)]]
    return row, _bf16_row(row, rows[(1024, bf16)], bf16_err)


def _softmax_row(rng, dev):
    """The softmax kernel against its plain version: GPT-2 width and
    vocabulary width, f32 and bf16, ragged row counts, both sides of the
    wide path's threshold (d = 4095 one warp a row, 4096 one cluster a row)
    and odd widths, whose rows start off 16-byte boundaries; times at
    (4096, 768) fp32 give the JSON row, (64, 50257) fp32 and bf16 (the wide
    path) stand in it under "more". Beside each kernel time stands
    ``torch.softmax``'s on the same input, device time against device time
    (profiler and CUDA-graph replays)."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    err = 0.0
    rows_out = {}
    for rows, d in ((4096, 768), (64, 50257), (1, 50257), (1, 768),
                    (1001, 768), (3, 4095), (3, 4096), (5, 4097),
                    (7, 8191)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.randn(rows, d).astype("float32")).to(
                dev, dtype)
            out = ck.softmax_cuda(x)
            ref = ck.softmax_plain(x)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            e = float(diff.max())
            what = f"softmax ({rows}, {d}) {dtype} " \
                   f"{'wide' if d >= 4096 else 'narrow'} path"
            if dtype == torch.float32:
                check(e <= SOFTMAX_TOL, f"{what}: max |diff| {e:.3g} > "
                      f"{SOFTMAX_TOL}")
                err = max(err, e)
            else:
                # relative: at vocabulary width a value is ~2e-5, so an
                # absolute limit would pass a kernel that wrote zeros
                over = float((diff - BF16_RTOL * ref.float().abs()).max())
                check(over <= BF16_ATOL,
                      f"{what}: |diff| exceeds {BF16_RTOL} |ref| + "
                      f"{BF16_ATOL} by {over:.3g}")
            if (rows, d) not in ((4096, 768), (64, 50257)) or (
                    d == 768 and dtype != torch.float32):
                log(f"[kernels] {what}: max|diff| {e:.3g}")
                continue

            def kernel():
                ck.softmax_cuda(x)

            def library():
                torch.softmax(x, dim=-1)

            ms = time_ms(kernel)
            g_ms = graph_ms(kernel)
            dev_ms = device_ms(kernel, "softmax")
            plain_ms = time_ms(lambda: ck.softmax_plain(x))
            lib_ms = time_ms(library)
            lib_g_ms = graph_ms(library)
            lib_dev_ms = device_ms(library, "softmax")
            es = x.element_size()
            bms, by = bound_ms(2 * rows * d * es, 4 * rows * d)
            log(f"[kernels] {what}: max|diff| {e:.3g}; kernel {ms:.4f} ms "
                f"(graph {g_ms:.5f}, profiler {dev_ms}), plain "
                f"{plain_ms:.4f} ms, torch.softmax {lib_ms:.4f} ms (graph "
                f"{lib_g_ms:.5f}, profiler {lib_dev_ms}), bound {bms:.5f} ms "
                f"({by}, {100 * bms / g_ms:.1f} % reached)")
            rows_out[(rows, d, dtype)] = {
                "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_graph_ms": lib_g_ms,
                "library_device_ms": lib_dev_ms, "bound_ms": bms,
                "bound_by": by,
                "shape": f"x ({rows}, {d}) "
                         f"{'fp32' if dtype == torch.float32 else 'bf16'}, "
                         f"{'one cluster of 8 blocks' if d >= 4096 else 'one warp'}"
                         f" a row"}
    row = {"name": "softmax", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/softmax.cu",
           "replaces": "mxnet_tpu/ops/pallas_kernels.py:971",
           "max_abs_err": err}
    row.update(rows_out[(4096, 768, torch.float32)])
    row["more"] = [rows_out[(64, 50257, torch.float32)],
                   rows_out[(64, 50257, torch.bfloat16)]]
    return row


def _every_tile(rng, dev):
    """Every kernel once at each tile of its legal set, at one shape,
    against its plain version: a tile the tuner may pick is held to the
    math before it can win. Flash: q/k/v/g (4*12, 512, 64) fp32 causal with
    padding ids and a fully masked row; row kernels: (2000, 768) fp32."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, T, D = 4, 12, 512, 64
    scale = 1.0 / D ** 0.5
    q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, T, T, D, True)
    g = torch.from_numpy(rng.randn(B, H, T, D).astype("float32")).to(dev)
    ref, ref_lse = ck.attention_plain(q, k, v, scale, True, qs, ks)
    times = {}
    for bq in ck.FLASH_BLOCKS:
        for bk in ck.FLASH_BLOCKS:
            out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, True, bq, bk)
            grads = ck.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale,
                                      True, bq, bk)
            want = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks,
                                          scale, True)
            torch.cuda.synchronize()
            e_fwd = max(float((out - ref).abs().max()),
                        float((lse - ref_lse).abs().max()))
            e_bwd = max(float((a - b).abs().max())
                        for a, b in zip(grads, want))
            check(max(e_fwd, e_bwd) <= FLASH_TOL,
                  f"flash tile (block_q={bq}, block_k={bk}): max |diff| "
                  f"fwd {e_fwd:.3g}, bwd {e_bwd:.3g} > {FLASH_TOL}")
            delta = (g * out).sum(dim=-1)
            args = (q, k, v, g, lse, delta, qs, ks, scale, True, bq, bk)
            times[(bq, bk)] = [
                graph_ms(lambda: ck.flash_fwd_cuda(q, k, v, qs, ks, scale,
                                                   True, bq, bk), rounds=3),
                graph_ms(lambda: ck.flash_bwd_dkv_cuda(*args), rounds=3),
                graph_ms(lambda: ck.flash_bwd_dq_cuda(*args), rounds=3),
                e_fwd, e_bwd]
    for (bq, bk), (f, dkv, dq, e_fwd, e_bwd) in times.items():
        log(f"[kernels] tile block_q={bq} block_k={bk} at (48, 512, 64) "
            f"causal + ids: max|diff| fwd {e_fwd:.3g}, bwd {e_bwd:.3g}; "
            f"graph ms flash_fwd {f:.4f}, flash_bwd_dkv {dkv:.4f}, "
            f"flash_bwd_dq {dq:.4f}")
    rows, d = 2000, 768
    x = torch.from_numpy(rng.randn(rows, d).astype("float32")).to(dev)
    gam = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    bet = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    ln_ref = ck.layer_norm_plain(x, gam, bet, 1e-5)
    sm_ref = ck.softmax_plain(x)
    for br in ck.ROW_BLOCKS:
        e_ln = float((ck.layer_norm_cuda(x, gam, bet, 1e-5, br) - ln_ref)
                     .abs().max())
        e_sm = float((ck.softmax_cuda(x, br) - sm_ref).abs().max())
        check(e_ln <= LN_TOL and e_sm <= SOFTMAX_TOL,
              f"row tile block_rows={br}: max |diff| layer_norm {e_ln:.3g}"
              f" (limit {LN_TOL}), softmax {e_sm:.3g} (limit "
              f"{SOFTMAX_TOL})")
        t_ln = time_ms(lambda: ck.layer_norm_cuda(x, gam, bet, 1e-5, br),
                       reps=20, rounds=3)
        t_sm = time_ms(lambda: ck.softmax_cuda(x, br), reps=20, rounds=3)
        log(f"[kernels] tile block_rows={br} at (2000, 768): max|diff| "
            f"layer_norm {e_ln:.3g}, softmax {e_sm:.3g}; ms layer_norm "
            f"{t_ln:.4f}, softmax {t_sm:.4f}")


def _flash_fwd_bert_tiles(rng, dev):
    """The flash forward at BERT-Base's serving shape, q/k/v (32*12, 128,
    64), non-causal with key-padding segment ids (q ids 1, kv ids 1 below
    each row's valid length of 16-128, one row of length 0: every key
    masked, zeros out), fp32 and bf16, against its plain version at every
    legal tile (fp32 FLASH_TOL, bf16 one bf16 step of the largest value);
    returns the default tile's numbers for the JSON row's "more"."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, T, D = 32, 12, 128, 64
    scale = 1.0 / D ** 0.5
    valid = rng.randint(16, T + 1, size=B)
    valid[-1] = 0
    ks = torch.from_numpy((onp.arange(T)[None] < valid[:, None])
                          .astype("int32")).to(dev)
    qs = torch.ones_like(ks)
    mask, pairs = _visible_pairs(qs, ks, B, H, T, T, False)
    out_rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.randn(B, H, T, D).astype("float32"))
                   .to(dev).to(dtype) for _ in range(3))
        ref, ref_lse = ck.attention_plain(q, k, v, scale, False, qs, ks)
        errs = []
        for bq in ck.FLASH_BLOCKS:
            for bk in ck.FLASH_BLOCKS:
                out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, False,
                                             bq, bk)
                torch.cuda.synchronize()
                e_out = float((out.float() - ref.float()).abs().max())
                e_lse = float((lse - ref_lse).abs().max())
                limit = FLASH_TOL if dtype == torch.float32 else \
                    2 ** -7 * max(float(ref.float().abs().max()), 1.0)
                check(e_out <= limit and e_lse <= FLASH_TOL and
                      float(out[-1].float().abs().max()) == 0.0,
                      f"flash_fwd BERT (block_q={bq}, block_k={bk}) "
                      f"{dtype}: max |diff| out {e_out:.3g} (limit "
                      f"{limit:.3g}), lse {e_lse:.3g}, or the length-0 row "
                      f"is not zero")
                errs.append(max(e_out, e_lse))

        def kernel():
            ck.flash_fwd_cuda(q, k, v, qs, ks, scale, False)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, scale=scale,
                                           attn_mask=mask[:, None])

        n_bytes = q.element_size() * 4 * q.numel() + 4 * B * H * T + \
            4 * 2 * B * T
        bms, by, core_ms = attention_bound_ms(n_bytes, 4 * D * pairs, dtype)
        row = {"ms": time_ms(kernel), "graph_ms": graph_ms(kernel),
               "plain_ms": time_ms(lambda: ck.attention_plain(
                   q, k, v, scale, False, qs, ks)),
               "library_ms": time_ms(sdpa), "library_graph_ms":
               graph_ms(sdpa), "bound_ms": bms, "bound_by": by,
               "cuda_core_bound_ms": core_ms, "max_abs_err": max(errs),
               "shape": f"q/k/v ({B}*{H}, {T}, {D}) "
                        f"{'fp32' if dtype == torch.float32 else 'bf16'}, "
                        f"non-causal + key-padding ids (BERT-Base serving)"}
        log(f"[kernels] flash_fwd BERT shape {row['shape']}: max|diff| at "
            f"the {len(errs)} tiles {max(errs):.3g}; default tile kernel "
            f"{row['ms']:.4f} ms (graph {row['graph_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, SDPA with the boolean mask "
            f"{row['library_ms']:.4f} ms (graph "
            f"{row['library_graph_ms']:.4f}), bound {bms:.4f} ms ({by}), "
            f"{pairs} visible pairs")
        out_rows.append(row)
    return out_rows


BERT_BWD_SHAPES = ((32, 12), (8, 16))     # bench.py's Base and Large batches
BERT_T, BERT_VALID = 128, 112             # T and _PaddedBERT's 7/8 valid


def _flash_bwd_bert_tiles(rng, dev):
    """The two flash backward kernels at BERT pretraining's shapes, q/k/v/g
    (32*12, 128, 64) (Base, B = 32) and (8*16, 128, 64) (Large, B = 8),
    non-causal, q ids all 1, kv ids 112 of 128 valid and one row of length
    0, fp32 and bf16, against the plain backward at every legal tile
    (fp32 FLASH_TOL, bf16 one bf16 step of each gradient's largest value);
    the length-0 row's and the padded keys' gradients exact zeros. Returns
    the default tile's rows for each kernel's JSON "more", by dtype: CUDA
    events, graph replays and the profiler's device time, the bound, the
    plain backward and SDPA's backward with the boolean mask (autograd
    through it less its forward) as the library time."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    T, D = BERT_T, 64
    scale = 1.0 / D ** 0.5
    rows = {("flash_bwd_dkv", torch.float32): [],
            ("flash_bwd_dq", torch.float32): [],
            ("flash_bwd_dkv", torch.bfloat16): [],
            ("flash_bwd_dq", torch.bfloat16): []}
    for B, H in BERT_BWD_SHAPES:
        valid = onp.full(B, BERT_VALID)
        valid[-1] = 0
        ks = torch.from_numpy((onp.arange(T)[None] < valid[:, None])
                              .astype("int32")).to(dev)
        qs = torch.ones_like(ks)
        mask, pairs = _visible_pairs(qs, ks, B, H, T, T, False)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.from_numpy(rng.randn(B, H, T, D)
                                           .astype("float32"))
                          .to(dev).to(dtype) for _ in range(4))
            out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, False)
            want = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks,
                                          scale, False)
            limits = [FLASH_TOL if dtype == torch.float32 else
                      2 ** -7 * max(float(w.float().abs().max()), 1.0)
                      for w in want]
            err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
            for bq in ck.FLASH_BLOCKS:
                for bk in ck.FLASH_BLOCKS:
                    got = ck.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks,
                                            scale, False, bq, bk)
                    torch.cuda.synchronize()
                    diffs = [float((a.float() - w.float()).abs().max())
                             for a, w in zip(got, want)]
                    what = (f"flash_bwd BERT ({B}*{H}, {T}, {D}) {dtype} "
                            f"(block_q={bq}, block_k={bk})")
                    check(all(d <= lim for d, lim in zip(diffs, limits)),
                          f"{what}: max |diff| dq/dk/dv {diffs} over "
                          f"{limits}")
                    check(all(float(a[B - 1].float().abs().max()) == 0.0
                              for a in got) and
                          float(got[1][:, :, BERT_VALID:].float().abs()
                                .max()) == 0.0 and
                          float(got[2][:, :, BERT_VALID:].float().abs()
                                .max()) == 0.0,
                          f"{what}: the length-0 row or a padded key has "
                          f"a gradient")
                    err["flash_bwd_dq"] = max(err["flash_bwd_dq"], diffs[0])
                    err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"],
                                               *diffs[1:])
            delta = (g.float() * out.float()).sum(dim=-1)
            args = (q, k, v, g, lse, delta, qs, ks, scale, False)
            plain_ms = time_ms(lambda: ck.attention_bwd_plain(
                q, k, v, out, lse, g, qs, ks, scale, False), reps=10)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def lib_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale,
                                                   attn_mask=mask[:, None])
                torch.autograd.grad(o, (qg, kg, vg), g)

            def lib_fwd():
                F.scaled_dot_product_attention(q, k, v, scale=scale,
                                               attn_mask=mask[:, None])

            lib_ms = time_ms(lib_fwd_bwd, reps=20) - time_ms(lib_fwd,
                                                             reps=20)
            lib_g_ms = graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd)
            es = q.element_size()
            n_in = es * 4 * q.numel() + 4 * (lse.numel() + delta.numel()) \
                + 4 * (qs.numel() + ks.numel())
            for name, fn, n_out, per_pair in (
                    ("flash_bwd_dkv", ck.flash_bwd_dkv_cuda, 2 * k.numel(),
                     8),
                    ("flash_bwd_dq", ck.flash_bwd_dq_cuda, q.numel(), 6)):
                ms = time_ms(lambda: fn(*args))
                g_ms = graph_ms(lambda: fn(*args))
                dev_ms = device_ms(lambda: fn(*args), name + "_kernel")
                bms, by, core_ms = attention_bound_ms(
                    n_in + es * n_out, per_pair * D * pairs, dtype)
                row = {"ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "library_graph_ms": lib_g_ms, "bound_ms": bms,
                       "bound_by": by, "cuda_core_bound_ms": core_ms,
                       "max_abs_err": err[name],
                       "shape": f"q/k/v/g ({B}*{H}, {T}, {D}) "
                                f"{'fp32' if dtype == torch.float32 else 'bf16'}"
                                f", non-causal, kv ids {BERT_VALID} of {T} "
                                f"valid + a length-0 row (BERT "
                                f"{'Base' if H == 12 else 'Large'} "
                                f"pretraining); plain and library times "
                                f"cover dq, dk and dv together"}
                rows[(name, dtype)].append(row)
                log(f"[kernels] {name} BERT {row['shape']}: max|diff| at "
                    f"the 9 tiles {err[name]:.3g}; default tile kernel "
                    f"{ms:.4f} ms (graph {g_ms:.4f}, profiler {dev_ms}), "
                    f"bound {bms:.4f} ms ({by}; CUDA-core {core_ms:.4f}), "
                    f"plain {plain_ms:.4f} ms, SDPA backward with the "
                    f"boolean mask {lib_ms:.4f} ms (graph {lib_g_ms:.4f}), "
                    f"{pairs} visible pairs")
            del q, k, v, g, qg, kg, vg, out, lse, want
    return rows


DKV_DESIGN = ("mma.sync m16n8k8 TF32 tensor cores for S^T = KQ^T, "
              "dP^T = VG^T, dV += P^T G and dK += dS^T Q, fp32 as 3xTF32, "
              "bf16 one product for S^T and dP^T and two for dV and dK "
              "(fp32 p and ds split hi/lo against the exact bf16 value); a "
              "warp per 16 keys, K and V split once: K's fragments in "
              "registers (D <= 64), V's in hi/lo planes in shared memory; Q/G "
              "tiles with their lse, Delta and ids by cp.async into a "
              "two-stage ring; P^T and dS^T fed from their accumulator "
              "fragments in the forward's permuted order; fp32 sums each "
              "query tile from zero and adds it to running sums in shared "
              "memory (the accumulator truncates on every mma)")
DQ_DESIGN = ("mma.sync m16n8k8 TF32 tensor cores for S = QK^T, dP = GV^T "
             "and dQ += dS K, fp32 as 3xTF32, bf16 one product for S and dP "
             "and two for dS K (fp32 ds split hi/lo against K's exact "
             "value); a warp per 16 query rows, Q and G split once: Q's "
             "fragments held in registers (D <= 64), G's in hi/lo planes in "
             "shared memory in fragment order; K/V tiles by cp.async into "
             "the forward's two-stage ring, p from "
             "the known LSE in log2 units with a branch-free mask, dS fed "
             "from its accumulator fragments in the forward's permuted key "
             "order")


def _flash_bwd_rows(rng, dev):
    """The two flash-attention backward kernels against the plain backward
    at GPT-2 training shapes, fp32 held to FLASH_TOL, bf16 to one bf16 step
    of each gradient's largest value; times by CUDA events (back to back
    and CUDA-graph replays) and the profiler. The training shape
    (4*12, 1024, 64) fp32 causal gives the JSON rows, (48, 512, 64) fp32
    causal + ids stands in them under "more"; (48, 1024, 64) bf16 causal,
    the AMP training shape, gives rows of their own (``name:bf16``). The
    library time is autograd through SDPA (``is_causal`` where the mask is
    causal alone) less SDPA's forward."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, D = 4, 12, 64
    scale = 1.0 / D ** 0.5
    f32, bf16 = torch.float32, torch.bfloat16
    err = {"flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
    err_bf16 = dict(err)
    rows = {}
    for Tq, Tk, causal, seg, dtype in [(1024, 1024, True, False, f32),
                                       (512, 512, True, True, f32),
                                       (384, 384, True, True, f32),
                                       (1000, 1000, True, True, f32),
                                       (384, 1000, False, False, f32),
                                       (1024, 1024, True, False, bf16)]:
        q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        g = torch.from_numpy(rng.randn(B, H, Tq, D).astype("float32")) \
            .to(dev, dtype)
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)
        dq, dk, dv = ck.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale,
                                       causal)
        rq, rk, rv = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks,
                                            scale, causal)
        torch.cuda.synchronize()
        what = f"flash_bwd T=({Tq},{Tk}) causal={causal} seg={seg} {dtype}"
        diffs = {n: float((a.float() - b.float()).abs().max())
                 for n, a, b in (("dq", dq, rq), ("dk", dk, rk),
                                 ("dv", dv, rv))}
        if dtype == f32:
            limits = dict.fromkeys(diffs, FLASH_TOL)
        else:
            # both sides round one fp32 value to 8 bits: one bf16 step of
            # each gradient's largest value
            limits = {n: 2 ** -7 * max(float(b.float().abs().max()), 1.0)
                      for n, b in (("dq", rq), ("dk", rk), ("dv", rv))}
        check(all(diffs[n] <= limits[n] for n in diffs),
              f"{what}: max |diff| {diffs} over the limits {limits}")
        e_dkv, e_dq = max(diffs["dk"], diffs["dv"]), diffs["dq"]
        if seg:
            check(float(dq[B - 1, :, 0].float().abs().max()) == 0.0,
                  f"{what}: the fully masked row has a gradient")
            # keys with a padding id: no query sees them
            unseen = (ks == 0)[:, None, :, None]
            check(float(torch.where(unseen, dk.float().abs() +
                                    dv.float().abs(), 0.0).max()) == 0.0,
                  f"{what}: a key that no query sees has a gradient")
        exact = {}
        if dtype == f32 and Tq == Tk:
            # both sides against a float64 answer: the kernel's own error,
            # apart from the plain version's
            ek, ev = dkv_float64(q, k, v, g, qs, ks, scale, causal)
            exact = {n: float((a.double() - b).abs().max())
                     for n, a, b in (("kernel dk", dk, ek),
                                     ("kernel dv", dv, ev),
                                     ("plain dk", rk, ek),
                                     ("plain dv", rv, ev))}
            log(f"[kernels] {what}: max |diff| against float64 {exact}; "
                f"max |dk| {float(ek.abs().max()):.3g}, max |dv| "
                f"{float(ev.abs().max()):.3g}")
            del ek, ev
        errs = err if dtype == f32 else err_bf16
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e_dkv)
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e_dq)
        delta = (g.float() * out.float()).sum(dim=-1)
        args = (q, k, v, g, lse, delta, qs, ks, scale, causal)
        mask, pairs = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)
        plain_ms = time_ms(lambda: ck.attention_bwd_plain(
            q, k, v, out, lse, g, qs, ks, scale, causal), reps=10)
        # the library's backward: autograd through SDPA with the same
        # boolean mask, less SDPA's forward alone
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_args = _sdpa_mask_args(mask, causal, seg, Tq, Tk)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale,
                                               **sdpa_args)
            torch.autograd.grad(o, (qg, kg, vg), g)

        def lib_fwd():
            F.scaled_dot_product_attention(q, k, v, scale=scale, **sdpa_args)

        lib_ms = time_ms(lib_fwd_bwd, reps=20) - time_ms(lib_fwd, reps=20)
        lib_g_ms = graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd)
        dev_both, dev_fwd = device_total_ms(lib_fwd_bwd), \
            device_total_ms(lib_fwd)
        # None where the profiler dropped the records of either run
        lib_dev_ms = dev_both - dev_fwd if dev_both and dev_fwd and \
            dev_both > dev_fwd else None
        es = q.element_size()
        n_in = es * (q.numel() + k.numel() + v.numel() + g.numel()) + 4 * (
            lse.numel() + delta.numel()) + (
            4 * (qs.numel() + ks.numel()) if seg else 0)
        for name, fn, n_out, flops_per_pair in (
                ("flash_bwd_dkv", ck.flash_bwd_dkv_cuda, 2 * k.numel(), 8),
                ("flash_bwd_dq", ck.flash_bwd_dq_cuda, q.numel(), 6)):
            ms = time_ms(lambda: fn(*args))
            g_ms = graph_ms(lambda: fn(*args))
            dev_ms = device_ms(lambda: fn(*args), name + "_kernel")
            bms, by, core_ms = attention_bound_ms(
                n_in + es * n_out, flops_per_pair * D * pairs, dtype)
            log(f"[kernels] {name} B*H={B * H} Tq={Tq} Tk={Tk} D={D} "
                f"causal={causal} seg={seg} {dtype}: max|diff| "
                f"{e_dkv if name.endswith('dkv') else e_dq:.3g}; kernel "
                f"{ms:.4f} ms (graph {g_ms:.4f}, profiler {dev_ms}), bound "
                f"{bms:.4f} ms ({by}, {'3xTF32' if dtype == f32 else 'bf16'}"
                f" tensor cores, {100 * bms / g_ms:.1f} % reached; CUDA-core "
                f"bound {core_ms:.4f} ms), {pairs} visible pairs")
            if (Tq, Tk) == (1024, 1024) or (Tq, seg) == (512, True):
                rows[(name, Tq, dtype)] = {
                    "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_graph_ms": lib_g_ms,
                    "library_device_ms": lib_dev_ms,
                    "bound_ms": bms, "bound_by": by,
                    "cuda_core_bound_ms": core_ms,
                    "shape": f"q/k/v/g ({B}*{H}, {Tq}, {D}) "
                             f"{'fp32' if dtype == f32 else 'bf16'}, causal"
                             f"{' + segment ids' if seg else ''}; plain and "
                             f"library times cover dq, dk and dv together"}
        log(f"[kernels] flash_bwd {dtype} plain (dq, dk, dv together) "
            f"{plain_ms:.4f} ms; SDPA backward (autograd.grad through "
            f"scaled_dot_product_attention with {list(sdpa_args)[0]}, less "
            f"its forward) {lib_ms:.4f} ms (graph {lib_g_ms:.4f}, profiler "
            f"{lib_dev_ms})")
        if exact and ("flash_bwd_dkv", Tq, dtype) in rows:
            rows[("flash_bwd_dkv", Tq, dtype)]["float64_max_abs_err"] = exact
    results = {}
    for name, src, line in (
            ("flash_bwd_dkv", "flash_bwd.cuh", 529),
            ("flash_bwd_dq", "flash_bwd_dq.cuh", 587)):
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{src}",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            "max_abs_err": err[name]}
        results[name]["design"] = (DQ_DESIGN if name == "flash_bwd_dq"
                                   else DKV_DESIGN)
        results[name].update(rows[(name, 1024, f32)])
        results[name]["more"] = [rows[(name, 512, f32)]]
        results[name + ":bf16"] = _bf16_row(
            results[name], rows[(name, 1024, bf16)], err_bf16[name])
    return results


# -- the float16 and fp8 instances (AMP's other dtypes) ----------------------
# dtype of each instance row's name suffix ("flash_fwd:fp16", ...)
SUFFIX_DTYPE = {"": "float32", "bf16": "bfloat16", "fp16": "float16",
                "e4m3": "float8_e4m3fn", "e5m2": "float8_e5m2"}
LOW_SUFFIXES = ("fp16", "e4m3", "e5m2")
# unit roundoff of each low-precision format
LOW_U = {"float16": 2.0 ** -11, "float8_e4m3fn": 2.0 ** -4,
         "float8_e5m2": 2.0 ** -3}
LOW_DESIGN = ("the bf16 instance's tile code: fp16 exact in TF32 (one "
              "product); fp8 K/V (Q/G in dK/dV) tiles widened to fp16 as "
              "they are staged, by 8-byte loads; P rounded to v's dtype "
              "before P V; outputs stored with XLA's overflow (fp8 "
              "__NV_NOSAT)")


def low_excess(got, want, dtype, steps=4):
    """max over the elements of |got - want| / (steps u (|want| + max |want|
    / 8)), u the format's unit roundoff (<= 1 passes): both sides round one
    fp32 value to the format; the float16 row kernels' limit
    (tests/test_torch_amp16.py). The flash instances are held to
    tests/torch_flash_limits.py's limits instead."""
    w = want.float()
    lim = steps * LOW_U[dtype] * (w.abs() + w.abs().max() / 8)
    return float(((got.float() - w).abs() / lim.clamp_min(1e-30)).max())


def _by_kernel(ex):
    """{"out", "dq", "dk", "dv"} excesses by the kernel that writes each."""
    return {"flash_fwd": ex["out"], "flash_bwd_dq": ex["dq"],
            "flash_bwd_dkv": max(ex["dk"], ex["dv"])}


def _low_inputs(rng, dev, dtype, *shapes):
    """Tensors of ``shapes`` from the seed, cast to ``dtype`` as XLA casts."""
    import torch

    from mxnet_tpu_torch.base import cast

    return [cast(torch.from_numpy(rng.randn(*s).astype("float32")).to(dev),
                 dtype) for s in shapes]


def _low_flash(rng, dev, dtype, B, H, T, D, causal, kv_valid=None,
               tiles=False):
    """The three flash kernels' ``dtype`` instances at (B*H, T, D): the
    forward against ``attention_tiled_plain`` at the kernel's key tile and
    the backward (from the kernel's out and lse) against
    ``attention_bwd_plain``, within tests/torch_flash_limits.py's limits
    (each element's own near-zero term); ``kv_valid``: key-padding ids (kv
    ids 1 below each row's valid length, q ids 1). With ``tiles``, every
    legal tile; else the default tile, the faults of
    ``torch_flash_limits.FAULTS`` planted in the kernels where causal (each
    must land over its limit), timed beside SDPA's fp16 forward and
    backward on the same values in fp16 (SDPA takes no fp8). Returns
    {kernel: numbers}."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    fl = _tests_script("torch_flash_limits")
    scale = 1.0 / D ** 0.5
    q, k, v, g = _low_inputs(rng, dev, dtype, *[(B, H, T, D)] * 4)
    qs = ks = None
    if kv_valid is not None:
        ks = torch.from_numpy((onp.arange(T)[None] < kv_valid[:, None])
                              .astype("int32")).to(dev)
        qs = torch.ones_like(ks)
    what = (f"({B}*{H}, {T}, {D}) {dtype} "
            f"{'causal' if causal else 'non-causal'}"
            f"{' + key-padding ids' if ks is not None else ''}")
    worst = {}
    grid = [(bq, bk) for bq in ck.FLASH_BLOCKS for bk in ck.FLASH_BLOCKS] \
        if tiles else [(ck.flash_block_q(), ck.flash_block_k())]
    out_delta = fl.forward_delta(q, k, v, scale, causal, qs, ks, dtype)
    for bq, bk in grid:
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal, bq, bk)
        grads = ck.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale,
                                  causal, bq, bk)
        torch.cuda.synchronize()
        ex = fl.flash_excess(q, k, v, g, out, lse, grads, qs, ks, scale,
                             causal, bk, dtype, out_delta)
        e_lse = ex.pop("lse")
        check(max(ex.values()) <= 1.0 and e_lse <= FLASH_TOL and all(
            t.dtype == q.dtype for t in (out, *grads)),
              f"flash {what} tile ({bq}, {bk}): over the {dtype} limit by "
              f"{ex} (<= 1 passes), lse {e_lse:.3g}, dtypes "
              f"{[t.dtype for t in (out, *grads)]}")
        if kv_valid is not None and kv_valid[-1] == 0:
            check(float(out[-1].float().abs().max()) == 0.0 and
                  float(grads[0][-1].float().abs().max()) == 0.0,
                  f"flash {what}: the row that sees no key is not zero")
        for n, e in ex.items():
            worst[n] = max(worst.get(n, 0.0), e)
        worst["lse"] = max(worst.get("lse", 0.0), e_lse)
    if tiles:
        log(f"[kernels] flash {what}: all {len(grid)} tiles within the "
            f"{dtype} limit (worst |diff| / limit {worst})")
        return _by_kernel(worst)
    ref = ck.attention_tiled_plain(q, k, v, scale, causal, qs, ks, bk)[0]
    want = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks, scale,
                                  causal)
    formula = ck.attention_plain(q, k, v, scale, causal, qs, ks)[0]
    errs = {"flash_fwd": float((out.float() - ref.float()).abs().max()),
            "flash_bwd_dq": float((grads[0].float() - want[0].float())
                                  .abs().max()),
            "flash_bwd_dkv": max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(grads[1:], want[1:]))}
    formula_diff = float((out.float() - formula.float()).abs().max())
    log(f"[kernels] flash forward {what}: max|diff| to the reference "
        f"formula's plain version (p normalized, then rounded) "
        f"{formula_diff:.4g}, to the kernel's roundings' "
        f"{errs['flash_fwd']:.4g}; mean |out| "
        f"{float(out.float().abs().mean()):.4g}")
    faults = None
    if causal and ks is None:
        faults = fl.planted_faults(
            lambda q_, k_, v_, a, b: ck.flash_fwd_cuda(
                q_, k_, v_, a, b, scale, causal, bq, bk),
            lambda q_, k_, v_, o, l_, g_, a, b: ck.flash_bwd_cuda(
                q_, k_, v_, o, l_, g_, a, b, scale, causal, bq, bk),
            q, k, v, g, scale, causal, bq, bk, dtype)
        missed = fl.faults_missed(faults)
        log(f"[kernels] flash {what} tile ({bq}, {bk}): |diff| / limit of "
            f"the sound outputs and of each planted fault (over 1 fails) "
            f"{json.dumps(faults)}")
        check(not missed, f"flash {what}: planted faults within the limit "
              f"(the limit cannot tell them from a sound kernel): {missed}")
    mask, pairs = _visible_pairs(qs, ks, B, H, T, T, causal)
    sdpa_args = _sdpa_mask_args(mask, causal, ks is not None, T, T)
    q16, k16, v16, g16 = (t.to(torch.float16) for t in (q, k, v, g))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q16, k16, v16))

    def sdpa():
        F.scaled_dot_product_attention(q16, k16, v16, scale=scale,
                                       **sdpa_args)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale,
                                           **sdpa_args)
        torch.autograd.grad(o, (qg, kg, vg), g16)

    es = q.element_size()
    ids = 4 * (qs.numel() + ks.numel()) if ks is not None else 0
    delta = (g.float() * out.float()).sum(dim=-1)
    args = (q, k, v, g, lse, delta, qs, ks, scale, causal)
    lib_fwd = (time_ms(sdpa), graph_ms(sdpa), device_total_ms(sdpa))
    both = (time_ms(sdpa_fwd_bwd, reps=20), graph_ms(sdpa_fwd_bwd),
            device_total_ms(sdpa_fwd_bwd))
    lib_bwd = (both[0] - lib_fwd[0], both[1] - lib_fwd[1],
               both[2] - lib_fwd[2] if both[2] and lib_fwd[2] else None)
    bwd_plain = time_ms(lambda: ck.attention_bwd_plain(
        q, k, v, out, lse, g, qs, ks, scale, causal), reps=10)
    numbers = {}
    excess = _by_kernel(worst)
    for name, fn, n_bytes, flops, lib, plain_ms in (
            ("flash_fwd",
             lambda: ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal),
             es * 4 * q.numel() + 4 * lse.numel() + ids, 4 * D * pairs,
             lib_fwd, time_ms(lambda: ck.attention_plain(
                 q, k, v, scale, causal, qs, ks))),
            ("flash_bwd_dkv", lambda: ck.flash_bwd_dkv_cuda(*args),
             es * 6 * q.numel() + 8 * lse.numel() + ids, 8 * D * pairs,
             lib_bwd, bwd_plain),
            ("flash_bwd_dq", lambda: ck.flash_bwd_dq_cuda(*args),
             es * 5 * q.numel() + 8 * lse.numel() + ids, 6 * D * pairs,
             lib_bwd, bwd_plain)):
        ms, g_ms = time_ms(fn), graph_ms(fn)
        dev_ms = device_ms(fn, name + "_kernel")
        bms, by, core_ms = attention_bound_ms(n_bytes, flops, q.dtype)
        numbers[name] = {
            "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib[0],
            "library_graph_ms": lib[1], "library_device_ms": lib[2],
            "bound_ms": bms, "bound_by": by, "cuda_core_bound_ms": core_ms,
            "max_abs_err": errs[name], "limit_excess": excess[name],
            "shape": f"q/k/v{'' if name == 'flash_fwd' else '/g'} {what}; "
                     f"library: SDPA on the same values in float16"
                     f"{'' if name == 'flash_fwd' else ' (its backward: autograd through it less its forward; plain and library cover dq, dk and dv together)'}"}
        if faults is not None and name == "flash_fwd":
            # the outputs of all three kernels, on the forward's row
            numbers[name]["planted_faults"] = faults
        if name == "flash_fwd":
            numbers[name]["reference_formula_max_abs_diff"] = formula_diff
        log(f"[kernels] {name} {what}: |diff| / limit {excess[name]:.3g}, "
            f"max|diff| {errs[name]:.3g}; kernel {ms:.4f} ms (graph "
            f"{g_ms:.4f}, profiler {dev_ms}), plain {plain_ms:.4f} ms, SDPA "
            f"fp16 {lib[0]:.4f} ms (graph {lib[1]:.4f}, profiler {lib[2]}), "
            f"bound {bms:.4f} ms ({by}, {dtype} tensor cores, "
            f"{100 * bms / g_ms:.1f} % reached; CUDA-core bound "
            f"{core_ms:.4f} ms), {pairs} visible pairs")
    return numbers


def _low_row_kernels(rng, dev):
    """LayerNorm with float16 x (gamma/beta float32, as
    ``convert_hybrid_block(net, "float16")`` runs it, and float16) at
    (4096, 768) and softmax at float16, narrow (4096, 768) and wide
    (64, 50257), against the plain versions, then at every row tile at
    (2000, 768); times beside ``F.layer_norm`` and ``torch.softmax`` on the
    same float16 input. Returns (layer_norm row numbers, softmax row
    numbers), each with "more"."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    f16 = torch.float16
    d = 768
    ln = []
    for gdt in (torch.float32, f16):
        rows = 4096
        x = torch.from_numpy((rng.randn(rows, d) * 2 + 0.5)
                             .astype("float32")).to(dev, f16)
        gam = torch.from_numpy(rng.randn(d).astype("float32")).to(dev, gdt)
        bet = torch.from_numpy(rng.randn(d).astype("float32")).to(dev, gdt)
        out = ck.layer_norm_cuda(x, gam, bet, 1e-5)
        ref = ck.layer_norm_plain(x, gam, bet, 1e-5)
        torch.cuda.synchronize()
        # float16 gamma/beta: the plain version (the reference's formula in
        # x's dtype) rounds five times in a chain, the kernel once
        steps = 4 if gdt == torch.float32 else 8
        ex = low_excess(out, ref, "float16", steps)
        gname = str(gdt).replace("torch.", "")
        check(ex <= 1.0 and out.dtype == f16,
              f"layer_norm fp16 x, {gname} gamma/beta: over the limit by "
              f"{ex:.3g} (<= 1 passes), dtype {out.dtype}")
        g16, b16 = gam.to(f16), bet.to(f16)

        def kernel():
            ck.layer_norm_cuda(x, gam, bet, 1e-5)

        def library():
            F.layer_norm(x, (d,), g16, b16, 1e-5)

        bms, by = bound_ms(2 * 2 * rows * d + gam.element_size() * 2 * d,
                           8 * rows * d)
        n = {"ms": time_ms(kernel), "graph_ms": graph_ms(kernel),
             "device_ms": device_ms(kernel, "layer_norm_kernel"),
             "plain_ms": time_ms(lambda: ck.layer_norm_plain(
                 x, gam, bet, 1e-5)),
             "library_ms": time_ms(library),
             "library_graph_ms": graph_ms(library),
             "library_device_ms": device_total_ms(library),
             "bound_ms": bms, "bound_by": by,
             "max_abs_err": float((out.float() - ref.float()).abs().max()),
             "dtype": f"float16 x, {gname} gamma/beta",
             "shape": f"x ({rows}, {d}) float16, gamma/beta ({d},) {gname};"
                      f" library F.layer_norm with float16 gamma/beta"}
        log(f"[kernels] layer_norm {n['shape']}: |diff| / limit {ex:.3g}; "
            f"kernel {n['ms']:.4f} ms (graph {n['graph_ms']:.5f}, profiler "
            f"{n['device_ms']}), plain {n['plain_ms']:.4f} ms, F.layer_norm "
            f"{n['library_ms']:.4f} ms (graph {n['library_graph_ms']:.5f}, "
            f"profiler {n['library_device_ms']}), bound {bms:.5f} ms ({by})")
        ln.append(n)
    sm = []
    for rows, dd, offset in ((4096, 768, 0), (64, 50257, 0), (64, 50257, 1),
                             (7, 4103, 3), (1001, 768, 0)):
        buf = torch.empty(rows * dd + offset, dtype=f16, device=dev)
        x = buf[offset:].view(rows, dd)
        x.copy_(torch.from_numpy(rng.randn(rows, dd).astype("float32") * 4))
        out = ck.softmax_cuda(x)
        ref = ck.softmax_plain(x)
        torch.cuda.synchronize()
        # one fp16 step of the value; subnormal outputs within the smallest
        over = float(((out.float() - ref.float()).abs() - 2 * LOW_U[
            "float16"] * ref.float().abs()).max())
        what = f"softmax ({rows}, {dd}) float16 offset {offset}"
        check(over <= 2.0 ** -24, f"{what}: |diff| exceeds one fp16 step of "
              f"the value by {over:.3g}")
        if offset or (rows, dd) == (1001, 768) or (rows, dd) == (7, 4103):
            log(f"[kernels] {what}: within one fp16 step")
            continue

        def kernel():
            ck.softmax_cuda(x)

        def library():
            torch.softmax(x, dim=-1)

        bms, by = bound_ms(2 * 2 * rows * dd, 4 * rows * dd)
        n = {"ms": time_ms(kernel), "graph_ms": graph_ms(kernel),
             "device_ms": device_ms(kernel, "softmax"),
             "plain_ms": time_ms(lambda: ck.softmax_plain(x)),
             "library_ms": time_ms(library),
             "library_graph_ms": graph_ms(library),
             "library_device_ms": device_ms(library, "softmax"),
             "bound_ms": bms, "bound_by": by,
             "max_abs_err": float((out.float() - ref.float()).abs().max()),
             "dtype": "float16",
             "shape": f"x ({rows}, {dd}) float16, "
                      f"{'one cluster of 8 blocks' if dd >= 4096 else 'one warp'}"
                      f" a row"}
        log(f"[kernels] {what}: kernel {n['ms']:.4f} ms (graph "
            f"{n['graph_ms']:.5f}, profiler {n['device_ms']}), plain "
            f"{n['plain_ms']:.4f} ms, torch.softmax {n['library_ms']:.4f} "
            f"ms (graph {n['library_graph_ms']:.5f}, profiler "
            f"{n['library_device_ms']}), bound {bms:.5f} ms ({by}, "
            f"{100 * bms / n['graph_ms']:.1f} % reached)")
        sm.append(n)
    x = torch.from_numpy(rng.randn(2000, d).astype("float32")).to(dev, f16)
    gam = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    bet = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    ln_ref = ck.layer_norm_plain(x, gam, bet, 1e-5)
    sm_ref = ck.softmax_plain(x)
    for br in ck.ROW_BLOCKS:
        e_ln = low_excess(ck.layer_norm_cuda(x, gam, bet, 1e-5, br), ln_ref,
                          "float16")
        e_sm = low_excess(ck.softmax_cuda(x, br), sm_ref, "float16")
        check(max(e_ln, e_sm) <= 1.0, f"float16 row tile block_rows={br}: "
              f"over the limit by layer_norm {e_ln:.3g}, softmax "
              f"{e_sm:.3g}")
    log(f"[kernels] float16 LayerNorm and softmax at all "
        f"{len(ck.ROW_BLOCKS)} row tiles at (2000, 768): within the limit")
    return ln, sm


def _low_precision_rows(rng, dev, results):
    """Rows ``name:fp16``, ``name:e4m3``, ``name:e5m2`` of the three flash
    kernels at the AMP training shape (4*12, 1024, 64) causal, with
    BERT-Base's (32*12, 128, 64) non-causal key-padding shape under "more",
    every instance at every legal tile at (4*12, 512, 64) causal + ids;
    ``layer_norm:fp16`` and ``softmax:fp16``. Adds them to ``results``."""
    import torch

    for suffix in LOW_SUFFIXES:
        dtype = SUFFIX_DTYPE[suffix]
        gpt = _low_flash(rng, dev, dtype, 4, 12, 1024, 64, True)
        valid = rng.randint(16, 129, size=32)
        valid[-1] = 0
        bert = _low_flash(rng, dev, dtype, 32, 12, 128, 64, False,
                          kv_valid=valid)
        seg = rng.randint(64, 513, size=4)
        tiles = _low_flash(rng, dev, dtype, 4, 12, 512, 64, True,
                           kv_valid=seg, tiles=True)
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            numbers = dict(gpt[name])
            err = numbers.pop("max_abs_err")
            row = _dtype_row(results[name], suffix, dtype, numbers, err)
            row["design"] = LOW_DESIGN
            row["more"] = [bert[name]]
            row["tiles_worst_excess"] = tiles[name]
            results[f"{name}:{suffix}"] = row
    ln, sm = _low_row_kernels(rng, dev)
    for name, numbers in (("layer_norm", ln), ("softmax", sm)):
        first = dict(numbers[0])
        err = first.pop("max_abs_err")
        row = _dtype_row(results[name], "fp16", first.pop("dtype"), first,
                         err)
        row["more"] = numbers[1:]
        results[name + ":fp16"] = row
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 3: GPT-2 small served by the DecodeEngine
# ---------------------------------------------------------------------------
def numpy_weights(shapes, seed):
    """GPT weights from numpy's ``default_rng(seed)``: LayerNorm gains near
    1, small biases and embeddings, O(1)-gain projections."""
    rs = onp.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("gamma"):
            a = 1 + 0.1 * rs.standard_normal(shape, dtype="float32")
        elif name.endswith(("beta", "bias")):
            a = 0.02 * rs.standard_normal(shape, dtype="float32")
        elif "embed" in name:
            a = 0.1 * rs.standard_normal(shape, dtype="float32")
        else:
            a = rs.standard_normal(shape, dtype="float32") \
                / onp.float32(onp.sqrt(shape[1]))
        out[name] = a.astype("float32")
    return out


def make_prompts(rng, vocab):
    lengths = [16, 97, 180, 260, 415, 500]
    shared = rng.randint(0, vocab, size=300).tolist()
    prompts = [rng.randint(0, vocab, size=n).tolist() for n in lengths]
    first = shared + rng.randint(0, vocab, size=40).tolist()    # 340
    second = shared + rng.randint(0, vocab, size=25).tolist()   # 325
    return prompts, first, second


SERVE_ARGS = dict(num_slots=8, max_len=1024, max_prompt_len=512,
                  prefill_batch=4, page_tokens=128, prefix_cache=True)
MAX_NEW = 32


def serve_model():
    """GPT-2 small on the card with the serve phase's weights; returns
    (model, the numpy weights)."""
    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    model = gpt2_small(dropout=0.0)                # the GPU: no device arg
    check(model.device.type == "cuda", f"model on {model.device}")
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    arrays = numpy_weights(shapes, SEED)
    model.load_dict(params_from_mxnet_tpu(arrays, model))
    return model, arrays


def drive_engine(eng, model):
    """The serve phase's 8 requests through a warmed engine: 6 ragged
    prompts and two sharing a 300-token prefix, the second submitted once
    the first has its first token. Returns (requests [(prompt, stream)],
    outputs, seconds, per-family program ms)."""
    import torch

    fam_ms = {"prefill": [], "prefill_ext": [], "decode": []}
    run = eng.programs.run

    # per-family device time: the engine syncs right after each run, so a
    # synchronize after the call adds nothing to what it waits for
    def timed_run(key, datas):
        t = time.perf_counter()
        outs = run(key, datas)
        torch.cuda.synchronize()
        fam_ms[key[0]].append((time.perf_counter() - t) * 1e3)
        return outs

    eng.programs.run = timed_run
    rng = onp.random.RandomState(SEED + 1)
    prompts, first, second = make_prompts(rng, model.vocab_size)
    t_serve = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts[:3]]
    s_first = eng.submit(first, max_new_tokens=MAX_NEW)
    streams += [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts[3:]]
    deadline = time.perf_counter() + 300
    while not s_first.tokens:        # the tree holds a prompt once prefilled
        check(time.perf_counter() < deadline, "first token never arrived")
        check(not s_first.done or s_first.tokens, "shared request failed")
        time.sleep(0.001)
    s_second = eng.submit(second, max_new_tokens=MAX_NEW)
    reqs = list(zip(prompts, streams)) + [(first, s_first),
                                          (second, s_second)]
    outs = [s.result(timeout=600) for _, s in reqs]
    serve_s = time.perf_counter() - t_serve
    eng.programs.run = run
    return reqs, outs, serve_s, fam_ms


def check_default_tiles(phase):
    """Every launch since the last reset used the default tile."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    want = {"flash_fwd": (32, 32), "flash_bwd_dkv": (32, 32),
            "flash_bwd_dq": (32, 32), "layer_norm": (4,), "softmax": (4,)}
    tiles = ck.tile_counts()
    bad = {k: n for k, n in tiles.items() if want[k[0]] != k[1]}
    check(not bad, f"[{phase}] launches with other than the default tiles:"
          f" {bad}")
    log(f"[{phase}] every launch used the default tile: {tiles}")


SERVE_PROGRAMS = 43        # the tick + 2 prefill families x 7 lengths x 3
SERVE_WANT = {"prefill": {"flash_fwd": 12, "layer_norm": 25},
              "prefill_ext": {"flash_fwd": 0, "layer_norm": 25},
              "decode": {"flash_fwd": 0, "layer_norm": 25}}
RAGGED = dict(clients=64, threads=8, shared=128, longest=500, most_new=6)


def _reserved():
    import torch

    return torch.cuda.memory_stats().get("reserved_bytes.all.current", 0)


def warm_engine(model, tag, eager=False, **overrides):
    """A ``DecodeEngine`` with ``SERVE_ARGS`` (and ``overrides``), warmed:
    its whole table captured, or with ``eager`` its bodies run eagerly on
    the card through the programs' private switch. Logs the captures, the
    warmup seconds, the graph pool's bytes (its segments in the allocator's
    snapshot) and the reserved device bytes after warmup less before, each
    read after ``empty_cache``; returns (engine, {captures, warmup_s,
    pool_bytes, reserved_bytes})."""
    import torch

    from mxnet_tpu_torch.serve.decode import DecodeEngine

    eng = DecodeEngine(model, **{**SERVE_ARGS, **overrides})
    if eager:
        eng.programs._graphs = False
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = _reserved()
    t = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    info = {"captures": eng.programs._captures, "warmup_s": warm_s,
            "pool_bytes": eng.programs.pool_bytes(),
            "reserved_bytes": _reserved() - r0}
    log(f"[{tag}] warmup: {len(eng.programs.keys())} programs, "
        f"{info['captures']} {'built (eager bodies)' if eager else 'captured'}"
        f" in {warm_s:.2f} s; graph pool {info['pool_bytes'] / 2**20:.1f} "
        f"MiB; reserved bytes after warmup less before "
        f"{info['reserved_bytes'] / 2**20:.1f} MiB")
    return eng, info


def greedy_upto_tie(model, prompt, max_new):
    """``generate(use_cache=False)``'s tokens after ``prompt`` on the card and
    the step of its first near tie (top-2 logit margin < NEAR_TIE), or
    ``max_new`` when there is none."""
    import torch

    want = model.generate(prompt, max_new_tokens=max_new, use_cache=False,
                          window=len(prompt) + max_new)[len(prompt):]
    seq = torch.tensor([prompt + want], dtype=torch.int32,
                       device=model.device)
    with torch.inference_mode():
        logits = model(seq)[0, len(prompt) - 1:len(prompt) + max_new - 1]
    top = torch.topk(logits, 2, dim=-1).values
    margins = (top[:, 0] - top[:, 1]).tolist()
    return want, next((j for j, m in enumerate(margins) if m < NEAR_TIE),
                      max_new)


def _serve_operands(progs, key, rng, vocab):
    """Operands of the profiled runs: prefill at (4, 512) with rows of 512,
    400, 300 and 200 valid tokens; the tick with 8 live slots at 300-500
    cached positions; each row on its own pages."""
    rows = progs.num_slots if key[0] == "decode" else key[1]
    table = onp.full((rows, progs.table_width), progs.kv_pages, "int32")
    for r in range(rows):
        table[r, :4] = onp.arange(r * 8, r * 8 + 4)
    if key[0] == "decode":
        return [rng.randint(0, vocab, (rows, key[1])).astype("int32"),
                onp.array([300, 330, 360, 390, 420, 450, 480, 500][:rows],
                          "int32"), table]
    return [rng.randint(0, vocab, (rows, key[2])).astype("int32"),
            onp.array([512, 400, 300, 200][:rows], "int32"), table]


def profile_program(eng, key, datas, tag):
    """A program's run (operands in, replay, tokens out, synchronised)
    beside its device time: wall ms (host clock, median of 20 runs), device
    busy ms and kernels a run (profiler), the idle share, and the replay
    alone by CUDA events around 50 back-to-back replays."""
    import torch

    progs, cache = eng.programs, eng._cache
    args = datas + [cache.k, cache.v]

    def run():
        progs.run(key, args)

    run()
    walls = []
    for _ in range(20):
        t = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls)
    busy = device_total_ms(run, reps=10)
    kernels = _kernel_names(run)
    prog = progs._programs[key]
    replay = time_ms(prog.replay, reps=50, rounds=3)
    torch.cuda.synchronize()
    idle = None if busy is None else max(0.0, 1 - busy / wall)
    log(f"[serve] {tag} {'|'.join(map(str, key))}: run wall {wall:.3f} ms "
        f"(median of 20), device busy {busy} ms, idle share {idle}, "
        f"{sum(kernels.values())} device operations a run (kernels and "
        f"copies; the host launches one graph and two copies), replay "
        f"{replay:.3f} ms (CUDA events, 50 back to back)")
    return {"wall_ms": wall, "busy_ms": busy, "idle": idle,
            "replay_ms": replay, "ops": sum(kernels.values())}


def replay_bit_equal(eng, key, datas):
    """One replay's tokens and pools against the eager body's on the same
    operands and the same pools; the pools are left as they were."""
    import torch

    progs, cache = eng.programs, eng._cache
    k0, v0 = cache.k.clone(), cache.v.clone()
    toks, _, _ = progs.run(key, datas + [cache.k, cache.v])
    ka, va = cache.k.clone(), cache.v.clone()
    cache.k.copy_(k0)
    cache.v.copy_(v0)
    prog = progs._programs[key]
    with torch.inference_mode():
        prog.load(datas)
        want = prog.body(cache.k, cache.v).cpu()
    torch.cuda.synchronize()
    same = (torch.equal(toks, want), torch.equal(ka, cache.k),
            torch.equal(va, cache.v), not torch.equal(ka, k0))
    cache.k.copy_(k0)
    cache.v.copy_(v0)
    log(f"[serve] {'|'.join(map(str, key))}: replay against the eager body "
        f"on the same operands and pools: tokens equal {same[0]}, k pool "
        f"bit-equal {same[1]}, v pool bit-equal {same[2]} (pages written: "
        f"{same[3]})")
    check(all(same), f"{key}: the replay differs from the eager body: "
          f"{same}")


def phase_serve():
    import torch

    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    max_new = MAX_NEW
    t0 = time.perf_counter()
    model, arrays = serve_model()
    n_params = sum(int(a.size) for a in arrays.values())
    log(f"[serve] gpt2_small: {len(arrays)} tensors, {n_params} parameters "
        f"from numpy default_rng({SEED}) in {time.perf_counter() - t0:.1f} s")

    # the serve path: the table's warm calls and captures (the launch
    # counters move there only), then the requests, each run a replay
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    eng, info = warm_engine(model, "serve")
    progs = eng.programs
    check(info["captures"] == len(progs.keys()) == SERVE_PROGRAMS,
          f"{info['captures']} captures for {len(progs.keys())} programs, "
          f"expected {SERVE_PROGRAMS}")
    warm_counts = ck.launch_counts()
    gs0 = progs.graph_stats()
    for name, g in gs0.items():
        want = SERVE_WANT[name.split("|")[0]]
        got = g["captured_launches"]
        check(all(got[k] == n for k, n in want.items()),
              f"{name}: captured launches {got}, expected {want}")
    log(f"[serve] captured launches a program: {SERVE_WANT} (all "
        f"{len(gs0)} programs); warm calls and captures launched "
        f"{warm_counts}")
    reqs, outs, serve_s, fam_ms = drive_engine(eng, model)
    counts = read_counts("serve")
    st = eng.stats()
    gs1 = progs.graph_stats()
    peak = torch.cuda.max_memory_allocated()

    n_tok = sum(len(o) for o in outs)
    kinds = st["prefills_by_kind"]
    log(f"[serve] {len(reqs)} requests, {n_tok} tokens in {serve_s:.3f} s: "
        f"{n_tok / serve_s:.1f} tokens/s; prefills {kinds}, ticks "
        f"{st['ticks']}, prefix-hit tokens {st['prefix_hit_tokens']}")
    for fam, xs in fam_ms.items():
        if xs:
            log(f"[serve] {fam}: {len(xs)} runs, median "
                f"{statistics.median(xs):.3f} ms, max {max(xs):.3f} ms")
    log(f"[serve] TTFT p50/p99 {st['ttft_ms_p50']:.1f}/"
        f"{st['ttft_ms_p99']:.1f} ms, TPOT p50/p99 {st['tpot_ms_p50']:.2f}/"
        f"{st['tpot_ms_p99']:.2f} ms, peak device memory "
        f"{peak / 2**20:.1f} MiB")

    check(all(len(o) == max_new for o in outs), "a request came up short")
    check(kinds["prefill_ext"] >= 1 and st["prefix_hit_tokens"] > 0,
          f"the prefix-join family did not run: {kinds}, "
          f"{st['prefix_hit_tokens']} hit tokens")
    check(progs._captures == info["captures"],
          f"serving captured {progs._captures - info['captures']} programs")
    check(counts == warm_counts,
          f"a kernel counter moved while serving: {warm_counts} -> {counts}")
    replays = {n: gs1[n]["replays"] - gs0[n]["replays"] for n in gs1}
    ran = {fam: sum(r for n, r in replays.items() if n.split("|")[0] == fam)
           for fam in SERVE_WANT}
    launched = {k: sum(r * gs1[n]["captured_launches"][k]
                       for n, r in replays.items())
                for k in ("flash_fwd", "layer_norm")}
    log(f"[serve] replays while serving by family {ran}; kernels they ran "
        f"(replays x captured launches) {launched}; counters (warm calls "
        f"and captures only) {counts}")
    check(ran == {"prefill": kinds["prefill"],
                  "prefill_ext": kinds["prefill_ext"],
                  "decode": st["ticks"]},
          f"replays {ran} != program runs {kinds}, {st['ticks']} ticks")
    check(launched["flash_fwd"] == 12 * kinds["prefill"],
          f"flash_fwd replayed {launched['flash_fwd']} != 12 x "
          f"{kinds['prefill']} plain prefills")
    n_runs = st["prefills"] + st["ticks"]
    check(launched["layer_norm"] == 25 * n_runs,
          f"layer_norm replayed {launched['layer_norm']} != 25 x {n_runs} "
          f"program runs")
    check_default_tiles("serve")

    # -- last-token prefill logits: the card against the CPU ---------------
    cpu = gpt2_small(dropout=0.0, device="cpu")
    cpu.load_dict(arrays)
    all_prompts = [p for p, _ in reqs]
    T = max(len(p) for p in all_prompts)
    toks = onp.zeros((len(all_prompts), T), "int32")
    for i, p in enumerate(all_prompts):
        toks[i, :len(p)] = p
    valid = onp.array([len(p) for p in all_prompts], "int32")
    with torch.inference_mode():
        on_card = model.forward_prefill(
            torch.from_numpy(toks).cuda(),
            torch.from_numpy(valid).cuda())[0].cpu()
        on_cpu = cpu.forward_prefill(torch.from_numpy(toks),
                                     torch.from_numpy(valid))[0]
    del cpu
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    log(f"[serve] prefill last-token logits, card vs CPU: relative max "
        f"|diff| {rel:.3g} (limit {LOGIT_RTOL})")
    check(rel <= LOGIT_RTOL, f"card vs CPU logits differ: {rel:.3g}")

    # -- greedy tokens: the engine against naive generation on the card ----
    ties = []
    for i, ((p, _), got) in enumerate(zip(reqs, outs)):
        want, n = greedy_upto_tie(model, p, max_new)
        if n < max_new:
            ties.append((i, n))
        check(got[:n] == want[:n],
              f"request {i}: engine tokens differ from generate before "
              f"the first near tie (step {n}): {got} vs {want}")
    log(f"[serve] engine tokens == generate(use_cache=False) for all "
        f"{len(reqs)} requests (near ties at (request, step): "
        f"{ties or 'none'})")
    # the tune phase holds its tuned engine to these tokens, each up to its
    # first near tie
    agree = [(got, dict(ties).get(i, max_new)) for i, got in enumerate(outs)]

    # -- the captured programs alone, and against their eager bodies -------
    rng = onp.random.RandomState(SEED + 4)
    vocab = model.vocab_size
    for key in (("decode", 1), ("prefill", 4, 512)):
        profile_program(eng, key, _serve_operands(progs, key, rng, vocab),
                        "captured")
        # fresh tokens: the profiled runs left their own k/v in these pages
        replay_bit_equal(eng, key, _serve_operands(progs, key, rng, vocab))
    eng.close()
    del eng, progs
    _release()

    # -- the same requests through the eager bodies on the card ------------
    eng, _ = warm_engine(model, "serve eager", eager=True)
    _, outs_e, serve_e, fam_e = drive_engine(eng, model)
    ste = eng.stats()
    eng.close()
    del eng
    _release()
    log(f"[serve eager] {sum(len(o) for o in outs_e) / serve_e:.1f} tokens/s"
        f"; " + "; ".join(f"{fam} median {statistics.median(xs):.3f} ms, max "
                          f"{max(xs):.3f} ms" for fam, xs in fam_e.items()
                          if xs) +
        f"; TTFT p50/p99 {ste['ttft_ms_p50']:.1f}/{ste['ttft_ms_p99']:.1f} "
        f"ms, TPOT p50/p99 {ste['tpot_ms_p50']:.2f}/{ste['tpot_ms_p99']:.2f}"
        f" ms (run after the captured engine, same process)")
    check(outs_e == outs, "the eager bodies' tokens differ from the "
          "captured engine's")
    log("[serve] captured engine tokens == eager-body engine tokens for all "
        f"{len(outs)} requests")

    phase_ragged_clients(model, tm)
    return counts, agree


def phase_ragged_clients(model, tm):
    """64 ragged clients on 8 threads against a warmed engine with K = 4 and
    the prefix cache (the analog of the reference's
    tests/test_decode.py:358): prompts of 1-500 tokens, half sharing a
    128-token prefix, 1-6 new tokens each. Nothing captures after warmup
    and the stats and counters add up."""
    import threading

    eng, _ = warm_engine(model, "serve ragged", speculate_k=4, max_queue=128)
    n0 = eng.programs._captures
    rng = onp.random.RandomState(SEED + 6)
    vocab = model.vocab_size
    shared = rng.randint(0, vocab, size=RAGGED["shared"]).tolist()
    ps = [rng.randint(0, vocab, size=rng.randint(1, RAGGED["longest"] + 1))
          .tolist() for _ in range(RAGGED["clients"])]
    for i in range(0, RAGGED["clients"], 2):
        ps[i] = shared + ps[i][:RAGGED["longest"] - RAGGED["shared"]]
    budgets = [1 + i % RAGGED["most_new"] for i in range(RAGGED["clients"])]
    c0 = {n: tm.counter(n).value for n in ("serve.tokens_total",
                                           "serve.requests")}
    per = RAGGED["clients"] // RAGGED["threads"]
    results, errors = {}, []
    barrier = threading.Barrier(RAGGED["threads"] + 1)

    def client(cid):
        barrier.wait()
        try:
            for r in range(per):
                i = cid * per + r
                results[i] = eng.submit(
                    ps[i], max_new_tokens=budgets[i]).result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(RAGGED["threads"])]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=120)
    secs = time.perf_counter() - t0
    st = eng.stats()
    captured = eng.programs._captures - n0
    eng.close()
    check(not errors and not any(t.is_alive() for t in threads),
          f"ragged clients failed: {errors[:3]}")
    total = sum(len(results[i]) for i in range(RAGGED["clients"]))
    log(f"[serve ragged] {RAGGED['clients']} clients on {RAGGED['threads']} "
        f"threads, prompts 1-{RAGGED['longest']} tokens (half sharing "
        f"{RAGGED['shared']}), K=4: {total} tokens in {secs:.2f} s, "
        f"{st['ticks']} ticks, {st['prefills']} prefills "
        f"{st['prefills_by_kind']}, prefix-hit tokens "
        f"{st['prefix_hit_tokens']}, mean accepted "
        f"{st['spec_accept_mean']:.2f}"
        f"; captures after warmup {captured}")
    check(captured == 0, f"{captured} captures after warmup")
    check(st["tokens"] == total == sum(budgets),
          f"tokens {st['tokens']} / {total} != {sum(budgets)}")
    check(st["completed"] == RAGGED["clients"] and st["shed"] == 0,
          f"completed {st['completed']}, shed {st['shed']}")
    check(tm.counter("serve.tokens_total").value - c0["serve.tokens_total"]
          == total and tm.counter("serve.requests").value
          - c0["serve.requests"] == RAGGED["clients"],
          "the serve counters do not add up")
    check(st["prefix_hit_tokens"] > 0 and st["page_starved"] == 0,
          f"prefix hits {st['prefix_hit_tokens']}, starved "
          f"{st['page_starved']}")
    for i in (0, 17, 40, 63):
        want, n = greedy_upto_tie(model, ps[i], budgets[i])
        check(results[i][:n] == want[:n],
              f"ragged request {i} differs from generate before step {n}")
    log("[serve ragged] stats and counters add up; requests 0, 17, 40, 63 "
        "== generate(use_cache=False) up to their first near tie")
    del eng
    _release()



# ---------------------------------------------------------------------------
# phase 4: GPT-2 small trained by the eager Trainer
# ---------------------------------------------------------------------------
def train_weights(shapes, seed):
    """GPT-2's initialisation from numpy's ``default_rng(seed)``: N(0, 0.02)
    matrices and embeddings, LayerNorm gains 1, zero biases."""
    rs = onp.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("gamma"):
            a = onp.ones(shape, "float32")
        elif name.endswith(("beta", "bias")):
            a = onp.zeros(shape, "float32")
        else:
            a = 0.02 * rs.standard_normal(shape, dtype="float32")
        out[name] = a
    return out


def cyclic_batches(rng, vocab, B, T, steps, period=97):
    """A learnable task from the seed: each row walks one fixed cycle of
    ``period`` distinct tokens from its own random offset, so every next
    token follows from the current one."""
    cycle = rng.choice(vocab, size=period, replace=False)
    for _ in range(steps):
        off = rng.randint(0, period, size=(B, 1))
        seq = cycle[(off + onp.arange(T + 1)[None]) % period].astype("int32")
        yield seq[:, :-1], seq[:, 1:]


def make_trainer(model, multi_precision=False):
    """AdamW through ``gluon.Trainer``: peak lr TRAIN_LR after TRAIN_WARMUP
    linear warm-up steps, then a cosine down to a tenth of it at the last
    step; beta2 0.95 and weight decay 0.01 (GPT-3's settings);
    ``multi_precision`` keeps fp32 masters of bf16 weights."""
    from mxnet_tpu_torch import lr_scheduler
    from mxnet_tpu_torch.gluon import Trainer

    sched = lr_scheduler.CosineScheduler(
        max_update=TRAIN_STEPS, base_lr=TRAIN_LR, final_lr=TRAIN_LR / 10,
        warmup_steps=TRAIN_WARMUP)
    return Trainer(model.collect_params(), "adamw",
                   {"learning_rate": TRAIN_LR, "beta2": 0.95, "wd": 0.01,
                    "lr_scheduler": sched,
                    "multi_precision": multi_precision})


def phase_train(smi_line):
    import torch

    from mxnet_tpu_torch import autograd, params_from_mxnet_tpu
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    loss_fn = SoftmaxCrossEntropyLoss()
    model = gpt2_small(dropout=0.0)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    arrays = train_weights(shapes, SEED)
    model.load_dict(params_from_mxnet_tpu(arrays, model))

    # -- (i) one step's gradients: the card against the CPU ----------------
    cpu = gpt2_small(dropout=0.0, device="cpu")
    cpu.load_dict(arrays)
    rng = onp.random.RandomState(SEED + 2)
    toks = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                            .astype("int32"))
    tgt = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                           .astype("int32"))
    valid = torch.tensor([128, 77], dtype=torch.int32)   # row 1 padded
    for net, dev in ((model, DEV), (cpu, "cpu")):
        with autograd.record():
            loss = loss_fn(net(toks.to(dev), valid.to(dev)), tgt.to(dev))
        autograd.backward(loss)
    worst, worst_name = 0.0, None
    cpu_params = cpu.collect_params()
    for name, p in model.collect_params().items():
        want = cpu_params[name].grad
        rel = float((p.grad.cpu() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[train] one step at B=2, T=128 (row 1 right-padded to 77): "
        f"gradients of all {len(cpu_params)} parameters, card vs CPU, "
        f"worst relative max |diff| {worst:.3g} ({worst_name}; limit "
        f"{GRAD_RTOL})")
    check(worst <= GRAD_RTOL, f"card vs CPU gradients differ: {worst:.3g} "
          f"at {worst_name}")
    del model, cpu, cpu_params, net, loss

    # -- (ii) a training run: AdamW through Trainer, dropout 0.1 ------------
    B, T = TRAIN_SHAPE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model = gpt2_small(dropout=0.1)
    model.load_dict(params_from_mxnet_tpu(arrays, model))
    trainer = make_trainer(model)
    losses, step_ms, per_step = [], [], []
    ck.reset_launch_counts()
    batches = list(cyclic_batches(rng, model.vocab_size, B, T, TRAIN_STEPS))
    for x, y in batches:
        before = ck.launch_counts()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(model(torch.from_numpy(x).to(DEV)),
                           torch.from_numpy(y).to(DEV))
        autograd.backward(loss)
        trainer.step(B)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach().mean()))
        after = ck.launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
    counts = read_counts("train")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[2:])
    log(f"[train] gpt2_small B={B} T={T} AdamW (peak lr {TRAIN_LR}, "
        f"{TRAIN_WARMUP} warm-up steps, cosine), dropout 0.1: loss by step "
        f"{[round(v, 3) for v in losses]}")
    log(f"[train] step {med:.2f} ms (median of steps 3-{TRAIN_STEPS}; first "
        f"two {step_ms[0]:.1f}, {step_ms[1]:.1f} ms), {B * T / med * 1e3:.0f} "
        f"training tokens/s, peak device memory {peak / 2**20:.1f} MiB; "
        f"card {smi_line}")
    log(f"[train] kernel launches in {TRAIN_STEPS} steps: {counts}; per "
        f"step {per_step[-1]}")
    check(all(onp.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < 0.5 * losses[0],
          f"the loss did not fall below half its first value: {losses[0]:.3f}"
          f" -> {losses[-1]:.3f}")
    bad = [(i, ps) for i, ps in enumerate(per_step) if ps != TRAIN_WANT]
    check(not bad, f"launches per step: step {bad[:1]} != {TRAIN_WANT}")
    check_default_tiles("train")
    return counts, arrays, batches, losses


# ---------------------------------------------------------------------------
# phase 4b: GPT-2 small trained by the compiled step (one CUDA graph a step)
# ---------------------------------------------------------------------------
def _train_model(arrays, dropout):
    """GPT-2 small on the card holding ``arrays`` (None: draw them with
    ``train_weights``); returns (model, arrays)."""
    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    model = gpt2_small(dropout=dropout)
    if arrays is None:
        arrays = train_weights({n: tuple(p.shape) for n, p in
                                model.collect_params().items()}, SEED)
    model.load_dict(params_from_mxnet_tpu(arrays, model))
    return model, arrays


def _kernel_names(fn):
    """{kernel name: launches} of the CUDA kernels ``fn`` runs, from
    ``torch.profiler`` (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return names


class _OverflowingLoss:
    """Cross entropy times inf: the scaled loss overflows at any scale."""

    def __init__(self):
        from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

        self.ce = SoftmaxCrossEntropyLoss()

    def __call__(self, pred, label):
        return self.ce(pred, label) * float("inf")


def _release():
    """Free what the last run left: a compiled step and its trainer refer
    to each other, so its graph's memory pool goes only with a collection."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _run_training(arrays, batches, compiled, smi_line, tag, amp=False):
    """One training run of GPT-2 small from ``arrays`` over ``batches``
    (dropout 0.1, ``make_trainer``): eager (record / backward /
    ``Trainer.step(B)``) or compiled (``trainer.compile_step``), under
    ``amp.autocast("bfloat16")`` with ``amp``, each step synchronised and
    timed on the host clock. Returns the losses, the step ms and the peak
    device memory."""
    import contextlib

    import torch

    from mxnet_tpu_torch import amp as mxamp
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    _release()
    held = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    trainer = make_trainer(model)
    loss_fn = SoftmaxCrossEntropyLoss()
    step = trainer.compile_step(model, loss_fn) if compiled else None
    losses, ms = [], []
    scope = mxamp.autocast("bfloat16") if amp else contextlib.nullcontext()
    with scope:
        for x, y in batches:
            t0 = time.perf_counter()
            if compiled:
                loss = step(x, y)
            else:
                with autograd.record():
                    loss = loss_fn(model(x), y)
                autograd.backward(loss)
                trainer.step(x.shape[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach().float().mean()))
    peak = torch.cuda.max_memory_allocated() / 2**20
    B, T = batches[0][0].shape
    med = statistics.median(ms[2:])
    log(f"[train-{'amp' if amp else 'compiled'}] timing {tag} "
        f"{'AMP bf16 ' if amp else ''}"
        f"{'compiled' if compiled else 'eager'}: step {med:.2f} ms (median "
        f"of steps 3-{len(ms)}; first two {ms[0]:.1f}, {ms[1]:.1f} ms), "
        f"{B * T / med * 1e3:.0f} training tokens/s, peak device memory "
        f"{peak:.1f} MiB ({held:.1f} MiB held before the run); card "
        f"{smi_line}")
    check(all(onp.isfinite(losses)), f"timing run {tag}: a loss is not "
          "finite")
    del step, trainer, model
    _release()
    return losses, med, peak


def phase_train_compiled(smi_line):
    """GPT-2 small through ``trainer.compile_step``: (i) three compiled
    steps against three eager ones, (ii) 30 training steps, (iii) an
    overflow step, (iv) eager against compiled, A B B A. Returns the
    launch counts of (ii), and its batches and losses."""
    import torch

    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, T = TRAIN_SHAPE
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = onp.random.RandomState(SEED + 3)

    # -- (i) parity: three compiled steps against three eager ones ---------
    _release()
    comp, arrays = _train_model(None, 0.0)
    eager, _ = _train_model(arrays, 0.0)
    vocab = comp.vocab_size

    def device_batches(n):
        return [(torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV))
                for x, y in cyclic_batches(rng, vocab, B, T, n)]

    tr_c, tr_e = make_trainer(comp), make_trainer(eager)
    step = tr_c.compile_step(comp, loss_fn)
    worst = {"loss": 0.0, "weight": 0.0, "state": 0.0}
    where = {}

    def excess(got, want):
        """max of |got - want| / (atol + rtol |want|): <= 1 passes."""
        return float(((got - want).abs() / (COMPILED_ATOL + COMPILED_RTOL
                                             * want.abs())).max())

    for i, (x, y) in enumerate(device_batches(3)):
        lc = step(x, y)
        with autograd.record():
            le = loss_fn(eager(x), y).mean()
        autograd.backward(le)
        tr_e.step(1)
        e = excess(lc, le.detach())
        if e > worst["loss"]:
            worst["loss"], where["loss"] = e, f"step {i + 1}"
    for (n, p), q in zip(comp.collect_params().items(),
                         eager.collect_params().values()):
        e = excess(p.detach(), q.detach())
        if e > worst["weight"]:
            worst["weight"], where["weight"] = e, n
    for i, (sc, se) in enumerate(zip(tr_c._states, tr_e._states)):
        for k in sc:
            e = excess(sc[k], se[k])
            if e > worst["state"]:
                worst["state"], where["state"] = e, f"{k} of {i}"
    log(f"[train-compiled] (i) 3 compiled vs 3 eager AdamW steps at B={B} "
        f"T={T}, dropout 0: worst |diff| / ({COMPILED_ATOL} + "
        f"{COMPILED_RTOL} |eager|): {worst} at {where} (limit 1); "
        f"num_update {tr_c.optimizer.num_update} vs "
        f"{tr_e.optimizer.num_update}; captures {step._traces}")
    check(max(worst.values()) <= 1.0, f"compiled vs eager differ: {worst} "
          f"at {where}")
    check(tr_c.optimizer.num_update == tr_e.optimizer.num_update == 3,
          "num_update after 3 steps")
    check(step._traces == 1, f"{step._traces} captures in (i)")
    del comp, eager, tr_c, tr_e, step, lc, le
    _release()

    # -- (ii) 30 training steps through compile_step, dropout 0.1 -----------
    torch.cuda.reset_peak_memory_stats()
    log(f"[train-compiled] (ii) device memory held before the run: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    trainer = make_trainer(model)
    batches = device_batches(TRAIN_STEPS)
    ck.reset_launch_counts()
    step = trainer.compile_step(model, loss_fn)
    losses, ms = [], []
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        if i == len(batches) - 1:
            holder = []
            names = _kernel_names(lambda: holder.append(step(x, y)))
            loss = holder[0]
        else:
            loss = step(x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = read_counts("train_compiled")
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[train-compiled] (ii) gpt2_small B={B} T={T} AdamW (peak lr "
        f"{TRAIN_LR}, {TRAIN_WARMUP} warm-up steps, cosine), dropout 0.1, "
        f"{TRAIN_STEPS} steps through trainer.compile_step: loss by step "
        f"{[round(v, 3) for v in losses]}")
    log(f"[train-compiled] (ii) step {statistics.median(ms[2:-1]):.2f} ms "
        f"(median of steps 3-{TRAIN_STEPS - 1}, synchronised; first "
        f"{ms[0]:.1f} ms: warm step and capture), peak device memory "
        f"{peak:.1f} MiB; captures {step._traces}; card {smi_line}")
    log(f"[train-compiled] (ii) launch counters: captured body "
        f"{step.captured_launches}, whole run (warm step + capture) "
        f"{counts}; {TRAIN_STEPS - 1} replays ran the captured body")
    found = {k: n for k, n in names.items() if any(
        w + "_kernel" in k.lower() for w in TRAIN_WANT)}
    log(f"[train-compiled] (ii) the profiler's kernels in step "
        f"{TRAIN_STEPS} (one replay): {len(names)} kernel names, "
        f"{sum(names.values())} launches; the port's kernels: {found}")
    check(all(onp.isfinite(losses)), "a compiled training loss is not "
          "finite")
    check(losses[-1] < 0.5 * losses[0],
          f"the compiled run's loss did not fall below half its first "
          f"value: {losses[0]:.3f} -> {losses[-1]:.3f}")
    check(step._traces == 1, f"{step._traces} captures in 30 steps")
    check(step.captured_launches == TRAIN_WANT,
          f"captured launches {step.captured_launches} != {TRAIN_WANT}")
    check(counts == {k: 2 * n for k, n in TRAIN_WANT.items()},
          f"launches outside the warm step and the capture: {counts}")
    for w, n in TRAIN_WANT.items():
        got = sum(c for k, c in names.items() if w + "_kernel" in k.lower())
        check(got == n, f"the profiler found {got} {w} kernels in one "
              f"replay, not {n}")
    check_default_tiles("train-compiled")
    run_ii = (batches, losses)
    del step, model, trainer, batches, loss, holder
    _release()

    # -- (iii) an overflowing step is a bitwise no-op --------------------------
    model, _ = _train_model(arrays, 0.0)
    trainer = make_trainer(model)
    scaler = amp.DynamicLossScaler()
    step = trainer.compile_step(model, _OverflowingLoss(),
                                loss_scaler=scaler)
    (x, y), = device_batches(1)
    snap = [p.detach().clone() for p in model.collect_params().values()]
    scale0 = scaler.loss_scale
    for call in ("warm step", "replay"):
        step(x, y)
        moved = [n for (n, p), s in zip(model.collect_params().items(), snap)
                 if not torch.equal(p.detach(), s)]
        log(f"[train-compiled] (iii) overflowing {call}: scale "
            f"{scaler.loss_scale}, num_update "
            f"{trainer.optimizer.num_update}, weights moved: {moved}")
        check(not moved, f"the overflowing {call} moved {moved}")
        check(trainer.optimizer.num_update == 0,
              f"num_update moved on overflow ({call})")
    check(scaler.loss_scale == scale0 / 4,
          f"the scale went {scale0} -> {scaler.loss_scale}, not halved "
          "twice")
    check(step._traces == 1, "the overflow step captured twice")
    del step, model, trainer, snap
    _release()

    # -- (iv) eager (A) and compiled (B), in the order A B B A ---------------
    batches = device_batches(TRAIN_STEPS)
    runs = {}
    for tag, compiled in (("A1", False), ("B1", True), ("B2", True),
                          ("A2", False)):
        runs[tag] = _run_training(arrays, batches, compiled, smi_line, tag)
    a = [runs["A1"][1], runs["A2"][1]]
    b = [runs["B1"][1], runs["B2"][1]]
    log(f"[train-compiled] (iv) eager {a} ms, compiled {b} ms a step "
        f"(medians, A B B A); peak MiB eager "
        f"{[runs['A1'][2], runs['A2'][2]]}, compiled "
        f"{[runs['B1'][2], runs['B2'][2]]}; card {smi_line}")
    return counts, run_ii


# ---------------------------------------------------------------------------
# phase 4c: GPT-2 small trained under AMP (bf16), compiled and converted
# ---------------------------------------------------------------------------
BF16 = ("bfloat16",)
AMP_WANT = {("flash_fwd", BF16): 12, ("flash_bwd_dkv", BF16): 12,
            ("flash_bwd_dq", BF16): 12,
            ("layer_norm", ("float32", "float32")): 25}
CONVERTED_WANT = {**AMP_WANT, ("layer_norm", ("float32", "float32")): 0,
                  ("layer_norm", ("bfloat16", "float32")): 25}
AMP_GRAD_RTOL = 3e-2       # bf16's roundoff 3.9e-3, GEMM orders, 12 layers
AMP_LOSS_RATIO = 1.25      # last AMP loss against the fp32 run's
CONVERTED_STEPS = 10


def phase_train_amp(smi_line, fp32_run):
    """GPT-2 small under ``amp.autocast("bfloat16")``: (i) one eager step's
    gradients against the CPU's, (ii) three compiled AMP steps against
    three eager ones, (iii) 30 compiled AMP steps on the batches, weights
    and dropout seed of phase 4b (ii)'s fp32 run (``fp32_run``: its
    batches and losses), so that precision is all that differs, (iv) a
    block converted by ``amp.convert_hybrid_block`` with multi-precision
    AdamW, 10 eager steps, (v) fp32 compiled (A) against AMP compiled (B),
    A B B A on one set of batches."""
    import torch

    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, T = TRAIN_SHAPE
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = onp.random.RandomState(SEED + 4)

    # -- (i) one AMP step's gradients: the card against the CPU --------------
    _release()
    model, arrays = _train_model(None, 0.0)
    cpu = gpt2_small(dropout=0.0, device="cpu")
    cpu.load_dict(arrays)
    toks = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                            .astype("int32"))
    tgt = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                           .astype("int32"))
    valid = torch.tensor([128, 77], dtype=torch.int32)   # row 1 padded
    ck.reset_launch_counts()
    for net, dev in ((model, DEV), (cpu, "cpu")):
        with amp.autocast("bfloat16"):
            with autograd.record():
                logits = net(toks.to(dev), valid.to(dev))
                loss = loss_fn(logits, tgt.to(dev))
            autograd.backward(loss)
        check(logits.dtype == loss.dtype == torch.bfloat16,
              f"[{dev}] AMP logits {logits.dtype}, loss {loss.dtype}: not "
              f"bfloat16")
    dts = ck.dtype_counts()
    worst, worst_name = 0.0, None
    cpu_params = cpu.collect_params()
    for name, p in model.collect_params().items():
        want = cpu_params[name].grad
        check(p.grad.dtype == want.dtype == torch.float32,
              f"{name}: gradient dtype {p.grad.dtype} on the card, "
              f"{want.dtype} on the CPU, not float32")
        rel = float((p.grad.cpu() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[train-amp] (i) one AMP (bf16) step at B=2, T=128 (row 1 "
        f"right-padded to 77): logits and loss bfloat16, gradients float32; "
        f"all {len(cpu_params)} gradients card vs CPU, worst relative max "
        f"|diff| {worst:.3g} ({worst_name}; limit {AMP_GRAD_RTOL}); "
        f"launches by dtype {dts}")
    check(worst <= AMP_GRAD_RTOL, f"AMP card vs CPU gradients differ: "
          f"{worst:.3g} at {worst_name}")
    check(dts == AMP_WANT, f"AMP step launches by dtype {dts} != "
          f"{AMP_WANT}")
    del model, cpu, cpu_params, net, loss, logits

    # -- (ii) three compiled AMP steps against three eager ones --------------
    _release()
    comp, _ = _train_model(arrays, 0.0)
    eager, _ = _train_model(arrays, 0.0)
    vocab = comp.vocab_size

    def device_batches(n):
        return [(torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV))
                for x, y in cyclic_batches(rng, vocab, B, T, n)]

    tr_c, tr_e = make_trainer(comp), make_trainer(eager)
    step = tr_c.compile_step(comp, loss_fn)
    worst = {"loss": 0.0, "weight": 0.0, "state": 0.0}
    where, bitwise = {}, True

    def excess(got, want):
        return float(((got.float() - want.float()).abs()
                      / (COMPILED_ATOL + COMPILED_RTOL
                         * want.float().abs())).max())

    with amp.autocast("bfloat16"):
        for i, (x, y) in enumerate(device_batches(3)):
            lc = step(x, y)
            with autograd.record():
                le = loss_fn(eager(x), y).mean()
            autograd.backward(le)
            tr_e.step(1)
            bitwise &= bool(torch.equal(lc, le.detach().float()))
            e = excess(lc, le.detach())
            if e > worst["loss"]:
                worst["loss"], where["loss"] = e, f"step {i + 1}"
    for (n, p), q in zip(comp.collect_params().items(),
                         eager.collect_params().values()):
        bitwise &= bool(torch.equal(p, q))
        e = excess(p.detach(), q.detach())
        if e > worst["weight"]:
            worst["weight"], where["weight"] = e, n
    for i, (sc, se) in enumerate(zip(tr_c._states, tr_e._states)):
        for k in sc:
            bitwise &= bool(torch.equal(sc[k], se[k]))
            e = excess(sc[k], se[k])
            if e > worst["state"]:
                worst["state"], where["state"] = e, f"{k} of {i}"
    log(f"[train-amp] (ii) 3 compiled vs 3 eager AMP AdamW steps at B={B} "
        f"T={T}, dropout 0: worst |diff| / ({COMPILED_ATOL} + "
        f"{COMPILED_RTOL} |eager|): {worst} at {where} (limit 1); "
        f"bit-equal {bitwise}; captures {step._traces}")
    check(max(worst.values()) <= 1.0, f"compiled vs eager AMP steps differ: "
          f"{worst} at {where}")
    check(step._traces == 1, f"{step._traces} captures in (ii)")
    del comp, eager, tr_c, tr_e, step, lc, le
    _release()

    # -- (iii) 30 compiled AMP steps, dropout 0.1, phase 4b (ii)'s run --------
    batches, fp32_losses = fp32_run
    fp32_final_loss = fp32_losses[-1]
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    trainer = make_trainer(model)
    losses, ms = [], []
    ck.reset_launch_counts()
    with amp.autocast("bfloat16"):
        step = trainer.compile_step(model, loss_fn)
        for i, (x, y) in enumerate(batches):
            t0 = time.perf_counter()
            if i == len(batches) - 1:
                holder = []
                names = _kernel_names(lambda: holder.append(step(x, y)))
                loss = holder[0]
            else:
                loss = step(x, y)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
    counts = read_counts("train_amp")
    peak = torch.cuda.max_memory_allocated() / 2**20
    found = {k: n for k, n in names.items() if any(
        w + "_kernel" in k.lower() for w in TRAIN_WANT)}
    log(f"[train-amp] (iii) gpt2_small B={B} T={T} AdamW, dropout 0.1, "
        f"{TRAIN_STEPS} compiled AMP (bf16) steps on phase 4b (ii)'s "
        f"batches, weights and dropout seed: loss by step "
        f"{[round(v, 3) for v in losses]}; the fp32 run's "
        f"{[round(v, 3) for v in fp32_losses]}")
    log(f"[train-amp] (iii) step {statistics.median(ms[2:-1]):.2f} ms "
        f"(median of steps 3-{TRAIN_STEPS - 1}, synchronised; first "
        f"{ms[0]:.1f} ms: warm step and capture), peak device memory "
        f"{peak:.1f} MiB; captures {step._traces}; captured launches "
        f"{step.captured_launches}, by dtype {step.captured_dtypes}; card "
        f"{smi_line}")
    log(f"[train-amp] (iii) the profiler's kernels in step {TRAIN_STEPS} "
        f"(one replay): {len(names)} kernel names, {sum(names.values())} "
        f"launches; the port's kernels: {found}")
    check(all(onp.isfinite(losses)), "an AMP training loss is not finite")
    check(losses[-1] < 0.5 * losses[0],
          f"the AMP run's loss did not fall below half its first value: "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    check(losses[-1] <= AMP_LOSS_RATIO * fp32_final_loss,
          f"the AMP run ended at {losses[-1]:.3f}, above {AMP_LOSS_RATIO} x "
          f"the fp32 run's {fp32_final_loss:.3f}")
    check(step._traces == 1, f"{step._traces} captures in 30 AMP steps")
    check(step.captured_launches == TRAIN_WANT,
          f"captured launches {step.captured_launches} != {TRAIN_WANT}")
    check(step.captured_dtypes == AMP_WANT,
          f"captured launches by dtype {step.captured_dtypes} != {AMP_WANT}")
    check(counts == {k: 2 * n for k, n in TRAIN_WANT.items()},
          f"launches outside the warm step and the capture: {counts}")
    for w, n in TRAIN_WANT.items():
        mine = {k: c for k, c in found.items() if w + "_kernel" in k.lower()}
        check(sum(mine.values()) == n, f"the profiler found "
              f"{sum(mine.values())} {w} kernels in one replay, not {n}")
        bf16_names = [k for k in mine if "bfloat16" in k.lower()]
        want_bf16 = w.startswith("flash")
        check(len(bf16_names) == (len(mine) if want_bf16 else 0),
              f"{w}: the replay ran {mine}, not the "
              f"{'bf16' if want_bf16 else 'fp32'} instance")
    check_default_tiles("train-amp")
    del step, model, trainer, batches, loss, holder
    _release()

    # -- (iv) a converted block with multi-precision AdamW -------------------
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    amp.convert_hybrid_block(model)
    trainer = make_trainer(model, multi_precision=True)
    bad = [n for n, p in model.collect_params().items() if p.dtype != (
        torch.float32 if n.endswith(("gamma", "beta")) else torch.bfloat16)]
    check(not bad, f"convert_hybrid_block left these in another dtype: {bad}")
    losses, per_step, ms = [], [], []
    ck.reset_launch_counts()
    with amp.autocast("bfloat16"):
        for x, y in device_batches(CONVERTED_STEPS):
            before = ck.dtype_counts()
            t0 = time.perf_counter()
            with autograd.record():
                loss = loss_fn(model(x), y)
            autograd.backward(loss)
            trainer.step(B)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach().float().mean()))
            after = ck.dtype_counts()
            per_step.append({k: after.get(k, 0) - before.get(k, 0)
                             for k in CONVERTED_WANT})
    read_counts("train_amp_converted")
    masters = [st["weight_fp32"] for st in trainer._states
               if st is not None and "weight_fp32" in st]
    n_bf16 = sum(p.dtype == torch.bfloat16 for p in model.parameters())
    log(f"[train-amp] (iv) converted block (non-norm weights bf16), AdamW "
        f"multi_precision, dropout 0.1, {CONVERTED_STEPS} eager steps at "
        f"B={B} T={T}: loss by step {[round(v, 3) for v in losses]}; "
        f"{statistics.median(ms[2:]):.2f} ms a step; {len(masters)} fp32 "
        f"masters for {n_bf16} bf16 weights; launches by dtype a step "
        f"{per_step[-1]}")
    check(all(onp.isfinite(losses)), "a converted-block loss is not finite")
    check(losses[-1] < losses[0], f"the converted block's loss did not "
          f"fall: {losses[0]:.3f} -> {losses[-1]:.3f}")
    check(len(masters) == n_bf16 and all(
        m.dtype == torch.float32 for m in masters),
          f"{len(masters)} masters for {n_bf16} bf16 weights")
    bad = [(i, ps) for i, ps in enumerate(per_step) if ps != CONVERTED_WANT]
    check(not bad, f"converted-block launches by dtype: step {bad[:1]} != "
          f"{CONVERTED_WANT}")
    del model, trainer, masters, loss
    _release()

    # -- (v) fp32 compiled (A) and AMP compiled (B), A B B A ------------------
    batches = device_batches(TRAIN_STEPS)
    runs = {}
    for tag, use_amp in (("A1", False), ("B1", True), ("B2", True),
                         ("A2", False)):
        runs[tag] = _run_training(arrays, batches, True, smi_line, tag,
                                  amp=use_amp)
    log(f"[train-amp] (v) compiled fp32 "
        f"{[runs['A1'][1], runs['A2'][1]]} ms, compiled AMP bf16 "
        f"{[runs['B1'][1], runs['B2'][1]]} ms a step (medians of steps "
        f"3-{TRAIN_STEPS}, A B B A); training tokens/s fp32 "
        f"{[round(B * T / runs[t][1] * 1e3) for t in ('A1', 'A2')]}, AMP "
        f"{[round(B * T / runs[t][1] * 1e3) for t in ('B1', 'B2')]}; peak "
        f"MiB fp32 {[runs['A1'][2], runs['A2'][2]]}, AMP "
        f"{[runs['B1'][2], runs['B2'][2]]}; last losses fp32 "
        f"{[round(runs[t][0][-1], 3) for t in ('A1', 'A2')]}, AMP "
        f"{[round(runs[t][0][-1], 3) for t in ('B1', 'B2')]}; card "
        f"{smi_line}")


# ---------------------------------------------------------------------------
# phase 4e: GPT-2 small under float16 AMP, fp8 attention, served under AMP
# ---------------------------------------------------------------------------
F16 = ("float16",)
AMP16_WANT = {("flash_fwd", F16): 12, ("flash_bwd_dkv", F16): 12,
              ("flash_bwd_dq", F16): 12,
              ("layer_norm", ("float32", "float32")): 25}
CONVERTED16_WANT = {**AMP16_WANT, ("layer_norm", ("float32", "float32")): 0,
                    ("layer_norm", ("float16", "float32")): 25}
AMP16_GRAD_RTOL = 1e-2     # fp16's roundoff 4.9e-4, GEMM orders, 12 layers
AMP16_CHECK_SCALE = 2.0 ** 12   # (i)'s static scale: 10.8 x 4096 < 65504
AMP16_CHECK_SHAPE = (2, 16)     # (i): float16 products on the card's host
                                # CPU ran ~0.4 s a token (110 s at (2, 128))
AMP16_WINDOW = 10          # (iii): clean steps before the scale doubles
AMP16_FORCED = 20          # (iii): the step whose scale is forced past
AMP16_FORCED_SCALE = 2.0 ** 24  # float16's range
AMP16_SERVE = dict(max_prompt_len=128, prefill_batch=2, prefix_cache=False)
AMP16_PROMPTS = 4
AMP16_NEW = 16
AMP16_LIMIT_S = 60.0       # the phase's seconds, the build excluded


class _PlainSpy:
    """Counts the flash and softmax plain versions' calls on CUDA tensors
    while installed (the path must launch the kernels instead)."""

    NAMES = ("attention_plain", "attention_bwd_plain", "softmax_plain")

    def __init__(self):
        from mxnet_tpu_torch.ops import cuda_kernels as ck

        self.ck, self.calls, self.saved = ck, 0, {}

    def __enter__(self):
        for n in self.NAMES:
            fn = self.saved[n] = getattr(self.ck, n)

            def spy(*a, _fn=fn, **kw):
                if getattr(a[0], "is_cuda", False):
                    self.calls += 1
                return _fn(*a, **kw)

            setattr(self.ck, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ck, n, fn)

    @contextlib.contextmanager
    def paused(self):
        """The originals back in place: calls that check the path."""
        self.__exit__()
        try:
            yield
        finally:
            self.__enter__()


def _amp_tokens_agree(model, dtype, prompt, got, max_new, under_amp):
    """``got`` against ``generate(use_cache=False)`` on the card, under
    ``autocast(dtype)`` where ``under_amp`` (else the model as converted),
    up to the first step whose top-2 margin is below eight steps of the
    format at the largest logit (a nearer tie may fall either way between
    the engine's paged attention and the full forward). Returns the steps
    compared."""
    import contextlib

    import torch

    from mxnet_tpu_torch import amp

    with amp.autocast(dtype) if under_amp else contextlib.nullcontext():
        want = model.generate(prompt, max_new_tokens=max_new,
                              use_cache=False,
                              window=len(prompt) + max_new)[len(prompt):]
        seq = torch.tensor([prompt + want], dtype=torch.int32,
                           device=model.device)
        with torch.inference_mode():
            logits = model(seq)[0, len(prompt) - 1:len(prompt) + max_new - 1]
    logits = logits.float()
    u = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -11
    near = 8 * u * float(logits.abs().max())
    top = torch.topk(logits, 2, dim=-1).values
    n = next((j for j, m in enumerate((top[:, 0] - top[:, 1]).tolist())
              if m < near), max_new)
    check(got[:n] == want[:n], f"{dtype} engine tokens {got} differ from "
          f"naive generation {want} before the first near tie at {n}")
    return n


def phase_amp16(smi_line, fp32_run):
    """GPT-2 small under ``amp.autocast("float16")``: (i) one eager step's
    gradients against the CPU's, (ii) three compiled steps against three
    eager ones, (iii) 30 compiled steps with a DynamicLossScaler on phase
    4b (ii)'s batches, weights and dropout seed (``fp32_run``; None: made
    here from the seed), with a forced overflow, (iv) a block converted by
    ``amp.convert_hybrid_block(net, "float16")`` with multi-precision AdamW,
    (v) DecodeEngines built under ``autocast("float16")`` and
    ``("bfloat16")`` and over a converted bf16 model, their tokens against
    naive generation, (vi) the flash op forward and backward under
    ``autocast`` at float8_e4m3fn and float8_e5m2. Returns the path's
    launches by dtype."""
    import torch

    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.base import cast
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops import nn as tnn

    t_phase = time.perf_counter()
    B, T = TRAIN_SHAPE
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = onp.random.RandomState(SEED + 26)
    path = {}

    def take(keep=True):
        """The launches by dtype since the last take, added to the path's
        unless they only checked the path (``keep`` False)."""
        got = ck.dtype_counts()
        for k, n in got.items():
            if keep:
                path[k] = path.get(k, 0) + n
        ck.reset_launch_counts()
        return got

    laps = {}
    t_lap = [time.perf_counter()]

    def lap(tag):
        """Seconds since the last lap, kept under ``tag``."""
        now = time.perf_counter()
        laps[tag] = round(now - t_lap[0], 2)
        t_lap[0] = now

    spy = _PlainSpy().__enter__()
    try:
        # -- (i) one float16 step's gradients: the card against the CPU ----
        _release()
        model, arrays = _train_model(None, 0.0)
        cpu = gpt2_small(dropout=0.0, device="cpu")
        cpu.load_dict(arrays)
        lap("(i) models")
        toks = torch.from_numpy(rng.randint(
            0, model.vocab_size, AMP16_CHECK_SHAPE).astype("int32"))
        tgt = torch.from_numpy(rng.randint(
            0, model.vocab_size, AMP16_CHECK_SHAPE).astype("int32"))
        T1 = AMP16_CHECK_SHAPE[1]
        valid = torch.tensor([T1, T1 - 5], dtype=torch.int32)
        ck.reset_launch_counts()
        for net, dev in ((model, DEV), (cpu, "cpu")):
            tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
            amp.attach_loss_scaler(tr, amp.StaticLossScaler(
                AMP16_CHECK_SCALE))
            with amp.autocast("float16"):
                with autograd.record():
                    logits = net(toks.to(dev), valid.to(dev))
                    loss = loss_fn(logits, tgt.to(dev))
                    with amp.scale_loss(loss, tr) as scaled:
                        pass
                autograd.backward(scaled)
            amp.unscale(tr)
            check(logits.dtype == loss.dtype == torch.float16,
                  f"[{dev}] float16 AMP logits {logits.dtype}, loss "
                  f"{loss.dtype}")
            if dev == DEV:
                dts = take()
            lap(f"(i) {dev} step")
        worst, worst_name = 0.0, None
        cpu_params = cpu.collect_params()
        for name, p in model.collect_params().items():
            want = cpu_params[name].grad
            check(p.grad.dtype == want.dtype == torch.float32 and
                  bool(torch.isfinite(p.grad).all()),
                  f"{name}: gradient {p.grad.dtype} on the card, "
                  f"{want.dtype} on the CPU, or not finite")
            rel = float((p.grad.cpu() - want).abs().max()
                        / want.abs().max().clamp_min(1e-30))
            if rel > worst:
                worst, worst_name = rel, name
        log(f"[amp16] (i) one float16 AMP step at B=2, T={T1} (row 1 "
            f"right-padded to {T1 - 5}), loss scaled by "
            f"{AMP16_CHECK_SCALE:g} "
            f"and unscaled: logits and loss float16, gradients float32; "
            f"all {len(cpu_params)} card vs CPU, worst relative max |diff| "
            f"{worst:.3g} ({worst_name}; limit {AMP16_GRAD_RTOL}); launches "
            f"by dtype {dts}")
        check(worst <= AMP16_GRAD_RTOL, f"float16 AMP card vs CPU gradients "
              f"differ: {worst:.3g} at {worst_name}")
        check(dts == AMP16_WANT, f"float16 AMP step launches by dtype {dts}"
              f" != {AMP16_WANT}")
        del model, cpu, cpu_params, net, loss, logits, scaled, tr
        lap("(i) checks")

        # -- (ii) three compiled float16 steps against three eager ones ----
        _release()
        comp, _ = _train_model(arrays, 0.0)
        eager, _ = _train_model(arrays, 0.0)
        vocab = comp.vocab_size

        def device_batches(n):
            return [(torch.from_numpy(x).to(DEV),
                     torch.from_numpy(y).to(DEV))
                    for x, y in cyclic_batches(rng, vocab, B, T, n)]

        tr_c, tr_e = make_trainer(comp), make_trainer(eager)
        step = tr_c.compile_step(comp, loss_fn)
        worst = {"loss": 0.0, "weight": 0.0}
        bitwise = True

        def excess(got, want):
            return float(((got.float() - want.float()).abs()
                          / (COMPILED_ATOL + COMPILED_RTOL
                             * want.float().abs())).max())

        with amp.autocast("float16"):
            for x, y in device_batches(3):
                lc = step(x, y)
                with autograd.record():
                    le = loss_fn(eager(x), y).mean()
                autograd.backward(le)
                tr_e.step(1)
                bitwise &= bool(torch.equal(lc, le.detach().float()))
                worst["loss"] = max(worst["loss"], excess(lc, le.detach()))
        for p, q in zip(comp.collect_params().values(),
                        eager.collect_params().values()):
            bitwise &= bool(torch.equal(p, q))
            worst["weight"] = max(worst["weight"], excess(p.detach(),
                                                          q.detach()))
        take()
        log(f"[amp16] (ii) 3 compiled vs 3 eager float16 AMP AdamW steps "
            f"at B={B} T={T}: worst |diff| / ({COMPILED_ATOL} + "
            f"{COMPILED_RTOL} |eager|) {worst} (limit 1); bit-equal "
            f"{bitwise}; captures {step._traces}; captured launches by "
            f"dtype {step.captured_dtypes}")
        check(max(worst.values()) <= 1.0, f"compiled vs eager float16 steps "
              f"differ: {worst}")
        check(step._traces == 1 and step.captured_dtypes == AMP16_WANT,
              f"(ii): {step._traces} captures, captured launches "
              f"{step.captured_dtypes} != {AMP16_WANT}")
        del comp, eager, tr_c, tr_e, step, lc, le
        _release()
        lap("(ii)")

        # -- (iii) 30 compiled float16 steps with a DynamicLossScaler ------
        if fp32_run is None:
            batches = device_batches(TRAIN_STEPS)
        else:
            batches = fp32_run[0]
        mxrandom.seed(SEED)
        model, _ = _train_model(arrays, 0.1)
        trainer = make_trainer(model)
        scaler = amp.attach_loss_scaler(trainer, amp.DynamicLossScaler(
            scale_window=AMP16_WINDOW))
        losses, scales, updates, ms = [], [], [], []
        snap = None
        with amp.autocast("float16"):
            step = trainer.compile_step(model, loss_fn)
            for i, (x, y) in enumerate(batches):
                if i == AMP16_FORCED:
                    kept = scaler.loss_scale
                    scaler.loss_scale = AMP16_FORCED_SCALE
                    snap = [p.detach().clone()
                            for p in model.collect_params().values()]
                t0 = time.perf_counter()
                loss = step(x, y)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
                scales.append(scaler.loss_scale)
                updates.append(trainer.optimizer.num_update)
                if i == AMP16_FORCED:
                    moved = [n for (n, p), s in zip(
                        model.collect_params().items(), snap)
                        if not torch.equal(p.detach(), s)]
                    check(not moved, f"(iii) the forced overflow moved "
                          f"{moved}")
                    scaler.loss_scale = kept    # back to the run's scale
        counts = take()
        skipped = [i for i in range(len(updates))
                   if updates[i] == (updates[i - 1] if i else 0)]
        log(f"[amp16] (iii) gpt2_small B={B} T={T} AdamW, dropout 0.1, "
            f"{TRAIN_STEPS} compiled float16 AMP steps on phase 4b (ii)'s "
            f"batches, weights and dropout seed, DynamicLossScaler (init "
            f"2**16, window {AMP16_WINDOW}), scale forced to "
            f"{AMP16_FORCED_SCALE:g} at step {AMP16_FORCED + 1}: loss by "
            f"step {[round(v, 3) for v in losses]}; scale after each step "
            f"{scales}; skipped steps {[i + 1 for i in skipped]}; "
            f"num_update {updates[-1]}; step "
            f"{statistics.median(ms[2:]):.2f} ms (median of steps 3-"
            f"{TRAIN_STEPS}); captures {step._traces}; captured launches by "
            f"dtype {step.captured_dtypes}; card {smi_line}")
        trained = [losses[i] for i in range(len(losses)) if i not in skipped]
        check(all(onp.isfinite(losses)), "(iii) a float16 loss is not "
              "finite")
        check(0 in skipped and AMP16_FORCED in skipped,
              f"(iii) the overflowing steps were not skipped: {skipped}")
        check(all(scales[i] == (scales[i - 1] if i else 2.0 ** 16) / 2
                  for i in skipped if i != AMP16_FORCED) and
              scales[AMP16_FORCED] == AMP16_FORCED_SCALE / 2,
              f"(iii) a skip did not halve the scale: {scales}")
        check(any(scales[i] == 2 * scales[i - 1] for i in range(1, len(
            scales))), f"(iii) the scale never grew: {scales}")
        check(updates[-1] == len(losses) - len(skipped),
              f"(iii) num_update {updates[-1]} for "
              f"{len(losses) - len(skipped)} clean steps")
        check(trained[-1] < 0.5 * losses[0],
              f"(iii) the float16 run's loss did not fall below half its "
              f"first value: {losses[0]:.3f} -> {trained[-1]:.3f}")
        check(step._traces == 1 and step.captured_dtypes == AMP16_WANT,
              f"(iii): {step._traces} captures, captured launches "
              f"{step.captured_dtypes} != {AMP16_WANT}")
        check(counts == {k: 2 * n for k, n in AMP16_WANT.items()},
              f"(iii) launches outside the warm step and the capture: "
              f"{counts}")
        del step, model, trainer, batches, loss, snap
        _release()
        lap("(iii)")

        # -- (iv) convert_hybrid_block(net, "float16"), multi-precision ----
        model, _ = _train_model(arrays, 0.0)
        amp.convert_hybrid_block(model, "float16")
        trainer = make_trainer(model, multi_precision=True)
        scaler = amp.attach_loss_scaler(trainer, amp.StaticLossScaler(
            AMP16_CHECK_SCALE))
        bad = [n for n, p in model.collect_params().items() if p.dtype != (
            torch.float32 if n.endswith(("gamma", "beta")) else
            torch.float16)]
        check(not bad, f"convert_hybrid_block(float16) left {bad}")
        conv_losses, per_step = [], []
        for x, y in device_batches(3):
            with autograd.record():
                loss = loss_fn(model(x), y)
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
            autograd.backward(scaled)
            check(not scaler.has_overflow(trainer._params),
                  "(iv) the converted block's gradients overflowed")
            amp.unscale(trainer)
            trainer.step(B)
            conv_losses.append(float(loss.detach().float().mean()))
            per_step.append(take())
        masters = [st["weight_fp32"] for st in trainer._states
                   if st is not None and "weight_fp32" in st]
        n16 = sum(p.dtype == torch.float16 for p in model.parameters())
        log(f"[amp16] (iv) converted float16 block (norms fp32), AdamW "
            f"multi_precision, loss scaled by {AMP16_CHECK_SCALE:g}: losses "
            f"{[round(v, 3) for v in conv_losses]}; {len(masters)} fp32 "
            f"masters for {n16} float16 weights; launches by dtype a step "
            f"{per_step[-1]}")
        check(all(onp.isfinite(conv_losses)), "(iv) a loss is not finite")
        check(len(masters) == n16 and all(m.dtype == torch.float32
                                          for m in masters),
              f"(iv) {len(masters)} masters for {n16} float16 weights")
        want16 = {k: n for k, n in CONVERTED16_WANT.items() if n}
        check(all(ps == want16 for ps in per_step),
              f"(iv) launches by dtype {per_step} != {CONVERTED16_WANT}")
        del model, trainer, masters, loss, scaled
        _release()
        lap("(iv)")

        # -- (v) engines under AMP against naive generation ----------------
        model, _ = serve_model()
        prompts = [[int(t) for t in rng.randint(0, model.vocab_size,
                                               size=n)]
                   for n in rng.randint(16, 121, size=AMP16_PROMPTS)]
        for mode in ("autocast:float16", "autocast:bfloat16",
                     "convert:bfloat16"):
            how, dtype = mode.split(":")
            if how == "convert":
                amp.convert_hybrid_block(model, dtype)
                eng, info = warm_engine(model, f"amp16 {mode}",
                                        **AMP16_SERVE)
            else:
                with amp.autocast(dtype):
                    eng, info = warm_engine(model, f"amp16 {mode}",
                                            **AMP16_SERVE)
            warm = take()
            t = time.perf_counter()
            streams = [eng.submit(p, max_new_tokens=AMP16_NEW)
                       for p in prompts]
            outs = [s.result(timeout=300) for s in streams]
            serve_s = time.perf_counter() - t
            moved = take()
            cache_dt = eng.programs.cache_dtype
            eng.close()
            del eng
            agreed = [_amp_tokens_agree(model, dtype, p, o, AMP16_NEW,
                                        how == "autocast")
                      for p, o in zip(prompts, outs)]
            take(keep=False)   # naive generation checked the engine
            flash = {k: n for k, n in warm.items() if k[0] == "flash_fwd"}
            log(f"[amp16] (v) engine {mode}: {info['captures']} captures; "
                f"launches by dtype at warmup (captures and warm calls) "
                f"{warm}; {len(prompts)} prompts of "
                f"{[len(p) for p in prompts]} tokens, {AMP16_NEW} new each, "
                f"in {serve_s:.2f} s; tokens equal to naive generation up to "
                f"the first near tie: steps {agreed}; KV cache {cache_dt}")
            check(cache_dt == "float32", f"(v) {mode}: KV cache {cache_dt}, "
                  f"not the model's float32")
            check(set(flash) == {("flash_fwd", (dtype,))},
                  f"(v) {mode}: prefill flash launches {flash}, not the "
                  f"{dtype} instance alone")
            check(not moved, f"(v) {mode}: counters moved while serving "
                  f"(a capture after warmup): {moved}")
            lap(f"(v) {mode}")
        del model
        _release()

        # -- (vi) the flash op under fp8 AMP: forward and backward ---------
        Bh, H, Tf, D = 4, 12, 1024, 64
        for dtype in ("float8_e4m3fn", "float8_e5m2"):
            q, k, v, g = (torch.from_numpy(rng.randn(Bh, H, Tf, D).astype(
                "float32")).to(DEV) for _ in range(4))
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            with amp.autocast(dtype):
                with autograd.record():
                    out = tnn.flash_attention(*ins, causal=True)
                torch.autograd.backward(out.float(), g)
            (bq, bk), = [t for (n, t) in ck.tile_counts()
                         if n == "flash_fwd"]
            got = take()
            want_dt = {(n, (dtype,)): 1 for n in ("flash_fwd",
                                                  "flash_bwd_dkv",
                                                  "flash_bwd_dq")}
            check(got == want_dt, f"(vi) {dtype} launches {got} != "
                  f"{want_dt}")
            # the kernel's out against the plain version with its
            # roundings at its key tile, the fp8 gradients (exact in the
            # fp32 ones the casts hand back) against the plain backward from
            # the kernel's out and lse (these calls check the path, they
            # are not on it)
            cq, ck_, cv, gd = (cast(t, dtype) for t in (q, k, v, g))
            fl = _tests_script("torch_flash_limits")
            with spy.paused():
                _, lse = ck.attention_tiled_plain(cq, ck_, cv, 1 / 8, True,
                                                  None, None, bk)
                e = fl.flash_excess(cq, ck_, cv, gd, out.detach(), lse,
                                    [cast(t.grad, dtype) for t in ins],
                                    None, None, 1 / 8, True, bk, dtype)
            e.pop("lse")
            ex = [e["out"], e["dq"], e["dk"], e["dv"]]
            fin = all(bool(torch.isfinite(t.grad).all()) for t in ins)
            log(f"[amp16] (vi) flash op under autocast({dtype}) at ({Bh}*"
                f"{H}, {Tf}, {D}) causal: out {out.dtype}, gradients "
                f"{[t.grad.dtype for t in ins]} finite {fin}; |diff| / "
                f"limit against the plain versions out, dq, dk, dv {ex}")
            check(out.dtype == getattr(torch, dtype) and fin and
                  all(t.grad.dtype == torch.float32 for t in ins),
                  f"(vi) {dtype}: out {out.dtype}, gradients finite {fin}")
            check(max(ex) <= 1.0, f"(vi) {dtype}: over the limit {ex}")
            del q, k, v, g, ins, out
        lap("(vi)")
    finally:
        spy.__exit__()
    lib = ck.library_counts()
    took = time.perf_counter() - t_phase
    log(f"[amp16] the path's launches by dtype {path}; plain flash/softmax "
        f"calls on the card {spy.calls}; library lowerings {lib}; phase "
        f"took {took:.1f} s (limit {AMP16_LIMIT_S}; seconds by part "
        f"{laps}); card {smi_line}")
    check(spy.calls == 0, f"a plain version ran on the card {spy.calls} "
          f"times on the amp16 path")
    check(not any(lib.values()), f"a library lowering ran: {lib}")
    PATH_DTYPES["amp16"] = path
    check(took <= AMP16_LIMIT_S, f"phase amp16 took {took:.1f} s")
    return path


# ---------------------------------------------------------------------------
# phase 4d: GPT-2 small from NDArrays, the npx kernel ops, dispatch cost
# ---------------------------------------------------------------------------
ND_STEPS = 3
ND_RTOL = 1e-6             # NDArray door vs tensor path, where not bitwise
ND_TIMED_STEPS = 12        # eager door/tensor timing runs, A B B A
ND_PAD = 128               # the last row of each batch right-padded by this


def _mha_plain(q, k, v, heads, causal, valid):
    """Multi-head attention over (B, T, heads * D) tensors by the flash
    kernels' plain version (``attention_plain``), differentiable by torch;
    ``valid`` (B,) right-pads through segment ids as the op does."""
    import math

    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, T, E = q.shape
    D = E // heads

    def split(t):
        return t.reshape(B, T, heads, D).transpose(1, 2)

    q_seg = k_seg = None
    if valid is not None:
        k_seg = (torch.arange(T, device=q.device)[None] <
                 valid[:, None]).to(torch.int32)
        q_seg = torch.ones_like(k_seg)
    out, _ = ck.attention_plain(split(q), split(k), split(v),
                                1.0 / math.sqrt(D), causal, q_seg, k_seg)
    return out.transpose(1, 2).reshape(B, T, E)


def _oor_expect(table, idx, axis_rows):
    """The reference's out-of-range rule on the host: an index in [-n, 0)
    wraps, one outside [-n, n) gives NaN."""
    n = table.shape[0] if axis_rows else table.shape[1]
    out = []
    for r, i in enumerate(idx):
        j = i + n if -n <= i < 0 else i
        ok = 0 <= j < n
        if axis_rows:
            out.append(table[j] if ok else onp.full(table.shape[1], onp.nan))
        else:
            out.append(table[r, j] if ok else onp.nan)
    return onp.array(out, dtype="float32")


def phase_nd(smi_line, arrays, batches):
    """The NDArray layer on the card: (i) GPT-2 small trained 3 steps from
    NDArrays (``mx.np.array(..., ctx=mx.gpu())``, ``autograd.record``,
    ``loss.backward()``, ``trainer.step``) against 3 tensor-path steps from
    phase 4's weights and batches, the kernels' launches a step, and one
    AMP step each way; (ii) ``npx.multihead_attention`` (causal, and with a
    right-padding mask routed to segment ids, backward included),
    ``npx.layer_norm``, and ``npx.pick`` / ``npx.embedding`` out of range;
    (iii) host µs a dispatch of ``mx.np.add`` beside ``torch.add``, and the
    eager step's wall through the door against the tensor path, A B B A.
    Returns the launch counts of the NDArray steps."""
    import contextlib

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch import np as mxnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    B, T = TRAIN_SHAPE
    loss_fn = SoftmaxCrossEntropyLoss()
    valid = onp.full((B,), T, "int32")
    valid[-1] = T - ND_PAD

    def run(door, steps, dropout=0.0, amp_on=False, counted=False):
        """``steps`` eager AdamW steps of GPT-2 small from phase 4's weights
        on phase 4's batches: from NDArrays (``door``) or tensors. Returns
        the per-sample losses of each step, step 1's gradients, the
        launches of each step and each step's wall ms."""
        _release()
        model, _ = _train_model(arrays, dropout)
        trainer = make_trainer(model)
        losses, grads, per_step, ms = [], None, [], []
        if counted:
            ck.reset_launch_counts()
        scope = amp.autocast("bfloat16") if amp_on else \
            contextlib.nullcontext()
        for i, (x, y) in enumerate(batches[:steps]):
            before = ck.launch_counts()
            t0 = time.perf_counter()
            if door:
                xs, ys, vl = (mxnp.array(a, ctx=mx.gpu())
                              for a in (x, y, valid))
            else:
                xs, ys, vl = (torch.from_numpy(a).to(DEV)
                              for a in (x, y, valid))
            with scope:
                with autograd.record():
                    loss = loss_fn(model(xs, vl), ys)
                if door:
                    loss.backward()
                else:
                    autograd.backward(loss)
            if i == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in model.collect_params().items()}
            trainer.step(B)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = ck.launch_counts()
            per_step.append({n: after[n] - before[n] for n in after})
            lt = loss._data if door else loss
            losses.append(lt.detach().cpu())
        del model, trainer, loss
        _release()
        return losses, grads, per_step, ms

    # -- (i) GPT-2 small from NDArrays against the tensor path ---------------
    nd_losses, nd_grads, nd_steps, _ = run(True, ND_STEPS, counted=True)
    counts = read_counts("nd")
    t_losses, t_grads, t_steps, _ = run(False, ND_STEPS)
    check(all(bool(torch.isfinite(v).all()) for v in nd_losses),
          "an NDArray-path loss is not finite")
    loss_bitwise = all(torch.equal(a, b) for a, b in zip(nd_losses,
                                                         t_losses))
    grad_bitwise = all(torch.equal(nd_grads[n], t_grads[n])
                       for n in t_grads)
    worst, worst_name = 0.0, None
    for n, want in t_grads.items():
        rel = float((nd_grads[n] - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, n
    loss_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(nd_losses, t_losses))
    log(f"[nd] (i) gpt2_small B={B} T={T} (last row right-padded to "
        f"{T - ND_PAD}), fp32, dropout 0, AdamW: {ND_STEPS} steps from "
        f"NDArrays (mx.np.array(..., ctx=mx.gpu()), autograd.record, "
        f"loss.backward(), trainer.step) against {ND_STEPS} tensor-path "
        f"steps from the same weights and batches: mean losses "
        f"{[round(float(v.mean()), 6) for v in nd_losses]} vs "
        f"{[round(float(v.mean()), 6) for v in t_losses]}; losses "
        f"{'bitwise equal' if loss_bitwise else f'max rel diff {loss_rel:.3g}'}"
        f"; step-1 gradients of all {len(t_grads)} parameters "
        f"{'bitwise equal' if grad_bitwise else f'worst relative max |diff| {worst:.3g} ({worst_name})'}"
        f" (limit where not bitwise {ND_RTOL})")
    check(loss_bitwise or loss_rel <= ND_RTOL,
          f"NDArray-path losses differ from the tensor path: {loss_rel:.3g}")
    check(grad_bitwise or worst <= ND_RTOL,
          f"NDArray-path gradients differ: {worst:.3g} at {worst_name}")
    log(f"[nd] (i) kernel launches in the {ND_STEPS} NDArray steps: "
        f"{counts}; per step {nd_steps}; tensor-path steps {t_steps}")
    bad = [(i, ps) for i, ps in enumerate(nd_steps)
           if ps != TRAIN_WANT or ps != t_steps[i]]
    check(not bad, f"NDArray-path launches per step: {bad[:1]} != "
          f"{TRAIN_WANT} (tensor path {t_steps[:1]})")
    del nd_grads, t_grads
    amp_nd = run(True, 1, amp_on=True)[0][0]
    amp_t = run(False, 1, amp_on=True)[0][0]
    log(f"[nd] (i) one AMP (bf16) step: loss through the door "
        f"{float(amp_nd.float().mean()):.6f}, tensor path "
        f"{float(amp_t.float().mean()):.6f}, dtype {amp_nd.dtype}; bitwise "
        f"{torch.equal(amp_nd, amp_t)}")
    check(amp_nd.dtype == torch.bfloat16 and torch.equal(amp_nd, amp_t),
          "the AMP loss through the door differs from the tensor path's")

    # -- (ii) the npx kernel ops on NDArrays on the card ---------------------
    rs = onp.random.RandomState(SEED + 7)
    E, H = 768, 12
    q, k, v, g = (rs.standard_normal((B, T, E)).astype("float32")
                  for _ in range(4))
    for tag, vl in (("causal", None), ("causal + right-padding mask", valid)):
        ck.reset_launch_counts()
        nds = [mxnp.array(a, ctx=mx.gpu()) for a in (q, k, v)]
        for a in nds:
            a.attach_grad()
        mask = None if vl is None else mxnp.array(
            (onp.arange(T)[None] < vl[:, None]).reshape(B, 1, 1, T)
            .astype("float32"), ctx=mx.gpu())
        with autograd.record():
            out = npx.multihead_attention(*nds, mask, num_heads=H,
                                          causal=True)
        out.backward(mxnp.array(g, ctx=mx.gpu()))
        launched = ck.launch_counts()
        ts = [torch.from_numpy(a).to(DEV).requires_grad_() for a in
              (q, k, v)]
        ref = _mha_plain(*ts, H, True, None if vl is None else
                         torch.from_numpy(vl).to(DEV))
        ref.backward(torch.from_numpy(g).to(DEV))
        errs = [float((out._data - ref).abs().max())
                for out, ref in ((out, ref.detach()),)] + \
            [float((a.grad._data - t.grad).abs().max())
             for a, t in zip(nds, ts)]
        log(f"[nd] (ii) npx.multihead_attention ({B}, {T}, {E}), {H} heads,"
            f" {tag}, under record() with backward(): max |diff| vs the "
            f"plain version out {errs[0]:.3g}, dq {errs[1]:.3g}, dk "
            f"{errs[2]:.3g}, dv {errs[3]:.3g} (limit {FLASH_TOL}); launches "
            f"{launched}")
        check(max(errs) <= FLASH_TOL, f"npx.multihead_attention ({tag}) "
              f"differs from the plain version: {errs}")
        check(launched["flash_fwd"] == 1 and launched["flash_bwd_dkv"] == 1
              and launched["flash_bwd_dq"] == 1,
              f"npx.multihead_attention ({tag}) did not run the flash "
              f"kernels: {launched}")
        del nds, out, ts, ref
    x = rs.standard_normal((4096, E)).astype("float32")
    gam = (1 + 0.1 * rs.standard_normal(E)).astype("float32")
    bet = (0.1 * rs.standard_normal(E)).astype("float32")
    ck.reset_launch_counts()
    ln = npx.layer_norm(*(mxnp.array(a, ctx=mx.gpu()) for a in (x, gam, bet)))
    ln_launched = ck.launch_counts()["layer_norm"]
    want = ck.layer_norm_plain(*(torch.from_numpy(a).to(DEV)
                                 for a in (x, gam, bet)), 1e-5)
    ln_err = float((ln._data - want).abs().max())
    log(f"[nd] (ii) npx.layer_norm (4096, {E}): max |diff| vs the plain "
        f"version {ln_err:.3g} (limit {LN_TOL}); {ln_launched} launch")
    check(ln_err <= LN_TOL and ln_launched == 1,
          f"npx.layer_norm differs or did not launch: {ln_err}")
    n = 16
    idx = onp.array([-n - 1, -n, -1, n - 1, n], "int32")
    table = rs.standard_normal((n, 8)).astype("float32")
    rows = rs.standard_normal((5, n)).astype("float32")
    emb = npx.embedding(mxnp.array(idx, ctx=mx.gpu()),
                        mxnp.array(table, ctx=mx.gpu())).asnumpy()
    picked = npx.pick(mxnp.array(rows, ctx=mx.gpu()),
                      mxnp.array(idx, ctx=mx.gpu())).asnumpy()
    emb_ok = onp.array_equal(emb, _oor_expect(table, idx, True),
                             equal_nan=True)
    pick_ok = onp.array_equal(picked, _oor_expect(rows, idx, False),
                              equal_nan=True)
    after = (mxnp.ones((1024,), ctx=mx.gpu()) * 2).sum().item()
    torch.cuda.synchronize()
    log(f"[nd] (ii) indices {idx.tolist()} of {n}: npx.embedding rows NaN "
        f"{onp.isnan(emb).all(axis=1).tolist()}, npx.pick {picked.tolist()}"
        f"; as the reference's rule: embedding {emb_ok}, pick {pick_ok}; a "
        f"later CUDA op gives {after} (2048.0)")
    check(emb_ok and pick_ok and after == 2048.0,
          "out-of-range pick/embedding on the card differ from the "
          "reference's rule, or left the context unusable")

    # -- (iii) dispatch cost and the eager step's wall -----------------------
    a1, b1 = (mxnp.array([1.0], ctx=mx.gpu()) for _ in range(2))
    ta, tb = a1._data, b1._data

    def host_us(fn, blocks=100, per=100):
        samples = []
        for _ in range(blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(per):
                fn()
            samples.append((time.perf_counter_ns() - t0) / per / 1e3)
        torch.cuda.synchronize()
        return statistics.median(samples)

    disp = {}
    for tag, fn in (("mx.np.add", lambda: mxnp.add(a1, b1)),
                    ("torch.add", lambda: torch.add(ta, tb)),
                    ("torch.add ", lambda: torch.add(ta, tb)),
                    ("mx.np.add ", lambda: mxnp.add(a1, b1))):
        disp[tag] = host_us(fn)
    log(f"[nd] (iii) host µs a call on (1,) fp32 operands on the card "
        f"(median of 100 blocks of 100 calls, 10k calls each, A B B A): "
        f"mx.np.add (invoke) {disp['mx.np.add']:.2f}, "
        f"{disp['mx.np.add ']:.2f}; torch.add {disp['torch.add']:.2f}, "
        f"{disp['torch.add ']:.2f}; card {smi_line}")
    walls = {}
    for tag, door in (("A1", False), ("B1", True), ("B2", True),
                      ("A2", False)):
        ms = run(door, ND_TIMED_STEPS, dropout=0.1)[3]
        walls[tag] = statistics.median(ms[2:])
    log(f"[nd] (iii) eager step wall (B={B}, T={T}, fp32, dropout 0.1, "
        f"AdamW; median of steps 3-{ND_TIMED_STEPS}; host clock, "
        f"synchronised): tensor path (A) {walls['A1']:.2f}, "
        f"{walls['A2']:.2f} ms; NDArray door (B) {walls['B1']:.2f}, "
        f"{walls['B2']:.2f} ms (A B B A); card {smi_line}")
    log(f"[nd] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the tuning path (discover, tune, save, preload, serve)
# ---------------------------------------------------------------------------
def phase_tune(agree):
    import shutil
    import tempfile

    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch import tune
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxtpu_tune_smoke_")
    os.environ["MXTPU_TUNE"] = "1"
    os.environ["MXTPU_TUNE_CACHE"] = os.path.join(tmp, "tuning.json")

    def n(name):
        return int(tm.counter(name).value)

    try:
        tune.reset()
        ck.reset_launch_counts()
        model, _ = serve_model()
        # (1) discovery: warm the phase-3 engine with an empty cache
        eng = DecodeEngine(model, **SERVE_ARGS)
        eng.warmup()
        eng.close()
        del eng
        _release()
        worklist = tune.missed()
        fams = sorted({kern for kern, _ in worklist})
        log(f"[tune] discovery warmup: {len(worklist)} missed keys "
            f"({fams}), {n('tune.cache_misses')} misses, library calls "
            f"{ck.library_counts()}")
        check({"flash_fwd", "layer_norm"} <= set(fams),
              f"discovery missed no flash_fwd/layer_norm keys: {fams}")
        # (2) tune exactly those, plus the training-shaped ladder
        specs = [tune.spec_from_key(k) for _, k in worklist]
        specs += tune.ladder_specs((1, 4, 8), (128, 512, 1024), 12, 64, 768,
                                   families=("flash_bwd", "softmax"))
        t0 = time.perf_counter()
        results = tune.autotune(specs, trials=3, max_per_axis=2)
        tune_s = time.perf_counter() - t0
        check(os.path.exists(os.environ["MXTPU_TUNE_CACHE"]),
              "tune.save() wrote no cache file")
        for r in results:
            log(f"[tune] {r['key']}: winner {r['winner']} "
                f"{json.dumps(r['config'])}, default {r['default_us']:.2f} "
                f"us, best {r['best_us']:.2f} us, xla {r['xla_us']:.2f} us")
        gm = statistics.geometric_mean(
            [r["default_us"] / r["best_us"] for r in results])
        wins = {}
        for r in results:
            w = "xla" if r["winner"] == "xla" else (
                "default" if r["winner"] == "default" else "other tile")
            wins[w] = wins.get(w, 0) + 1
        log(f"[tune] {len(results)} specs in {tune_s:.1f} s, "
            f"{n('tune.measurements')} measurements; geometric mean of "
            f"default/best {gm:.4f}; winners {wins}")
        # (3) a fresh process's view: drop the in-process tier, preload
        tune.reset()
        eng = DecodeEngine(model, **SERVE_ARGS)
        m0, h0 = n("tune.cache_misses"), n("tune.cache_hits")
        lib0 = ck.library_counts()
        eng.warmup()
        m1, meas1 = n("tune.cache_misses"), n("tune.measurements")
        log(f"[tune] fresh engine warmup after preload: "
            f"{tune.status()['entries']} entries, {n('tune.cache_hits') - h0}"
            f" hits, {m1 - m0} misses")
        check(m1 == m0, f"{m1 - m0} cache misses after the preload")
        reqs, outs, serve_s, fam_ms = drive_engine(eng, model)
        eng.close()
        del eng
        _release()
        lib = {f: c - lib0[f] for f, c in ck.library_counts().items()}
        check(n("tune.measurements") == meas1,
              "the serving engine measured candidates online")
        check(n("tune.cache_misses") == m1, "cache misses while serving")
        n_tok = sum(len(o) for o in outs)
        med = {f: statistics.median(x) for f, x in fam_ms.items() if x}
        log(f"[tune] tuned engine: {len(reqs)} requests, {n_tok} tokens in "
            f"{serve_s:.3f} s ({n_tok / serve_s:.1f} tokens/s); median ms "
            f"{ {f: round(v, 3) for f, v in med.items()} }; library-lowering"
            f" calls in the warm calls and captures {lib}")
        for i, (got, (want, upto)) in enumerate(zip(outs, agree)):
            check(got[:upto] == want[:upto],
                  f"request {i}: tuned tokens differ from the untuned "
                  f"engine's before step {upto}: {got} vs {want}")
        log(f"[tune] tuned engine tokens == untuned engine tokens up to "
            f"each request's first near tie")
        counts = read_counts("tune")
        log(f"[tune] kernel launches on the path: {counts}; library calls "
            f"{ck.library_counts()}; tiles {ck.tile_counts()}")
        check(counts["softmax"] > 0, "the tune path launched no softmax")
        _tick_ab(model, agree)
        secs = time.perf_counter() - t_phase
        log(f"[tune] phase {secs:.1f} s")
        return counts, results
    finally:
        os.environ.pop("MXTPU_TUNE", None)
        os.environ.pop("MXTPU_TUNE_CACHE", None)
        tune.reset()
        shutil.rmtree(tmp, ignore_errors=True)


def _tick_ab(model, agree):
    """What moves the tuned engine's tick. The same 8 requests, each time
    through a fresh warmed engine, in the order A B C C B A within this
    process so that run order cannot stand in for a difference: A untuned;
    B tuned (the saved winners); C tuned, but every LayerNorm key pinned to
    its kernel at the default tile, which leaves the decode tick's one
    tuned choice (the LayerNorm at 8 rows) as untuned. Prints each run's
    decode-tick and prefill medians; checks only the tokens."""
    from mxnet_tpu_torch import tune
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    def serve(variant):
        tune.reset()
        if variant == "A":
            os.environ.pop("MXTPU_TUNE", None)
        else:
            os.environ["MXTPU_TUNE"] = "1"
            if variant == "C":
                tune.preload()
                for key in tune.entries():
                    if key.startswith("layer_norm|"):
                        tune.record("layer_norm", key,
                                    {"block_rows": ck.DEFAULT_BLOCK_ROWS})
        eng = DecodeEngine(model, **SERVE_ARGS)
        lib0 = ck.library_counts()["layer_norm"]
        eng.warmup()
        _, outs, serve_s, fam_ms = drive_engine(eng, model)
        eng.close()
        del eng
        _release()
        for i, (got, (want, upto)) in enumerate(zip(outs, agree)):
            check(got[:upto] == want[:upto],
                  f"[tune A/B] {variant}: request {i} differs from the "
                  f"untuned engine before step {upto}")
        tick = statistics.median(fam_ms["decode"])
        pre = statistics.median(fam_ms["prefill"])
        n_tok = sum(len(o) for o in outs)
        log(f"[tune A/B] {variant}: decode tick median {tick:.3f} ms "
            f"({len(fam_ms['decode'])} ticks), prefill median {pre:.3f} ms, "
            f"{n_tok / serve_s:.1f} tokens/s, F.layer_norm calls in the "
            f"warm calls and captures "
            f"{ck.library_counts()['layer_norm'] - lib0}")
        return tick

    ticks = {v: [] for v in "ABC"}
    try:
        for v in "ABCCBA":
            ticks[v].append(serve(v))
    finally:
        os.environ["MXTPU_TUNE"] = "1"
        tune.reset()
    log("[tune A/B] decode tick medians, ms: " + "; ".join(
        f"{v} {ticks[v][0]:.3f} / {ticks[v][1]:.3f}" for v in "ABC"))


# ---------------------------------------------------------------------------
# phase 6: runtime-compiled CUDA (rtc.CudaModule)
# ---------------------------------------------------------------------------
AXPY = r'''
extern "C" __global__ void axpy(const float* x, const float* y, float* out,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i] + y[i];
}
'''


def phase_rtc():
    """The JAX package's rtc test kernel (tests/test_contrib.py:150-159) as
    CUDA C, compiled at run time and launched at n = 4 and n = 2**24 on
    the path; held to torch's 2 * x + y."""
    import torch

    from mxnet_tpu_torch import rtc

    t0 = time.perf_counter()
    mod = rtc.CudaModule(AXPY)
    compile_s = time.perf_counter() - t0
    sig = "const float* x, const float* y, float* out, int n"
    dev = torch.device("cuda")
    rng = onp.random.RandomState(SEED + 3)
    inputs = {}
    for n in (4, 1 << 24):
        inputs[n] = tuple(torch.from_numpy(rng.randn(n).astype("float32"))
                          .to(dev) for _ in range(2))
    kernels = {n: mod.get_kernel("axpy", sig, out_shapes=[(n,)])
               for n in inputs}
    rtc.reset_launch_count()
    outs = {n: kernels[n].launch([x, y, n]) for n, (x, y) in inputs.items()}
    torch.cuda.synchronize()
    launches = rtc.launch_count()
    err = 0.0
    for n, (x, y) in inputs.items():
        want = 2 * x + y
        rel = float(((outs[n] - want).abs()
                     / want.abs().clamp_min(1e-30)).max())
        check(rel <= RTC_RTOL, f"rtc axpy n={n}: relative |diff| {rel:.3g}")
        err = max(err, float((outs[n] - want).abs().max()))
    n = 1 << 24
    x, y = inputs[n]
    ms = time_ms(lambda: kernels[n].launch([x, y, n]))
    dev_ms = device_ms(lambda: kernels[n].launch([x, y, n]), "axpy")
    plain_ms = time_ms(lambda: 2 * x + y)
    lib_ms = time_ms(lambda: torch.add(y, x, alpha=2))
    bms, by = bound_ms(12 * n, 2 * n)
    log(f"[rtc] axpy compiled in {compile_s:.2f} s; launches on the path "
        f"{launches}; n=2^24: max|diff| {err:.3g}; kernel {ms:.4f} ms "
        f"(device {dev_ms}), plain 2 * x + y {plain_ms:.4f} ms, "
        f"torch.add(alpha=2) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    check(launches == 2, f"rtc launches on the path {launches} != 2")
    return {"name": "rtc_axpy", "route": "cuda",
            "source": "mxnet_tpu_torch/rtc.py",
            "replaces": "mxnet_tpu/rtc.py:35",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "device_ms": dev_ms, "launches": launches,
            "shape": "x, y (2^24,) fp32, axpy compiled by rtc.CudaModule"}

# ---------------------------------------------------------------------------
# phase 7: ResNet-50 v1 (convolution, pooling and BatchNorm; no port kernel)
# ---------------------------------------------------------------------------
RESNET_CLASSES = 1000
RESNET_IMAGE = (3, 224, 224)
RESNET_CHECK_BATCH = 8      # (i) the card against the CPU, fp32
RESNET_BATCH = 128          # bench.py's bench_resnet_infer / _train
RESNET_LR = 0.1             # bench.py's SGD(learning_rate=0.1, momentum=0.9)
RESNET_MOMENTUM = 0.9
RESNET_FP32_RTOL = 1e-3     # card vs CPU: logits, loss and statistics,
#                             each over its own largest entry
RESNET_GRAD_RTOL = 5e-2     # card vs CPU: gradients over the net's largest
#                             gradient, updates over lr times it over B. A
#                             conv before BatchNorm in training gets a
#                             gradient orthogonal to its weight, a sum whose
#                             terms cancel: fp32 runs on two devices differ
#                             by 2.6e-2 at the stem (PERF.md §6,
#                             tools/port_resnet_grads.py)
RESNET_BF16_RTOL = 5e-2     # bf16 predict vs fp32 predict, largest logit
RESNET_COMPILED_RTOL = 2e-2  # compiled vs eager AMP steps, largest entry
RESNET_STEPS = 20
RESNET_TASK = dict(classes=10, batches=4)   # the cyclic set of batches
RESNET_LOSS_SHARE = 0.7     # the last cycle's mean loss below this share of
#                             the first loss (SGD at 0.1 without warm-up
#                             first overshoots, then falls)
RESNET50_FWD_FLOPS = 4.089e9  # bench.py:37, 2 FLOPs a MAC, 224 x 224
RESNET_TRAIN_FLOPS = 3 * RESNET50_FWD_FLOPS   # bench.py:38
_RESNET_KINDS = (("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "sm90_",
                                          "sm80_", "cutlass", "gemm",
                                          "nvjet", "implicit")),
                 ("casts and copies", ("copy", "convert")),
                 ("reductions (BatchNorm's means)", ("reduce",)),
                 ("pooling", ("pool",)),
                 ("softmax and loss", ("softmax", "nll", "gather")))


def resnet_model():
    """ResNet-50 v1 at its published width (the reference's
    ``resnet50_v1(classes=1000)``, nothing cut), on the current context."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    return vision.resnet50_v1(classes=RESNET_CLASSES)


def resnet_weights(seed):
    """ResNet-50 v1's parameters from ``default_rng(seed)``: He-normal
    convolutions, N(0, 1/fan_in) for the output layer, gammas 1 + N(0,
    0.1^2), betas and running means N(0, 0.1^2), running variances in
    [1, 1.2], zero biases. The shapes come from the port's own net after a
    forward of one small image on the CPU."""
    import torch

    from mxnet_tpu_torch import cpu

    with cpu():
        net = resnet_model()
        with torch.no_grad():
            net(torch.zeros((1, RESNET_IMAGE[0], 32, 32)))
        shapes = {n: tuple(p.shape) for n, p in
                  net.collect_params().items()}
    rs = onp.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("running_var"):
            a = 1 + 0.2 * rs.random(shape, dtype="float32")
        elif name.endswith("gamma"):
            a = 1 + 0.1 * rs.standard_normal(shape, dtype="float32")
        elif name.endswith(("beta", "running_mean")):
            a = 0.1 * rs.standard_normal(shape, dtype="float32")
        elif name.endswith("bias"):
            a = onp.zeros(shape, "float32")
        else:
            fan_in = int(onp.prod(shape[1:]))
            gain = 1.0 if name.startswith("output") else 2.0
            a = rs.standard_normal(shape, dtype="float32") * \
                onp.float32(onp.sqrt(gain / fan_in))
        out[name] = a
    return out


def _resnet_net(arrays):
    net = resnet_model()
    net.load_dict(arrays)
    return net


def _resnet_task(seed, dtype):
    """RESNET_TASK's cyclic set of batches on the card: each image is its
    label's template plus noise, the labels drawn from 10 of the 1000
    classes, so the loss can fall within a few steps."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    k = RESNET_TASK["classes"]
    templates = torch.randn((k, *RESNET_IMAGE), generator=gen, device=DEV)
    out = []
    for _ in range(RESNET_TASK["batches"]):
        y = torch.randint(0, k, (RESNET_BATCH,), generator=gen, device=DEV)
        x = templates[y] + 0.5 * torch.randn(
            (RESNET_BATCH, *RESNET_IMAGE), generator=gen, device=DEV)
        out.append((x.to(dtype), y.float()))
    return out


def _max_rel(got, want, scale=None):
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    scale = float(want.abs().max()) if scale is None else scale
    return float((got - want).abs().max()) / max(scale, 1e-30)


def _profile(fn, reps=5):
    """(device-busy ms a call, launches a call, {kernel: device us total})
    over ``reps`` calls, from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    busy = sum(by_name.values()) / reps / 1e3
    return busy, len(kernels) / reps, by_name


def _wall_ms(fn, reps):
    """Median host-clock ms of ``fn`` followed by a synchronise."""
    import torch

    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


def _log_by_kind(tag, by_name, reps, smi_line):
    kinds = {}
    for name, us in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in _RESNET_KINDS
                     if any(w in low for w in keys)),
                    "other elementwise (BatchNorm, ReLU, adds, update)")
        kinds[kind] = kinds.get(kind, 0.0) + us
    total = sum(kinds.values()) or 1.0
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"[resnet] {tag} by kind: {kind:48s} {us / reps / 1e3:8.3f} ms "
            f"({100 * us / total:5.1f} %); card {smi_line}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[resnet] {tag} top: {us / reps / 1e3:8.3f} ms  {name[:100]}")


def phase_resnet(smi_line):
    """ResNet-50 v1 at full width through the port's registry, layers and
    compiled step: (i) one fp32 training step at batch 8 on the card
    against the CPU; (iii) bench.py's training, AMP bf16 at batch 128 with
    SGD(0.1, momentum 0.9): three compiled steps against three eager ones,
    then 20 compiled steps on a cyclic task; (ii) bench.py's inference on
    the trained weights, ``cast("bfloat16")`` at batch 128, against the
    fp32 predict. No port kernel runs: the five kernels' counters stay at
    0. Returns the phase's launch counts."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon, optimizer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    ck.reset_launch_counts()
    log(f"[resnet] kernel counters before: {ck.launch_counts()}")
    loss_fn = SoftmaxCrossEntropyLoss()
    arrays = resnet_weights(SEED + 7)
    log(f"[resnet] ResNet-50 v1: {len(arrays)} parameters, "
        f"{sum(a.size for a in arrays.values()) / 1e6:.2f} M values; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- (i) one fp32 training step, the card against the CPU ---------------
    rng = onp.random.default_rng(SEED + 8)
    x8 = rng.standard_normal((RESNET_CHECK_BATCH, *RESNET_IMAGE),
                             dtype="float32")
    y8 = rng.integers(0, RESNET_CLASSES, RESNET_CHECK_BATCH).astype(
        "float32")
    runs = []
    for ctx in (mx.cpu(), mx.gpu()):
        with ctx:
            net = _resnet_net(arrays)
            dev = net.device
            trainer = gluon.Trainer(net.collect_params(), optimizer.SGD(
                learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM))
            with autograd.record():
                logits = net(torch.from_numpy(x8).to(dev))
                loss = loss_fn(logits, torch.from_numpy(y8).to(dev))
            autograd.backward(loss)
            params = net.collect_params()
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in params.items() if p.grad_req != "null"}
            trainer.step(RESNET_CHECK_BATCH)
            after = {n: p.detach().cpu().clone() for n, p in params.items()}
            runs.append((logits.detach().cpu(), loss.detach().cpu(), grads,
                         after))
            del net, trainer, logits, loss
    (lc, sc, gc_, wc), (lg, sg, gg, wg) = runs
    _release()
    top = max(float(g.abs().max()) for g in gc_.values())
    errs = {"logits": _max_rel(lg, lc), "loss": _max_rel(sg, sc)}
    own = {}
    for n, g in gc_.items():
        errs["grad " + n] = _max_rel(gg[n], g, top)
        own[n] = _max_rel(gg[n], g)
    for n, w in wc.items():
        if n.endswith(("running_mean", "running_var")):
            errs["stat " + n] = _max_rel(wg[n], w)
        else:   # the first update, -lr g / B, on the gradients' scale
            errs["update " + n] = _max_rel(wg[n] - torch.from_numpy(
                arrays[n]), w - torch.from_numpy(arrays[n]),
                RESNET_LR * top / RESNET_CHECK_BATCH)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    worst_own = sorted(own.items(), key=lambda kv: -kv[1])[:3]
    log(f"[resnet] (i) fp32 step at batch {RESNET_CHECK_BATCH}, card vs "
        f"CPU (TF32 off), max |diff| over the largest entry (gradients and "
        f"updates: the net's largest gradient, times lr): logits "
        f"{errs['logits']:.2e}, loss {errs['loss']:.2e}; the five largest: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst)
        + "; gradients over their own largest entry, the three largest: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst_own)
        + f"; card {smi_line}")
    for k, v in errs.items():
        limit = RESNET_GRAD_RTOL if k.startswith(("grad ", "update ")) \
            else RESNET_FP32_RTOL
        check(v <= limit, f"resnet (i): {k} {v:.2e} > {limit}")
    del runs, gc_, gg, wc, wg, own

    # -- (iii) bench.py's training: AMP, batch 128, SGD(0.1, 0.9) ------------
    batches = _resnet_task(SEED + 9, torch.bfloat16)

    def trainer_of(net):
        return gluon.Trainer(net.collect_params(), optimizer.SGD(
            learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM))

    amp.init("bfloat16")
    try:
        eager = _resnet_net(arrays)
        tr_e = trainer_of(eager)
        eager_losses = []
        for x, y in batches[:3]:
            with autograd.record():
                loss = loss_fn(eager(x), y).mean()
            autograd.backward(loss)
            tr_e.step(1)
            eager_losses.append(float(loss.detach()))
        eager_after = {n: p.detach().clone()
                       for n, p in eager.collect_params().items()}
        eager_mom = [None if s is None else s["mom"].clone()
                     for s in tr_e._states]
        del eager, tr_e, loss
        _release()
        torch.cuda.reset_peak_memory_stats()
        net = _resnet_net(arrays)
        trainer = trainer_of(net)
        step = trainer.compile_step(net, loss_fn)
        losses, reserved = [], []
        for i in range(RESNET_STEPS):
            x, y = batches[i % len(batches)]
            losses.append(float(step(x, y)))
            reserved.append(torch.cuda.memory_reserved())
            if i == 2:
                params = net.collect_params()
                errs = {n: _max_rel(params[n], w)
                        for n, w in eager_after.items()}
                errs.update({f"mom {i}": _max_rel(s["mom"], m) for i, (s, m)
                             in enumerate(zip(trainer._states, eager_mom))
                             if m is not None})
                loss_err = max(abs(a - b) / abs(b) for a, b in
                               zip(losses, eager_losses))
                worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
                log(f"[resnet] (iii) 3 compiled vs 3 eager AMP steps "
                    f"(batch {RESNET_BATCH}, bf16 images, SGD "
                    f"{RESNET_LR}/{RESNET_MOMENTUM}): losses "
                    f"{[round(v, 5) for v in losses]} vs "
                    f"{[round(v, 5) for v in eager_losses]} (rel "
                    f"{loss_err:.2e}); weights, statistics and momenta "
                    f"max |diff| / largest, the three largest: "
                    + ", ".join(f"{k} {v:.2e}" for k, v in worst))
                check(loss_err <= RESNET_COMPILED_RTOL and
                      worst[0][1] <= RESNET_COMPILED_RTOL,
                      f"resnet (iii): compiled vs eager beyond "
                      f"{RESNET_COMPILED_RTOL}")
                del eager_after, eager_mom
        peak = torch.cuda.max_memory_allocated()
        log(f"[resnet] (iii) {RESNET_STEPS} compiled AMP steps on "
            f"{len(batches)} cyclic batches: loss "
            + " ".join(f"{v:.4f}" for v in losses)
            + f"; captures {step._traces}; reserved bytes from step 2 on "
            f"{sorted(set(reserved[1:]))}; peak "
            f"{peak / 2**20:.0f} MiB; card {smi_line}")
        check(step._traces == 1, "resnet (iii): more than one capture")
        check(len(set(reserved[1:])) == 1,
              "resnet (iii): memory reserved after the capture")
        last = statistics.mean(losses[-len(batches):])
        log(f"[resnet] (iii) the last cycle's mean loss {last:.4f} against "
            f"{RESNET_LOSS_SHARE} x the first, {losses[0]:.4f}")
        check(all(math.isfinite(v) for v in losses) and
              last < RESNET_LOSS_SHARE * losses[0],
              f"resnet (iii): mean loss {last:.4f} of the last cycle not "
              f"below {RESNET_LOSS_SHARE} x {losses[0]:.4f}")
        x, y = batches[0]
        wall = _wall_ms(lambda: step(x, y), 10)
        busy, launches, by_name = _profile(lambda: step(x, y))
        img_s = RESNET_BATCH / wall * 1e3
        mfu = img_s * RESNET_TRAIN_FLOPS / PEAK_BF16_FLOPS
        log(f"[resnet] (iii) compiled AMP step: wall {wall:.2f} ms "
            f"(median of 10), device busy {busy:.2f} ms, idle share "
            f"{max(0.0, 1 - busy / wall):.3f}, {launches:.0f} kernels a "
            f"replay; {img_s:.1f} img/s; MFU {mfu:.3f} (bench.py's "
            f"{RESNET_TRAIN_FLOPS:.4g} FLOP an image over the dense bf16 "
            f"peak {PEAK_BF16_FLOPS:.3g}); peak {peak / 2**20:.0f} MiB; "
            f"card {smi_line}")
        _log_by_kind("(iii) compiled step", by_name, 5, smi_line)
        # where the eager AMP step's time goes, by part
        tr_p = trainer
        parts = {}

        def forward_backward():
            with autograd.record():
                loss = loss_fn(net(x), y).mean()
            autograd.backward(loss)

        parts["forward+backward"] = _profile(forward_backward, 3)[0]
        parts["optimizer (fused SGD)"] = _profile(lambda: tr_p.step(1), 3)[0]
        log("[resnet] (iii) eager AMP step, device busy ms by part: "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
            + f"; card {smi_line}")
        del step, trainer, tr_p
    finally:
        amp.disable()
    _release()

    # -- (ii) bench.py's inference: cast("bfloat16"), predict, batch 128 ----
    xi = batches[0][0].float()
    with torch.no_grad():
        ref32 = net(xi)
        net.cast("bfloat16")
        xb = xi.to(torch.bfloat16)
        got = net(xb)
    err = _max_rel(got, ref32)
    log(f"[resnet] (ii) bf16 predict vs fp32 predict at batch "
        f"{RESNET_BATCH}: max |diff| / largest logit {err:.2e} (limit "
        f"{RESNET_BF16_RTOL}); dtype {got.dtype}")
    check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
          and err <= RESNET_BF16_RTOL, f"resnet (ii): bf16 predict {err:.2e}")

    def infer():
        with torch.no_grad():
            return net(xb)

    wall = _wall_ms(infer, 10)
    busy, launches, by_name = _profile(infer)
    log(f"[resnet] (ii) bf16 inference, batch {RESNET_BATCH}: wall "
        f"{wall:.2f} ms a batch (median of 10), {RESNET_BATCH / wall * 1e3:.1f}"
        f" img/s, device busy {busy:.2f} ms, idle share "
        f"{max(0.0, 1 - busy / wall):.3f}, {launches:.0f} kernels; MFU "
        f"{RESNET_BATCH / wall * 1e3 * RESNET50_FWD_FLOPS / PEAK_BF16_FLOPS:.3f}"
        f"; card {smi_line}")
    _log_by_kind("(ii) inference", by_name, 5, smi_line)
    del net, batches, ref32, got
    _release()
    counts = read_counts("resnet")
    log(f"[resnet] kernel counters after: {counts}")
    check(not any(counts.values()),
          f"resnet: a port kernel launched on the ResNet path: {counts}")
    log(f"[resnet] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts



# ---------------------------------------------------------------------------
# phase 8: the Predictor serving hybridized ResNet-50 v1 and BERT-Base
# ---------------------------------------------------------------------------
PRED_RESNET_BATCH = 64        # ResNet's max_batch: the ladder 1, 2, ..., 64
PRED_RESNET_REQUESTS = 256    # single-image submits ...
PRED_THREADS = 16             # ... from this many client threads
PRED_PREDICTS = (1, 3, 64, 100)
PRED_BERT_BATCH = 32          # BERT's max_batch: the ladder 1, 2, ..., 32
PRED_BERT_T = 128             # tokens an item (bench.py's bert_pretrain T)
PRED_BERT_REQUESTS = 128
PRED_BERT_VALID = (16, 128)   # valid lengths drawn from this range
PRED_BERT_PADDED = 5           # a predict of 5 rows: bucket 8, 3 rows of padding
PRED_BERT_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}
#   a row served in a mixed batch against the same row predicted alone, over
#   each output's largest entry: another bucket runs GEMMs of another M,
#   which may sum in another order (fp32: FLASH_TOL's bound); in bf16 each
#   of 12 layers rounds its activations to 8 bits after such sums (bf16's
#   step 3.9e-3, carried through the layers)
PRED_BERT_EAGER_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
#   a served batch against the eager forward of the same padded batch:
#   bitwise expected; the limit is that of a GEMM summed in another order
#   (fp32: the tests' 1e-5; bf16: below PRED_BERT_RTOL, the same M)
PRED_TIMED = (1, 8)           # buckets timed, with the top one
BERT_WANT = {"flash_fwd": 12, "layer_norm": 25}  # launches a captured forward


def _logged_batches(pred):
    """Record the requests of every batch ``pred``'s dispatcher runs, in
    order, and the host seconds each dispatch took (padding the items into
    a pinned batch, queueing the program's run and the copy out), by
    wrapping its ``_dispatch``; returns the two lists it fills."""
    batches, seconds = [], []
    dispatch = pred._dispatch

    def logged(batch):
        batches.append(list(batch))
        t0 = time.perf_counter()
        try:
            return dispatch(batch)
        finally:
            seconds.append(time.perf_counter() - t0)

    pred._dispatch = logged
    return batches, seconds


def _submit_from_threads(pred, items, threads):
    """Submit ``items`` (one tuple of inputs each) from ``threads`` client
    threads started together; returns (futures in item order, wall s until
    every result is in)."""
    import threading

    futs = [None] * len(items)
    barrier = threading.Barrier(threads + 1, timeout=120)

    def client(c):
        barrier.wait()
        for i in range(c, len(items), threads):
            futs[i] = pred.submit(items[i])
        for i in range(c, len(items), threads):
            futs[i].result(timeout=300)

    workers = [threading.Thread(target=client, args=(c,))
               for c in range(threads)]
    for w in workers:
        w.start()
    barrier.wait()
    t0 = time.perf_counter()
    for w in workers:
        w.join(timeout=600)
        check(not w.is_alive(), "predictor: a client thread hung")
    return futs, time.perf_counter() - t0


def _bucket_timings(tag, buckets, pred, block, inputs_of, smi_line):
    """At ``buckets``: one program run
    (inputs in, replay, outputs cloned) against the eager block's forward on
    the same batch: wall ms (median of 10), device-busy ms, launches and
    the idle share. ``inputs_of(b)`` gives the bucket's batch on the card."""
    import torch

    from mxnet_tpu_torch import cached_op

    out = {}
    for b in buckets:
        xs = inputs_of(b)
        prog = pred._programs[b]

        def eager():
            with torch.no_grad(), cached_op.inlined():
                block(*xs)

        row = {}
        for kind, fn in (("replay", lambda: prog(*xs)), ("eager", eager)):
            wall = _wall_ms(fn, 10)
            busy, launches, _ = _profile(fn)
            row[kind] = (wall, busy, launches, max(0.0, 1 - busy / wall))
        out[b] = row
        (rw, rb, rl, ri), (ew, eb, el, ei) = row["replay"], row["eager"]
        log(f"[predictor] {tag} bucket {b}: replay wall {rw:.3f} ms, device "
            f"busy {rb:.3f} ms, {rl:.0f} kernels, idle share {ri:.3f}; "
            f"eager block wall {ew:.3f} ms, busy {eb:.3f} ms, {el:.0f} "
            f"kernels, idle share {ei:.3f}; card {smi_line}")
    return out


def _pred_serving_line(tag, pred, warm_s, smi_line):
    """Log the warmup's numbers; returns ``pred.stats()``."""
    import torch

    st = pred.stats()
    log(f"[predictor] {tag}: construction (the trace) and warmup "
        f"{warm_s:.2f} s, captures "
        f"{st['captures']}, programs {st['programs']}, graph pool "
        f"{st['pool_bytes'] / 2**20:.1f} MiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB; card {smi_line}")
    return st


def _pred_resnet(smi_line, taken):
    """(i) ResNet-50 v1 in bf16, hybridized, behind a Predictor with the
    ladder 1 ... 64: warmup captures 7, 256 submits from 16 threads and
    predicts of 1, 3, 64 and 100 rows, every served row bitwise equal to the
    eager block's forward of its padded bucket batch; then bench.py's
    bench_resnet_infer body through the port's cached_op.trace."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve import pick_bucket

    net = _resnet_net(resnet_weights(SEED + 7))
    net.cast("bfloat16")
    net.hybridize()
    example = torch.zeros((2, *RESNET_IMAGE), dtype=torch.bfloat16,
                          device=DEV)
    t0 = time.perf_counter()
    pred = net.predictor(example=example, max_batch=PRED_RESNET_BATCH)
    try:
        check(pred.buckets == [1, 2, 4, 8, 16, 32, 64],
              f"predictor resnet: ladder {pred.buckets}")
        pred.warmup()
        warm_s = time.perf_counter() - t0
        st = _pred_serving_line("resnet", pred, warm_s, smi_line)
        check(st["captures"] == 7, f"predictor resnet: {st['captures']} "
              "captures at warmup, not 7")
        gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
        images = torch.randn((PRED_RESNET_REQUESTS, *RESNET_IMAGE),
                             generator=gen, device=DEV).to(torch.bfloat16)
        host = images.cpu()
        batches, seconds = _logged_batches(pred)
        futs, wall = _submit_from_threads(
            pred, [host[i] for i in range(len(host))], PRED_THREADS)
        st = pred.stats()
        img_s = PRED_RESNET_REQUESTS / wall
        log(f"[predictor] resnet: {PRED_RESNET_REQUESTS} submits from "
            f"{PRED_THREADS} threads in {wall:.3f} s: {img_s:.1f} img/s "
            f"served, {st['batches']} batches (mean occupancy "
            f"{st['mean_occupancy']:.3f}), request p50 "
            f"{st['latency_ms_p50']:.2f} ms, p99 {st['latency_ms_p99']:.2f}"
            f" ms; the dispatcher's host ms a batch "
            f"{[round(1e3 * t, 2) for t in seconds]}; card {smi_line}")
        # every served row against the eager forward of its padded batch
        index = {id(f): i for i, f in enumerate(futs)}
        worst = 0.0
        for batch in batches:
            rows = [index[id(req.future)] for req in batch]
            bucket = pick_bucket(len(rows), pred.buckets)
            x = torch.zeros((bucket, *RESNET_IMAGE), dtype=torch.bfloat16,
                            device=DEV)
            x[:len(rows)] = images[rows]
            with torch.no_grad(), cached_op.inlined():
                want = net(x)[:len(rows)].float().cpu()
            got = torch.stack([torch.from_numpy(onp.asarray(
                futs[i].result(), dtype="float32")) for i in rows])
            worst = max(worst, float((got - want).abs().max()))
        log(f"[predictor] resnet: {len(batches)} served batches against the"
            f" eager block's forward of the same padded bucket batch: max "
            f"|diff| {worst:.3g} (bitwise expected)")
        check(worst == 0.0, f"predictor resnet: served rows differ from "
              f"the eager forward by {worst:.3g}")
        for n in PRED_PREDICTS:
            x = images[:n]
            got = pred.predict(x)._data
            parts = []
            for off in range(0, n, PRED_RESNET_BATCH):
                chunk = x[off:off + PRED_RESNET_BATCH]
                bucket = pick_bucket(len(chunk), pred.buckets)
                pad = torch.zeros((bucket, *RESNET_IMAGE),
                                  dtype=torch.bfloat16, device=DEV)
                pad[:len(chunk)] = chunk
                with torch.no_grad(), cached_op.inlined():
                    parts.append(net(pad)[:len(chunk)])
            want = torch.cat(parts)
            check(got.shape == (n, RESNET_CLASSES) and
                  torch.equal(got, want),
                  f"predictor resnet: predict({n}) differs from the eager "
                  f"forward of its buckets")
        log(f"[predictor] resnet: predict of {PRED_PREDICTS} rows bitwise "
            f"equal to the eager forward of their padded buckets")
        st = pred.stats()
        check(st["captures"] == 7, "predictor resnet: a capture after "
              "warmup")
        _take_counts(taken)
        timings = _bucket_timings(
            "resnet", PRED_TIMED + (PRED_RESNET_BATCH,), pred, net,
            lambda b: (images[:b],), smi_line)
        ck.reset_launch_counts()
    finally:
        pred.close()
    del pred, batches, futs
    _release()

    # bench.py's bench_resnet_infer body, its imports the port's; the port's
    # Parameter is the tensor, so the list holds p where bench.py reads
    # p.data() of the parameters whose p._data is set
    from mxnet_tpu_torch.cached_op import trace
    from mxnet_tpu_torch.gluon.model_zoo import vision

    BATCH, WARMUP, ITERS = 128, 3, 10
    bnet = vision.resnet50_v1()
    bnet.initialize()
    bnet.cast("bfloat16")
    x = mx.np.zeros((BATCH, 3, 224, 224), dtype="bfloat16")
    params = [(name, p) for name, p in bnet.collect_params().items()]
    _, _, cop = trace(lambda a: bnet(a), [x], params)
    arrs = [x] + [arr for _, arr in params]
    for _ in range(WARMUP):
        cop(*arrs)._data
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = cop(*arrs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img_s = BATCH * ITERS / dt
    _take_counts(taken)
    with torch.no_grad(), cached_op.inlined():
        want = bnet(x._data)
    ck.reset_launch_counts()
    check(cop._captures == 1 and out.shape == (BATCH, 1000) and
          torch.equal(out._data, want),
          "predictor: bench_resnet_infer's trace differs from the eager "
          "forward")
    log(f"[predictor] bench.py bench_resnet_infer through the port's "
        f"cached_op.trace: batch {BATCH}, {ITERS} calls in {dt:.4f} s: "
        f"{img_s:.1f} img/s, MFU "
        f"{img_s * RESNET50_FWD_FLOPS / PEAK_BF16_FLOPS:.3f}; one capture; "
        f"output bitwise equal to the eager forward; card {smi_line}")
    _take_counts(taken)
    del bnet, cop, arrs, out, want, x
    _release()
    return timings


def _take_counts(taken):
    """Add the launches since the last reset, by (kernel, operand dtypes),
    to ``taken`` and reset the counters: the predictor path's launches are
    taken before each eager comparison, whose launches are not the path's."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    for key, n in ck.dtype_counts().items():
        taken[key] = taken.get(key, 0) + n
    ck.reset_launch_counts()


def _pred_bert(smi_line, taken):
    """(ii) BERT-Base behind a Predictor with items of 128 int32 tokens,
    128 int32 token types and a float32 valid length, max_batch 32: fp32,
    then after cast("bfloat16"). 128 requests of valid lengths 16-128 from
    16 threads; every row against the same row predicted alone; the flash
    forward and LayerNorm launches of each capture."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve import pick_bucket

    bert = bert_base()
    bert.load_dict(numpy_weights(
        {n: tuple(p.shape) for n, p in bert.collect_params().items()},
        SEED + 11))
    bert.hybridize()
    n_params = sum(p.numel() for p in bert.parameters())
    rs = onp.random.default_rng(SEED + 12)
    tok = rs.integers(0, 30522, (PRED_BERT_REQUESTS, PRED_BERT_T),
                      dtype="int32")
    tt = rs.integers(0, 2, (PRED_BERT_REQUESTS, PRED_BERT_T), dtype="int32")
    vl = rs.integers(PRED_BERT_VALID[0], PRED_BERT_VALID[1] + 1,
                     PRED_BERT_REQUESTS).astype("float32")
    items = [(tok[i], tt[i], vl[i]) for i in range(PRED_BERT_REQUESTS)]
    example = (torch.zeros((2, PRED_BERT_T), dtype=torch.int32),
               torch.zeros((2, PRED_BERT_T), dtype=torch.int32),
               torch.zeros(2))
    log(f"[predictor] BERT-Base: {len(list(bert.parameters()))} parameters, "
        f"{n_params / 1e6:.2f} M values; dropout 0.1 (inert in predict mode)")
    timings = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            bert.cast("bfloat16")
        before = ck.launch_counts()
        t0 = time.perf_counter()
        pred = bert.predictor(example=example, max_batch=PRED_BERT_BATCH)
        try:
            pred.warmup()
            warm_s = time.perf_counter() - t0
            st = _pred_serving_line(f"bert {dtype}", pred, warm_s, smi_line)
            check(st["captures"] == len(pred.buckets) == 6,
                  f"predictor bert {dtype}: {st['captures']} captures")
            stats = pred._cop.graph_stats()
            for g in stats:
                cap = g["captured_launches"] or {}
                check(all(cap.get(k) == v for k, v in BERT_WANT.items()),
                      f"predictor bert {dtype}: a capture launched {cap}, "
                      f"want {BERT_WANT}")
            at_warm = ck.launch_counts()
            replays0 = [g["replays"] for g in stats]
            batches, seconds = _logged_batches(pred)
            futs, wall = _submit_from_threads(pred, items, PRED_THREADS)
            st = pred.stats()
            check(ck.launch_counts() == at_warm,
                  f"predictor bert {dtype}: a kernel counter moved while "
                  "serving")
            check(st["captures"] == 6,
                  f"predictor bert {dtype}: a capture after warmup")
            served = {k: sum((g["replays"] - r0) *
                             (g["captured_launches"] or {}).get(k, 0)
                             for g, r0 in zip(pred._cop.graph_stats(),
                                              replays0))
                      for k in BERT_WANT}
            check(all(served.values()),
                  f"predictor bert {dtype}: no kernel launched while "
                  f"serving: {served}")
            tokens = PRED_BERT_REQUESTS * PRED_BERT_T
            log(f"[predictor] bert {dtype}: {PRED_BERT_REQUESTS} requests "
                f"from {PRED_THREADS} threads in {wall:.3f} s: "
                f"{tokens / wall:.1f} tokens/s served ("
                f"{float(vl.sum()) / wall:.1f} valid tokens/s), "
                f"{st['batches']} batches (mean occupancy "
                f"{st['mean_occupancy']:.3f}), request p50 "
                f"{st['latency_ms_p50']:.2f} ms, p99 "
                f"{st['latency_ms_p99']:.2f} ms; the dispatcher's host ms a "
                f"batch {[round(1e3 * t, 2) for t in seconds]}; launches at "
                f"warmup "
                f"{ {k: at_warm[k] - before[k] for k in BERT_WANT} }, while"
                f" serving (replays x captured) {served}; card {smi_line}")
            # every row against the same row predicted alone: the rows that
            # the batcher served beside others, and a predict of
            # PRED_BERT_PADDED rows, whose bucket holds padding for certain
            index = {id(f): i for i, f in enumerate(futs)}
            mixed = [index[id(r.future)] for b in batches for r in b
                     if len(b) > 1]
            n_pad = PRED_BERT_PADDED
            padded = pred.predict((tok[:n_pad], tt[:n_pad], vl[:n_pad]))
            worst = {"seq": 0.0, "pooled": 0.0}
            for i in range(PRED_BERT_REQUESTS):
                alone = pred.predict((tok[i:i + 1], tt[i:i + 1],
                                      vl[i:i + 1]))
                served = [futs[i].result()]
                if i < n_pad:
                    served.append([o.asnumpy()[i] for o in padded])
                for outs in served:
                    for name, got, want in zip(("seq", "pooled"), outs,
                                               alone):
                        got = onp.asarray(got, dtype="float64")
                        want = want.asnumpy()[0].astype("float64")
                        check(onp.isfinite(got).all(),
                              f"predictor bert {dtype}: row {i} not finite")
                        worst[name] = max(worst[name], float(
                            abs(got - want).max() / abs(want).max()))
            limit = PRED_BERT_RTOL[dtype]
            bucket = pick_bucket(n_pad, pred.buckets)
            log(f"[predictor] bert {dtype}: every served row against the "
                f"same row predicted alone (bucket 1), max |diff| over the "
                f"largest entry: sequence {worst['seq']:.3g}, pooled "
                f"{worst['pooled']:.3g} (limit {limit}); {len(mixed)} rows "
                f"were served in batches that held other rows, and "
                f"{n_pad} by a predict padded to bucket {bucket}")
            check(max(worst.values()) <= limit and mixed and bucket > n_pad,
                  f"predictor bert {dtype}: a row served in a batch differs "
                  f"from it alone by {worst}")
            _take_counts(taken)
            _bert_against_eager(dtype, bert, pred, batches, futs, index,
                                (tok, tt, vl))
            ck.reset_launch_counts()
            timings[dtype] = _bucket_timings(
                f"bert {dtype}", PRED_TIMED + (PRED_BERT_BATCH,), pred, bert,
                lambda b: tuple(torch.from_numpy(a[:b]).to(DEV)
                                for a in (tok, tt, vl)), smi_line)
            ck.reset_launch_counts()
        finally:
            pred.close()
        del pred, batches, futs
        _release()
    del bert
    _release()
    return timings


def _bert_against_eager(dtype, bert, pred, batches, futs, index, arrays):
    """Every served BERT batch against the eager block's forward (its
    hybridized children inline) of the same padded bucket batch. Bitwise is
    expected, as for ResNet: the same kernels on the same operands; the
    limit (PRED_BERT_EAGER_RTOL of each output's largest entry) allows for
    a GEMM algorithm that cuBLAS would pick otherwise under capture."""
    import torch

    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.serve import pick_bucket

    worst = {"seq": 0.0, "pooled": 0.0}
    bitwise = True
    for batch in batches:
        rows = [index[id(req.future)] for req in batch]
        bucket = pick_bucket(len(rows), pred.buckets)
        xs = []
        for a in arrays:
            pad = onp.zeros((bucket,) + a.shape[1:], a.dtype)
            pad[:len(rows)] = a[rows]
            xs.append(torch.from_numpy(pad).to(DEV))
        with torch.no_grad(), cached_op.inlined():
            want = [w[:len(rows)].float().cpu().numpy() for w in bert(*xs)]
        for j, name in enumerate(("seq", "pooled")):
            got = onp.stack([onp.asarray(futs[i].result()[j],
                                         dtype="float32") for i in rows])
            bitwise = bitwise and onp.array_equal(got, want[j])
            worst[name] = max(worst[name], float(
                abs(got.astype("float64") - want[j]).max() /
                abs(want[j]).max()))
    limit = PRED_BERT_EAGER_RTOL[dtype]
    log(f"[predictor] bert {dtype}: {len(batches)} served batches against "
        f"the eager block's forward of the same padded bucket batch: "
        f"bitwise {bitwise}; max |diff| over the largest entry: sequence "
        f"{worst['seq']:.3g}, pooled {worst['pooled']:.3g} (limit {limit})")
    check(max(worst.values()) <= limit,
          f"predictor bert {dtype}: served batches differ from the eager "
          f"forward by {worst}")


def phase_predictor(smi_line):
    """Phase 8: the Predictor serving hybridized ResNet-50 v1 (bf16) and
    BERT-Base (fp32, then bf16) at full width. Returns the phase's launch
    counts (the warm calls and the captures; replays move no counter)."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    ck.reset_launch_counts()
    taken = {}
    _pred_resnet(smi_line, taken)
    _pred_bert(smi_line, taken)
    PATH_DTYPES["predictor"] = taken
    counts = {k: sum(n for (kern, _), n in taken.items() if kern == k)
              for k in ck.launch_counts()}
    log(f"[predictor] kernel launches on the path (the eager comparisons "
        f"left out), by kernel: {counts}; by dtypes: {taken}")
    check(counts["flash_fwd"] > 0 and counts["layer_norm"] > 0,
          f"predictor: the flash forward or LayerNorm did not launch: "
          f"{counts}")
    log(f"[predictor] both Predictors closed and freed: "
        f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB reserved")
    log(f"[predictor] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 9: BERT pretraining through parallel.Learner, and the Gluon loop
# ---------------------------------------------------------------------------
BASELINE_BERT_TOKENS = 10000.0   # bench.py:30
BERT_PARAMS = {"base": 110e6, "large": 340e6}   # bench.py:39
BERT_CHECK_BATCH = 8            # (i) the card against the CPU, fp32
BERT_LOSS_RTOL = 1e-4           # (i) loss, card vs CPU (fp32 sums)
BERT_UPDATE_RTOL = 1e-3         # (i) updates over each one's largest entry
BERT_CHECK_LR = 0.1             # (i) SGD(0.1, momentum 0.9), as phase 7 (i)
GLUON_STEPS = 5                 # (iv) steps of the generic Gluon loop
GLUON_SIGNATURES = (7, 6, 5, 4, 3)  # (iv) batch sizes of the pool check
BERT_LAYERS = {"base": 12, "large": 24}
BERT_LARGE_ADAMW = {}           # phase 9 (iii)'s numbers, for phase 12 (i)


def _sync(data):
    """``bench.py``'s barrier (:76): one value read back to the host."""
    return float(data.reshape(-1)[0])


def _mfu(flops_per_sec):
    """``bench.py``'s MFU (:69) over the card's dense bf16 peak
    (``PEAK_BF16_FLOPS``, H100 SXM, 989 TFLOP/s)."""
    return round(flops_per_sec / PEAK_BF16_FLOPS, 4)


def bench_bert_pretrain(size="base", optimizer=None):
    """BERT MLM+NSP pretraining step, bf16, one chip (configs 4 and the
    BERT-Large north-star metric); ``optimizer`` replaces the bench's
    AdamW (phase 12 runs it with LAMB)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, parallel
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_base, BERTForPretraining

    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_large

    B = 32 if size == "base" else 8
    T, WARMUP, ITERS = 128, 2, 8
    maker = bert_base if size == "base" else bert_large
    bert = maker(max_length=T, dropout=0.1, dtype="float32")
    model = BERTForPretraining(bert, vocab_size=30522)

    padded = os.environ.get("BENCH_BERT_PADDED", "1") == "1"
    if padded:
        # realistic padded batches: a fixed 7/8-valid key-padding mask per
        # row keeps attention on the fused segment-ids flash path (the
        # HLO carries the masked kernel, not an O(T²) where-mask)
        class _PaddedBERT(gluon.HybridBlock):
            def __init__(self, inner, t_valid):
                super().__init__()
                self.inner = inner
                self._t_valid = t_valid

            def forward(self, tokens):
                vlen = mx.np.full((tokens.shape[0],), self._t_valid,
                                  dtype="float32")
                return self.inner(tokens, None, vlen)

        model = _PaddedBERT(model, T * 7 // 8)
    model.initialize()
    amp.convert_hybrid_block(model, "bfloat16")
    amp.init("bfloat16")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def pretrain_loss(pair, labels):
        mlm_scores, nsp_scores = pair
        mlm_labels, nsp_labels = labels[:, :-1], labels[:, -1]
        return loss_fn(mlm_scores, mlm_labels).mean() + \
            loss_fn(nsp_scores, nsp_labels).mean()

    learner = parallel.Learner(model, pretrain_loss,
                               optimizer or mx.optimizer.AdamW(
                                   learning_rate=1e-4, wd=0.01),
                               remat=(size == "large"))
    tokens = mx.np.random.randint(0, 30522, size=(B, T))
    labels = mx.np.concatenate([
        mx.np.random.randint(0, 30522, size=(B, T)),
        mx.np.random.randint(0, 2, size=(B, 1))], axis=1).astype("float32")
    for _ in range(WARMUP):
        _sync(learner.step(tokens, labels)._data)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        loss = learner.step(tokens, labels)
    _sync(loss._data)
    dt = time.perf_counter() - t0
    tok_s = B * T * ITERS / dt
    return {"metric": f"bert_{size}_pretrain_bf16_tokens_per_sec",
            "value": round(tok_s, 1), "unit": "tokens/s",
            "vs_baseline": round(tok_s / BASELINE_BERT_TOKENS, 3),
            "padded": padded,  # workload variant: keeps rounds comparable
            "mfu": _mfu(tok_s * 6 * BERT_PARAMS[size])}


def _fp32_pretrain_loss(net, x, y):
    """The bench's pretraining loss of ``net`` on ``(x, y)`` in predict
    mode (no dropout), the scores upcast to float32: a loss at float32's
    resolution, where the bench's bf16 loss moves in steps of 1/16."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.block import unwrap

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.pause():
        mlm, nsp = (unwrap(o).float() for o in net(x))
        y = unwrap(y)
        return float(loss_fn(mlm, y[:, :-1]).mean() +
                     loss_fn(nsp, y[:, -1]).mean())


def _watched_bench(size, remat=None, optimizer=None, probe=False):
    """``bench_bert_pretrain(size, optimizer)`` as it is, with
    ``parallel.Learner`` swapped for a subclass that keeps each step's loss
    and inputs (and, with ``remat`` given, forces that flag): returns the
    bench's result, the learner, and the peak device memory of the run.
    With ``probe`` the learner also keeps :func:`_fp32_pretrain_loss`
    before its first step (``probe_first``) and after its last
    (``probe_last``, under the bench's AMP state)."""
    import torch

    import mxnet_tpu_torch.parallel as par
    from mxnet_tpu_torch import amp

    real, made = par.Learner, []

    class Watched(real):
        def __init__(self, *args, **kwargs):
            if remat is not None:
                kwargs["remat"] = remat
            super().__init__(*args, **kwargs)
            self.losses, self.batch = [], None
            made.append(self)

        def step(self, x, y):
            if probe and self.batch is None:
                self.probe_first = _fp32_pretrain_loss(self.net, x, y)
            loss = super().step(x, y)
            self.losses.append(loss)
            self.batch = (x, y)
            return loss

    _release()
    torch.cuda.reset_peak_memory_stats()
    par.Learner = Watched
    try:
        result = bench_bert_pretrain(size, optimizer)
        peak = torch.cuda.max_memory_allocated()
        if probe:
            made[0].probe_last = _fp32_pretrain_loss(made[0].net,
                                                     *made[0].batch)
            made[0].probe_steps = len(made[0].losses)
    finally:
        par.Learner = real
        amp.disable()
    torch.cuda.synchronize()
    return result, made[0], peak


def _bert_numbers(tag, size, result, learner, peak, smi_line):
    """The bench's numbers and the learner's: tokens/s and MFU, one step's
    wall against device busy and the idle share, captures, launches a step
    by kernel (captured launches, one replay a step), peak memory, first
    and last loss; checks one capture, no counter moving while it replays,
    and the launches each kernel of the path should have."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    x, y = learner.batch
    stats = learner.graph_stats()
    check(learner._traces == 1 and learner._captures == 1 and
          len(stats) == 1,
          f"{tag}: {learner._traces} traces, {learner._captures} captures "
          f"(one signature, one capture, none after warm-up)")
    captured = stats[0]["captured_launches"]
    layers = BERT_LAYERS[size]
    fwd = 2 if learner._remat else 1
    want = {"flash_fwd": fwd * layers, "flash_bwd_dkv": layers,
            "flash_bwd_dq": layers, "layer_norm": fwd * (2 * layers + 2)}
    got = {k: captured[k] for k in want}
    check(got == want, f"{tag}: launches a step {got} != {want}")
    bf16 = {k: n for k, n in stats[0]["captured_dtypes"].items()
            if k[0].startswith("flash") and k[1][0] == "bfloat16"}
    check(sum(bf16.values()) == sum(n for k, n in want.items()
                                    if k.startswith("flash")),
          f"{tag}: flash launches not all bf16: "
          f"{stats[0]['captured_dtypes']}")

    def step():
        learner.step(x, y)

    before = ck.launch_counts()
    wall = _wall_ms(step, 5)
    busy, kernels, by_name = _profile(step, reps=3)
    check(ck.launch_counts() == before,
          f"{tag}: a kernel counter moved while the step replayed")
    losses = [float(v._data) for v in learner.losses]
    check(all(math.isfinite(v) for v in losses), f"{tag}: losses {losses}")
    idle = max(0.0, 1 - busy / wall)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[bert_pretrain] {tag}: {result['value']} tokens/s, MFU "
        f"{result['mfu']} (6 x {BERT_PARAMS[size]:.3g} x tokens/s over "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16, H100 SXM); step "
        f"wall {wall:.3f} ms, device busy {busy:.3f} ms, {kernels:.0f} "
        f"kernels, idle share {idle:.3f}; captures {learner._captures}; "
        f"launches a step {got} (captured, one replay a step; replays "
        f"{stats[0]['replays']}); peak memory {peak / 2**20:.0f} MiB; loss "
        f"first {losses[0]:.4f} last {losses[-1]:.4f}; card {smi_line}")
    log(f"[bert_pretrain] {tag}: heaviest kernels (device ms a step): "
        + "; ".join(f"{n[:70]} {us / 3 / 1e3:.3f}" for n, us in top))
    return {"tokens_s": result["value"], "mfu": result["mfu"], "wall": wall,
            "busy": busy, "idle": idle, "peak": peak, "launches": got,
            "kernels": kernels, "by_name": by_name, "losses": losses}


def _bert_check_model(arrays, device, dropout=0.0):
    """``_PaddedBERT(BERTForPretraining(bert_base(max_length=128)))`` on
    ``device`` holding ``arrays`` (fp32)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      bert_base)

    class _PaddedBERT(gluon.HybridBlock):
        def __init__(self, inner, t_valid):
            super().__init__()
            self.inner = inner
            self._t_valid = t_valid

        def forward(self, tokens):
            vlen = mx.np.full((tokens.shape[0],), self._t_valid,
                              dtype="float32", ctx=tokens.device)
            return self.inner(tokens, None, vlen)

    model = _PaddedBERT(BERTForPretraining(
        bert_base(max_length=BERT_T, dropout=dropout, device=device),
        vocab_size=30522), BERT_VALID)
    if arrays is not None:
        model.load_dict(arrays)
    return model


def _pretrain_loss_fn():
    from mxnet_tpu_torch import gluon

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def pretrain_loss(pair, labels):
        mlm_scores, nsp_scores = pair
        mlm_labels, nsp_labels = labels[:, :-1], labels[:, -1]
        return loss_fn(mlm_scores, mlm_labels).mean() + \
            loss_fn(nsp_scores, nsp_labels).mean()

    return pretrain_loss


def _bert_batch(rng, B):
    tokens = rng.integers(0, 30522, (B, BERT_T)).astype("int32")
    labels = onp.concatenate([rng.integers(0, 30522, (B, BERT_T)),
                              rng.integers(0, 2, (B, 1))], axis=1)
    return tokens, labels.astype("float32")


def _bert_vs_cpu(smi_line):
    """(i) One fp32 Learner step of the padded BERT-Base at full width,
    B = 8, dropout 0, weights from a numpy seed, SGD(0.1, momentum 0.9),
    on the card and on the CPU: the loss within 1e-4, and the updates of
    the word embedding and of layer 0's qkv weight within 1e-3 of each
    update's largest entry (fp32 both; TF32 off on the card; the flash
    kernels' 3xTF32 and the sum orders are what differ)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel

    rng = onp.random.default_rng(SEED + 14)
    shapes = {n: tuple(p.shape) for n, p in _bert_check_model(
        None, "cpu").collect_params().items()}
    arrays = train_weights(shapes, SEED + 14)   # BERT's init too
    tokens, labels = _bert_batch(rng, BERT_CHECK_BATCH)
    names = ("inner.bert.word_embed.weight",
             "inner.bert.encoder.layers.0.attn_qkv.weight")
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = mx.gpu() if dev == "cuda" else mx.cpu()
        with ctx:
            model = _bert_check_model(arrays, dev)
            learner = parallel.Learner(
                model, _pretrain_loss_fn(),
                mx.optimizer.SGD(learning_rate=BERT_CHECK_LR, momentum=0.9))
            t0 = time.perf_counter()
            loss = learner.step(mx.np.array(tokens), mx.np.array(labels))
            loss = float(loss._data)
            params = model.collect_params()
            upd = {n: (params[n].detach().cpu() - torch.from_numpy(
                arrays[n])) for n in names}
            out[dev] = (loss, upd, time.perf_counter() - t0)
        del model, learner, params
        _release()
    (lc, uc, tc), (lh, uh, th) = out["cuda"], out["cpu"]
    e_loss = abs(lc - lh) / abs(lh)
    errs = {n: _max_rel(uc[n], uh[n]) for n in names}
    log(f"[bert_pretrain] (i) fp32 Learner step, padded BERT-Base at B="
        f"{BERT_CHECK_BATCH}, card against CPU: loss {lc:.6f} / {lh:.6f} "
        f"(relative {e_loss:.3g}, limit {BERT_LOSS_RTOL}); updates over "
        f"each one's largest entry {errs} (limit {BERT_UPDATE_RTOL}); "
        f"seconds card {tc:.1f} (warm step and capture), CPU {th:.1f}; "
        f"card {smi_line}")
    check(e_loss <= BERT_LOSS_RTOL, f"(i) loss {lc} against the CPU's {lh}")
    check(all(e <= BERT_UPDATE_RTOL for e in errs.values()),
          f"(i) updates against the CPU's: {errs}")
    check(all(float(uh[n].abs().max()) > 0 for n in names),
          "(i) a checked weight did not move")
    return arrays


def _replay_vs_eager(smi_line):
    """(ii, second half) The bench's Base configuration at dropout 0: from
    one state, a replayed step against the same step run eagerly
    (``Learner._run_eager``): loss, every parameter and every optimizer
    state bitwise equal."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, parallel

    rng = onp.random.default_rng(SEED + 15)
    model = _bert_check_model(None, "cuda")
    model.initialize(seed=15)
    amp.convert_hybrid_block(model, "bfloat16")
    amp.init("bfloat16")
    try:
        learner = parallel.Learner(
            model, _pretrain_loss_fn(),
            mx.optimizer.AdamW(learning_rate=1e-4, wd=0.01))
        tokens, labels = (mx.np.array(a) for a in _bert_batch(rng, 32))
        learner.step(tokens, labels)        # warm step and capture
        tree = learner._checkpoint_tree()
        start = {k: v.detach().clone() for k, v in tree.items()}
        replayed = learner.step(tokens, labels)
        after = {k: v.detach().clone() for k, v in tree.items()}
        with torch.no_grad():
            for k, v in tree.items():
                v.copy_(start[k])
        eager = learner._run_eager(tokens, labels)
        torch.cuda.synchronize()
    finally:
        amp.disable()
    bad = [k for k, v in tree.items() if not torch.equal(v, after[k])]
    same = torch.equal(replayed._data, eager._data)
    log(f"[bert_pretrain] (ii) replayed step against the same step run "
        f"eagerly (Base, bf16, dropout 0, B=32): loss {float(replayed._data)}"
        f" / {float(eager._data)} bitwise {same}; {len(tree) - len(bad)} of "
        f"{len(tree)} parameters and optimizer states bitwise equal; card "
        f"{smi_line}")
    check(same and not bad, f"(ii) replay against eager: loss equal {same},"
          f" differing {bad[:5]}")
    del learner, model, tree, start, after
    _release()


def _gluon_loop(arrays, smi_line):
    """(iv) The generic Gluon loop on a hybridized padded BERT-Base (fp32,
    dropout 0, B = 8): ``autograd.record()``, ``backward()`` and
    ``Trainer.step`` for GLUON_STEPS steps beside the un-hybridized block
    from the same weights: every gradient of every step bitwise equal; one
    forward and one backward capture, the backward flash kernels inside the
    captured backward; a step's wall, device busy and idle share both
    ways; then the block's graph pool bytes over GLUON_SIGNATURES more
    batch sizes under ``record()``, beyond the block's limit of recorded
    programs."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      bert_base)

    rng = onp.random.default_rng(SEED + 16)
    tokens, labels = _bert_batch(rng, BERT_CHECK_BATCH)
    tok = torch.from_numpy(tokens).cuda()
    lab = torch.from_numpy(labels).cuda()
    vl = torch.full((BERT_CHECK_BATCH,), float(BERT_VALID), device="cuda")
    vl[-1] = 57.0
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    for hybrid in (False, True):
        model = BERTForPretraining(bert_base(max_length=BERT_T, dropout=0.0),
                                   vocab_size=30522)
        model.load_dict({n[len("inner."):]: a for n, a in arrays.items()})
        if hybrid:
            model.hybridize()
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9})
        runs.append((model, trainer))

    def step_loss(pair, labels):
        mlm, nsp = pair
        return loss_fn(mlm, labels[:, :-1]).mean() + \
            loss_fn(nsp, labels[:, -1]).mean()

    def step(model, trainer):
        with autograd.record():
            loss = step_loss(model(tok, None, vl), lab)
        autograd.backward(loss)
        trainer.step(1)
        return loss

    for i in range(GLUON_STEPS):
        losses = [step(m, t) for m, t in runs]
        check(torch.equal(losses[0], losses[1]),
              f"(iv) step {i}: loss {float(losses[0])} eager against "
              f"{float(losses[1])} hybridized")
        pe = runs[0][0].collect_params()
        bad = [n for n, p in runs[1][0].collect_params().items()
               if not torch.equal(p.grad, pe[n].grad)]
        check(not bad, f"(iv) step {i}: gradients not bitwise equal: "
                       f"{bad[:5]}")
    hmodel = runs[1][0]
    cop = next(iter(hmodel._cached.values()))[0]
    prog = next(iter(cop._recorded.values()))
    want = {"flash_bwd_dkv": 12, "flash_bwd_dq": 12}
    got = {k: prog.backward_launches[k] for k in want}
    check(len(hmodel._cached) == 1 and cop._captures == 1 and
          cop._backward_captures == 1 and got == want and
          prog.captured_launches["flash_fwd"] == 12,
          f"(iv) captures {cop._captures} forward, "
          f"{cop._backward_captures} backward; backward launches {got}")
    timings = {}
    for tag, (m, t) in zip(("eager", "hybridized"), runs):
        wall = _wall_ms(lambda: step(m, t), 5)
        busy, kernels, _ = _profile(lambda: step(m, t), reps=3)
        timings[tag] = (wall, busy, kernels, max(0.0, 1 - busy / wall))
    (ew, eb, ek, ei), (hw, hb, hk, hi) = timings["eager"], \
        timings["hybridized"]
    log(f"[bert_pretrain] (iv) Gluon loop, padded BERT-Base fp32 B="
        f"{BERT_CHECK_BATCH}: {GLUON_STEPS} steps, every loss and gradient "
        f"bitwise equal to the un-hybridized block's; 1 forward and 1 "
        f"backward capture, forward replays {prog.replays}, backward "
        f"replays {prog.backward_replays}, backward launches {got}; a step "
        f"(record, backward, Trainer.step): hybridized wall {hw:.3f} ms, "
        f"busy {hb:.3f}, {hk:.0f} kernels, idle {hi:.3f}; eager wall "
        f"{ew:.3f} ms, busy {eb:.3f}, {ek:.0f} kernels, idle {ei:.3f}; card "
        f"{smi_line}")
    # the last losses hold their tape nodes, and so their programs
    del runs, cop, prog, losses
    _release()
    _gluon_pool_bytes(hmodel, tok, lab, vl, step_loss, smi_line)
    return timings


def _gluon_pool_bytes(hmodel, tok, lab, vl, step_loss, smi_line):
    """(iv, last) The hybridized block under ``record()`` at batch sizes
    GLUON_SIGNATURES after the loop's: its graph pools' bytes after each
    signature. A block keeps ``GraphPool.recorded_limit`` recorded
    programs, so the pools grow little once older ones are dropped: the
    bytes after the last within a fifth of the most after the first
    ``recorded_limit`` (six kept programs would add about a third; the
    dropped programs' memory leaves some growth, a twelfth on an H100)."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.cached_op import GraphPool

    def ops():
        return [e[0] for e in hmodel._cached.values()]

    sizes = [(tok.shape[0], ops()[0].pool_bytes())]
    for b in GLUON_SIGNATURES:
        with autograd.record():
            loss = step_loss(hmodel(tok[:b], None, vl[:b]), lab[:b])
        autograd.backward(loss)
        torch.cuda.synchronize()
        sizes.append((b, ops()[0].pool_bytes()))
    del loss
    limit = GraphPool.recorded_limit
    gpool = ops()[0]._gpool
    kept = sum(len(op._recorded) for op in ops())
    most = max(n for _, n in sizes[:limit])
    log(f"[bert_pretrain] (iv) graph pool bytes of the hybridized block "
        f"under record() by batch size (each a new signature): "
        + ", ".join(f"B={b} {n / 2**20:.1f} MiB" for b, n in sizes)
        + f"; recorded programs kept {kept} (limit {limit}), dropped "
        f"{gpool.evicted}; card {smi_line}")
    check(kept <= limit and gpool.evicted == len(sizes) - limit and
          sizes[-1][1] <= 1.20 * most,
          f"(iv) recorded programs not bounded: kept {kept}, dropped "
          f"{gpool.evicted}, bytes {sizes}")
    del hmodel
    _release()


def phase_bert_pretrain(smi_line):
    """Phase 9: BERT pretraining on the card through ``parallel.Learner``
    (one CUDA graph a step) and the hybridized Gluon loop; returns the
    path's launch counts (the benches' warm steps and captures)."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    arrays = _bert_vs_cpu(smi_line)
    taken = {}
    ck.reset_launch_counts()
    base, learner, peak = _watched_bench("base")
    counts = ck.launch_counts()
    check(all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq", "layer_norm")),
          f"(ii) a kernel of the path did not launch: {counts}")
    _take_counts(taken)
    nb = _bert_numbers("(ii) Base, B=32", "base", base, learner, peak,
                       smi_line)
    BERT_BASE_STEP.update(nb)
    del learner
    _replay_vs_eager(smi_line)
    ck.reset_launch_counts()
    large, learner, peak = _watched_bench("large")
    _take_counts(taken)
    nl = _bert_numbers("(iii) Large, B=8, remat", "large", large, learner,
                       peak, smi_line)
    del learner
    plain, learner, peak_plain = _watched_bench("large", remat=False)
    ck.reset_launch_counts()
    np_ = _bert_numbers("(iii) Large, B=8, no remat", "large", plain,
                        learner, peak_plain, smi_line)
    del learner
    _release()
    log(f"[bert_pretrain] (iii) peak memory with remat {nl['peak'] / 2**20:.0f}"
        f" MiB against {np_['peak'] / 2**20:.0f} MiB without, at B=8; "
        f"tokens/s {nl['tokens_s']} against {np_['tokens_s']}; card "
        f"{smi_line}")
    check(nl["peak"] < np_["peak"], "(iii) remat did not lower peak memory")
    BERT_LARGE_ADAMW.update(nl)
    _gluon_loop(arrays, smi_line)
    PATH_DTYPES["bert_pretrain"] = taken
    log(f"[bert_pretrain] kernel launches on the path (the two benches' warm "
        f"steps and captures), by dtypes: {taken}; Base {nb['tokens_s']} and "
        f"Large {nl['tokens_s']} tokens/s")
    log(f"[bert_pretrain] phase took {time.perf_counter() - t_phase:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 10: the graph layer (Symbol, export / SymbolBlock.imports, the
# Executor, optimize_for("tpu"))
# ---------------------------------------------------------------------------
GRAPH_BERT_SHAPE = (32, 128)  # B, T of the BERT-Base round trip
GRAPH_RTOL = 1e-5             # round trip: the same kernels in the same
#                               order, so equality is expected; the limit is
#                               that of fp32 sums in another order
GRAPH_ATTN_SHAPE = (4, 12, 1024, 64)  # GPT-2 small's attention, fp32
GRAPH_MLP = dict(x=(64, 768), w1=(3072, 768), b1=(3072,), w2=(768, 3072),
                 b2=(768,))   # the Executor's MLP: GPT-2 small's FFN widths
GRAPH_EXEC_RTOL = 1e-5        # Executor card vs CPU, fp32 GEMMs, TF32 off


def _graph_bert(smi_line, taken, where):
    """(i) BERT-Base exported and imported back: the SymbolBlock's outputs
    against the hybridized block's, 12 flash forward (key-padding ids) and
    25 LayerNorm launches in its one captured program, then a Predictor
    over it; returns the phase's numbers."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.symbol import topo_sort

    B, T = GRAPH_BERT_SHAPE
    bert = bert_base(max_length=T, dropout=0.0)
    bert.load_dict(numpy_weights(
        {n: tuple(p.shape) for n, p in bert.collect_params().items()},
        SEED + 21))
    bert.hybridize()
    rs = onp.random.default_rng(SEED + 22)
    tok = rs.integers(0, 30522, (B, T), dtype="int32")
    tt = rs.integers(0, 2, (B, T), dtype="int32")
    vl = rs.integers(16, T + 1, B).astype("float32")
    vl[0], vl[1] = 0.0, float(T)        # a row with every key masked
    xs = tuple(torch.from_numpy(a).to(DEV) for a in (tok, tt, vl))
    with torch.no_grad():
        want = bert(*xs)
    t0 = time.perf_counter()
    sym_file, param_file = bert.export(os.path.join(where, "bert"))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk = SymbolBlock.imports(sym_file, ["data0", "data1", "data2"],
                              param_file, ctx=mx.gpu())
    import_s = time.perf_counter() - t0
    nodes = [n for n in topo_sort(blk._sym._entries) if n.op is not None]
    ops = {}
    for n in nodes:
        ops[n.op.name] = ops.get(n.op.name, 0) + 1
    mha = [n for n in nodes if n.op.name == "multihead_attention"]
    check(len(mha) == len(bert.encoder.layers) and
          all(len(n.inputs) == 4 for n in mha),
          f"graph: BERT's attention nodes lost the key-padding mask: {ops}")
    blk.hybridize()
    _take_counts(taken)
    with torch.no_grad():
        got = blk(*xs)
        torch.cuda.synchronize()
    (cop, _, _), = blk._cached.values()
    stats = cop.graph_stats()
    captured = stats[0]["captured_launches"] or {}
    check(len(stats) == 1 and all(captured.get(k) == v
                                  for k, v in BERT_WANT.items()),
          f"graph: the imported BERT's program launched {captured}, want "
          f"{BERT_WANT} in one program")
    errs = [_max_rel(g, w) for g, w in zip(got, want)]
    log(f"[graph] (i) BERT-Base (B={B}, T={T}, valid lengths 0-{T}) "
        f"exported in {export_s:.2f} s ({os.path.getsize(sym_file)} bytes "
        f"of JSON, {len(nodes)} op nodes: {ops}), imported in {import_s:.2f}"
        f" s; the imported block's sequence and pooled outputs against the "
        f"hybridized block's, max |diff| over the largest entry: {errs} "
        f"(limit {GRAPH_RTOL}); its program's captured launches {captured} "
        f"(one program); card {smi_line}")
    check(max(errs) <= GRAPH_RTOL, f"graph: BERT round trip differs {errs}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "graph: BERT outputs not finite")
    with torch.no_grad():
        for _ in range(3):
            again = blk(*xs)
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          "graph: a replay of the imported BERT differs from its first run")
    _take_counts(taken)

    # -- the Predictor over the imported block -----------------------------
    items = [(tok[i % B], tt[i % B], vl[i % B])
             for i in range(PRED_BERT_REQUESTS)]
    example = (torch.zeros((2, T), dtype=torch.int32),
               torch.zeros((2, T), dtype=torch.int32), torch.zeros(2))
    t0 = time.perf_counter()
    pred = blk.predictor(example=example, max_batch=PRED_BERT_BATCH)
    try:
        pred.warmup()
        warm_s = time.perf_counter() - t0
        st = _pred_serving_line("graph bert", pred, warm_s, smi_line)
        check(st["captures"] == len(pred.buckets) == 6,
              f"graph: the Predictor made {st['captures']} programs")
        served = pred.predict((tok, tt, vl))
        for name, s, w in zip(("sequence", "pooled"), served, got):
            err = _max_rel(s._data, w)
            check(err <= GRAPH_RTOL,
                  f"graph: the Predictor's {name} differs from the block's "
                  f"by {err}")
        at_warm = ck.launch_counts()
        futs, wall = _submit_from_threads(pred, items, PRED_THREADS)
        check(ck.launch_counts() == at_warm,
              "graph: a kernel counter moved while serving")
        alone_err = 0.0
        for i, f in enumerate(futs):
            for s, w in zip(f.result(), got):
                row = w[i % B].detach().float().cpu().numpy()
                alone_err = max(alone_err, float(
                    abs(onp.asarray(s, "float64") - row).max() /
                    abs(row).max()))
        log(f"[graph] (i) Predictor over the imported BERT: "
            f"{PRED_BERT_REQUESTS} requests from {PRED_THREADS} threads in "
            f"{wall:.3f} s, {pred.stats()['batches']} batches; a bucket-32 "
            f"predict against the block: equal within {GRAPH_RTOL}; served "
            f"rows against the block's rows, max |diff| over the largest "
            f"entry {alone_err:.3g} (limit {PRED_BERT_RTOL['float32']})")
        check(alone_err <= PRED_BERT_RTOL["float32"],
              f"graph: a served row differs by {alone_err}")
        _take_counts(taken)
        timing = {}
        prog = pred._programs[PRED_BERT_BATCH]
        for tag, fn in (("Predictor's imported program",
                         lambda: prog(*xs)),
                        ("hybridized block", lambda: bert(*xs))):
            with torch.no_grad():
                wall_ms = _wall_ms(fn, 10)
                busy, kernels, _ = _profile(fn)
            timing[tag] = (wall_ms, busy, max(0.0, 1 - busy / wall_ms))
            log(f"[graph] (i) bucket {PRED_BERT_BATCH}, {tag}: wall "
                f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, "
                f"{kernels:.0f} kernels, idle share "
                f"{timing[tag][2]:.3f}; card {smi_line}")
        ck.reset_launch_counts()
    finally:
        pred.close()
    del pred, blk, bert
    _release()
    return timing


def _graph_resnet(smi_line, taken, where):
    """(ii) ResNet-50 v1 exported at batch 8 in predict mode and imported
    back; no port kernel runs."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    net = _resnet_net(resnet_weights(SEED + 7))
    net.hybridize()
    x = torch.from_numpy(onp.random.default_rng(SEED + 23).standard_normal(
        (RESNET_CHECK_BATCH, *RESNET_IMAGE), dtype="float32")).to(DEV)
    before = ck.launch_counts()
    with torch.no_grad():
        want = net(x)
        files = net.export(os.path.join(where, "resnet50"))
        blk = SymbolBlock.imports(*files[:1], "data0", files[1],
                                  ctx=mx.gpu())
        blk.hybridize()
        got = blk(x)
        torch.cuda.synchronize()
    err = _max_rel(got, want)
    log(f"[graph] (ii) ResNet-50 v1 at batch {RESNET_CHECK_BATCH}, 224x224, "
        f"fp32, predict mode: the imported block against the hybridized "
        f"one, max |diff| over the largest logit {err} (limit "
        f"{RESNET_FP32_RTOL}); port kernel launches "
        f"{ {k: n - before[k] for k, n in ck.launch_counts().items()} }")
    check(err <= RESNET_FP32_RTOL, f"graph: ResNet round trip differs {err}")
    check(ck.launch_counts() == before,
          "graph: a port kernel launched on the ResNet path")
    _take_counts(taken)
    del net, blk
    _release()


def _manual_attention_block():
    """The reference's ``_ManualAttention`` (tests/test_subgraph_passes.py,
    the "div" style) and its masked form, through ``mx.np``/``mx.npx``."""
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon import HybridBlock

    class ManualAttention(HybridBlock):
        def forward(self, q, k, v, mask=None):
            logits = mnp.matmul(q, mnp.swapaxes(k, -1, -2)) / \
                (q.shape[-1] ** 0.5)
            if mask is not None:
                logits = mnp.where(mask, logits,
                                   mnp.array(-1e30, dtype="float32"))
            return mnp.matmul(npx.softmax(logits, axis=-1), v)

    return ManualAttention


def _graph_attention(smi_line, taken):
    """(iii) ``optimize_for("tpu")`` on hand-written attention at GPT-2
    small's width, unmasked and with a (B, 1, 1, T) key-padding mask:
    one ``flash_attention`` node and no softmax, forward within FLASH_TOL
    and q/k/v gradients within GRAD_RTOL of the unfused graph (the
    ``"default"`` backend's), one launch of each flash kernel a step,
    device ms both ways."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.symbol import topo_sort

    Block = _manual_attention_block()
    B, H, T, D = GRAPH_ATTN_SHAPE
    rs = onp.random.default_rng(SEED + 24)
    base = [torch.from_numpy(rs.standard_normal((B, H, T, D),
                                                dtype="float32")).to(DEV)
            for _ in range(3)]
    valid = torch.ones((B, 1, 1, T), device=DEV)
    valid[..., 3 * T // 4:] = 0.0
    for masked in (False, True):
        args = base + ([valid] if masked else [])
        results = {}
        for fused in (False, True):
            # unfused: the same traced graph without the pass (the
            # "default" backend), so the block's host constant (-1e30) is a
            # const node placed on the card before the capture; a plain
            # hybridize would copy it from the host inside the capture
            net = Block()
            net.optimize_for(*args, backend="tpu" if fused else "default")
            (cop, _, _), = net._cached.values()
            names = [n.op.name for n in topo_sort(cop.sym._entries)
                     if n.op is not None]
            check(("softmax" not in names and
                   names.count("flash_attention") == 1) if fused else
                  ("softmax" in names and "flash_attention" not in names),
                  f"graph: the {'optimized' if fused else 'unfused'} graph "
                  f"holds {names}")
            _take_counts(taken)
            outs = grads = None
            for _ in range(3):
                xs = [mx.nd.NDArray(a.clone()) for a in args]
                for a in xs[:3]:
                    a.attach_grad()
                with autograd.record():
                    out = net(*xs)
                    loss = (out * out).sum()
                loss.backward()
                outs, grads = out._data, [a.grad._data for a in xs[:3]]
            torch.cuda.synchronize()
            launched = ck.launch_counts()
            rec = [v for k, v in net._cached.items() if k[2]]
            stats = rec[0][0].graph_stats() if rec else []
            _take_counts(taken)

            def fwd():
                with torch.no_grad():
                    net(*args)

            xs = [mx.nd.NDArray(a.clone()) for a in args]
            for a in xs[:3]:
                a.attach_grad()

            def step():
                with autograd.record():
                    out = net(*xs)
                    loss = (out * out).sum()
                loss.backward()

            fwd()
            ms = {"forward": _profile(fwd)[0],
                  "forward+backward": _profile(step)[0]}
            ck.reset_launch_counts()
            results[fused] = (outs, grads, launched, stats, ms)
        (o0, g0, _, _, ms0), (o1, g1, launched, stats, ms1) = \
            results[False], results[True]
        f_err = _max_rel(o1, o0)
        g_err = [_max_rel(a, b) for a, b in zip(g1, g0)]
        rec = [s for s in stats if s.get("recorded")]
        cap = (rec[0]["captured_launches"] if rec else None) or {}
        bwd = (rec[0]["backward_captured_launches"] if rec else None) or {}
        tag = "key-padding mask (3/4 of the keys valid)" if masked \
            else "no mask"
        log(f"[graph] (iii) optimize_for('tpu') at {GRAPH_ATTN_SHAPE} fp32, "
            f"{tag}: forward max |diff| over the largest entry {f_err:.3g} "
            f"(limit {FLASH_TOL}), dq/dk/dv {[f'{e:.3g}' for e in g_err]} "
            f"(limit {GRAD_RTOL}); the recorded program's captured launches "
            f"forward {cap}, backward {bwd}; device ms fused "
            f"{ {k: round(v, 4) for k, v in ms1.items()} } against unfused "
            f"{ {k: round(v, 4) for k, v in ms0.items()} }; card {smi_line}")
        check(f_err <= FLASH_TOL and max(g_err) <= GRAD_RTOL,
              f"graph: fused attention differs: {f_err}, {g_err}")
        check(cap.get("flash_fwd") == 1 and bwd.get("flash_bwd_dkv") == 1
              and bwd.get("flash_bwd_dq") == 1,
              f"graph: fused attention launches {cap}, {bwd}")
        check(launched["flash_fwd"] >= 1 and launched["flash_bwd_dq"] >= 1,
              f"graph: the fused path launched {launched}")
    _release()


def _graph_executor(smi_line, taken):
    """(iv) An ``mx.sym`` MLP through ``simple_bind`` on the card,
    ``forward(is_train=True)`` and ``backward``, against the same on the
    CPU."""
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.symbol as sym

    names = list(GRAPH_MLP)
    x, w1, b1, w2, b2 = (sym.var(n) for n in names)
    h = sym.Activation(sym.FullyConnected(x, w1, b1, num_hidden=3072),
                       act_type="relu")
    out = sym.FullyConnected(h, w2, b2, num_hidden=768)
    rs = onp.random.default_rng(SEED + 25)
    vals = {n: (rs.standard_normal(s, dtype="float32") /
                onp.float32(onp.sqrt(s[-1]))) for n, s in GRAPH_MLP.items()}
    got = {}
    for ctx in (mx.cpu(), mx.gpu()):
        ex = out.simple_bind(ctx=ctx, **GRAPH_MLP)
        y = ex.forward(is_train=True, **{
            n: mx.np.array(v, ctx=ctx) for n, v in vals.items()})[0]
        ex.backward(mx.np.ones(y.shape, ctx=ctx))
        got[ctx.device_type] = [y.asnumpy()] + [
            ex.arg_dict[n].grad.asnumpy() for n in names]
    errs = {n: float(abs(a - b).max() / abs(b).max()) for n, a, b in zip(
        ["out"] + names, got["gpu"], got["cpu"])}
    log(f"[graph] (iv) Executor (FullyConnected 768->3072, relu, ->768 at "
        f"batch 64, simple_bind, forward(is_train=True), backward): the "
        f"card against the CPU, max |diff| over each largest entry {errs} "
        f"(limit {GRAPH_EXEC_RTOL}); card {smi_line}")
    check(max(errs.values()) <= GRAPH_EXEC_RTOL,
          f"graph: the Executor on the card differs from the CPU: {errs}")
    _take_counts(taken)


def phase_graph(smi_line):
    """Phase 10: the graph layer on the card. Returns the phase's launch
    counts (the traces, warm calls and captures; replays move none)."""
    import tempfile

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    ck.reset_launch_counts()
    taken = {}
    with tempfile.TemporaryDirectory(prefix="graph-export-") as where:
        _graph_bert(smi_line, taken, where)
        _graph_resnet(smi_line, taken, where)
    _graph_attention(smi_line, taken)
    _graph_executor(smi_line, taken)
    PATH_DTYPES["graph"] = taken
    counts = {k: sum(n for (kern, _), n in taken.items() if kern == k)
              for k in ck.launch_counts()}
    log(f"[graph] kernel launches on the path (traces, warm calls and "
        f"captures; the timing runs left out), by kernel: {counts}")
    check(all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq", "layer_norm")),
          f"graph: a kernel of the path did not launch: {counts}")
    log(f"[graph] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the reference's GPT body, written as a user would, on the card
# ---------------------------------------------------------------------------
SCRIPT_RTOL = {"logits": 1e-6, "loss": 1e-6, "grad": 1e-5}
SCRIPT_STEPS = 10
SCRIPT_LOSS_RATIO = 1.25   # the 10th hybridized loss against phase 4's
SCRIPT_TIMED = 5           # steps timed each way, after two untimed


def _script_module():
    """``tests/torch_script_gpt.py`` (the reference's GPT body with only its
    imports changed), imported by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "torch_script_gpt.py")
    spec = importlib.util.spec_from_file_location("torch_script_gpt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_step(net, trainer, loss_fn, x, y):
    """One reference-style step: ``record()``, the loss, ``backward()``,
    ``trainer.step(B)``; returns the loss (an NDArray)."""
    from mxnet_tpu_torch import autograd

    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def _script_grads(net):
    return {n: p.grad.clone() for n, p in net.collect_params().items()}


def _script_parity(sg, smi_line, path, x, y):
    """(i) the reference's idioms and (ii) parity at dropout 0; returns the
    eager step's launches."""
    import contextlib
    import io

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    loss_fn = SoftmaxCrossEntropyLoss()
    # -- (i) the idioms ------------------------------------------------------
    with mx.cpu():
        net = sg.ScriptGPT(dropout=0.0)
    net.initialize(mx.initializer.Normal(0.02), ctx=mx.gpu())
    params = net.collect_params()
    check(all(p.device.type == "cuda" for p in params.values()),
          "(i) initialize(ctx=mx.gpu()) left a parameter off the card")
    net.load_parameters(path, ctx=mx.gpu())
    weights = net.collect_params(".*weight")
    check(len(weights) == 50, f"(i) collect_params('.*weight') has "
          f"{len(weights)} entries, not 50")
    emb = params["tok_embed.weight"]
    nd = emb.data()
    check(isinstance(nd, mx.nd.NDArray) and
          nd._data.data_ptr() == emb.data_ptr(),
          "(i) p.data() is not an NDArray over the parameter")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        net.summary(x)
    lines = out.getvalue().splitlines()
    check(len(lines) == len(params) + 2, f"(i) summary printed {len(lines)}"
          f" lines for {len(params)} parameters")

    # -- (ii) parity: the script model eager, the port's gpt2_small, the
    # script model hybridized (the second call and backward: replays) -----
    runs = {}
    before = ck.launch_counts()
    with autograd.record():
        logits = net(x)
        loss = loss_fn(logits, y).mean()
    loss.backward()
    eager_launches = {k: n - before[k] for k, n in ck.launch_counts().items()}
    check(all(torch.equal(p.grad()._data, p.grad) and
              p.grad()._data.data_ptr() == p.grad.data_ptr()
              for p in params.values()),
          "(i) p.grad() differs from torch's .grad after a backward")
    runs["script"] = (logits._data.detach().clone(), loss._data.detach(),
                      _script_grads(net))
    del logits, loss
    port = gpt2_small(dropout=0.0)
    port.load_parameters(path)
    with autograd.record():
        logits = port(x._data)
        loss = loss_fn(logits, y._data).mean()
    autograd.backward(loss)
    runs["gpt2_small"] = (logits.detach().clone(), loss.detach(),
                          _script_grads(port))
    del port, logits, loss
    _release()
    net.hybridize()
    for _ in range(2):
        with autograd.record():
            logits = net(x)
            loss = loss_fn(logits, y).mean()
        loss.backward()
    (cop, _, _), = net._cached.values()
    prog = next(iter(cop._recorded.values()))
    check(cop._captures == 1 and cop._backward_captures == 1 and
          prog.replays == 1 and prog.backward_replays == 1,
          f"(ii) hybridized: captures {cop._captures} forward, "
          f"{cop._backward_captures} backward, replays {prog.replays} / "
          f"{prog.backward_replays}")
    runs["hybridized"] = (logits._data.detach().clone(),
                          loss._data.detach(), _script_grads(net))
    del logits, loss, cop, prog
    ref_logits, ref_loss, ref_grads = runs["script"]
    for tag in ("gpt2_small", "hybridized"):
        lg, ls, gs = runs[tag]
        e_logits = _max_rel(lg, ref_logits)
        e_loss = _max_rel(ls, ref_loss)
        worst = max(((_max_rel(gs[n], g), n) for n, g in ref_grads.items()))
        e_tied = _max_rel(gs["tok_embed.weight"], ref_grads["tok_embed.weight"])
        bitwise = torch.equal(lg, ref_logits) and all(
            torch.equal(gs[n], g) for n, g in ref_grads.items())
        log(f"[script] (ii) the script GPT eager against {tag}: logits "
            f"{e_logits:.3g}, loss {e_loss:.3g} (limits "
            f"{SCRIPT_RTOL['logits']}, {SCRIPT_RTOL['loss']}), worst "
            f"gradient {worst[0]:.3g} ({worst[1]}; limit "
            f"{SCRIPT_RTOL['grad']}), tok_embed.weight (two routes) "
            f"{e_tied:.3g}, relative to each largest entry; bitwise "
            f"{bitwise}; card {smi_line}")
        check(e_logits <= SCRIPT_RTOL["logits"] and
              e_loss <= SCRIPT_RTOL["loss"] and
              worst[0] <= SCRIPT_RTOL["grad"],
              f"(ii) the script GPT against {tag}: logits {e_logits:.3g}, "
              f"loss {e_loss:.3g}, gradient {worst}")
    check(float(ref_grads["tok_embed.weight"].abs().max()) > 0,
          "(ii) tok_embed.weight's gradient is zero")
    log(f"[script] (i) initialize(Normal(0.02), ctx=mx.gpu()) placed all "
        f"{len(params)} parameters on the card, load_parameters(ctx=gpu) "
        f"read phase 4's weights, collect_params('.*weight') has "
        f"{len(weights)}, p.data() shares the parameter's memory, p.grad() "
        f"equals .grad after a backward, summary(): {lines[-1].strip()}")
    del net, runs, ref_grads
    _release()
    return eager_launches


def _script_train(sg, smi_line, path, batches, phase4_losses):
    """(iii) ten hybridized AdamW steps at dropout 0.1 on phase 4's
    batches, (iv) the launches, and the eager and hybridized step times."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    loss_fn = SoftmaxCrossEntropyLoss()
    nets = {}
    for hybrid in (True, False):
        net = sg.ScriptGPT(dropout=0.1)
        net.load_parameters(path, ctx=mx.gpu())
        if hybrid:
            net.hybridize()
        nets[hybrid] = (net, make_trainer(net))
    data = [(mx.np.array(x, ctx=mx.gpu()), mx.np.array(y, ctx=mx.gpu()))
            for x, y in batches[:SCRIPT_STEPS]]
    net, trainer = nets[True]
    mxrandom.seed(SEED)
    before = ck.launch_counts()
    losses, ms = [], []
    for x, y in data:
        t0 = time.perf_counter()
        loss = _script_step(net, trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.mean().asnumpy()))
    after = ck.launch_counts()
    moved = {k: after[k] - before[k] for k in after}
    (cop, _, _), = net._cached.values()
    prog = next(iter(cop._recorded.values()))
    fwd = prog.captured_launches or {}     # None off the card
    bwd = prog.backward_launches or {}
    captured = {k: fwd.get(k, 0) + bwd.get(k, 0) for k in TRAIN_WANT}
    ran = {k: moved[k] // 2 + prog.replays * fwd.get(k, 0) +
           prog.backward_replays * bwd.get(k, 0) for k in TRAIN_WANT}
    log(f"[script] (iii) ScriptGPT hybridized, dropout 0.1, AdamW as phase "
        f"4 ({SCRIPT_STEPS} steps of phase 4's batches): loss by step "
        f"{[round(v, 4) for v in losses]}; phase 4 at step {SCRIPT_STEPS}: "
        f"{phase4_losses[SCRIPT_STEPS - 1]:.4f}")
    log(f"[script] (iv) captures {cop._captures} forward, "
        f"{cop._backward_captures} backward; captured launches forward "
        f"{fwd}, backward {bwd}; replays {prog.replays} / "
        f"{prog.backward_replays}; counters moved {moved} (the warm call "
        f"and the capture); launches run {ran}")
    check(all(onp.isfinite(losses)), "(iii) a loss is not finite")
    check(losses[-1] < losses[0], f"(iii) the loss did not fall: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    check(losses[-1] <= SCRIPT_LOSS_RATIO * phase4_losses[SCRIPT_STEPS - 1],
          f"(iii) the last loss {losses[-1]:.4f} is above "
          f"{SCRIPT_LOSS_RATIO} x phase 4's {phase4_losses[SCRIPT_STEPS - 1]:.4f}")
    check(len(net._cached) == 1 and cop._captures == 1 and
          cop._backward_captures == 1,
          f"(iii) captures: {len(net._cached)} programs, "
          f"{cop._captures} forward, {cop._backward_captures} backward")
    check(captured == TRAIN_WANT and
          prog.replays == prog.backward_replays == SCRIPT_STEPS - 1 and
          all(moved[k] == 2 * TRAIN_WANT[k] for k in TRAIN_WANT) and
          all(ran[k] == SCRIPT_STEPS * TRAIN_WANT[k] for k in TRAIN_WANT),
          f"(iv) captured launches {captured} against {TRAIN_WANT}, "
          f"replays {prog.replays} / {prog.backward_replays}, moved {moved}")
    del cop, prog

    timings = {}
    x, y = data[-1]
    for hybrid in (False, True):
        net, trainer = nets[hybrid]

        def step():
            _script_step(net, trainer, loss_fn, x, y)

        for _ in range(2):
            step()
        wall = _wall_ms(step, SCRIPT_TIMED)
        busy, kernels, _ = _profile(step, reps=3)
        timings[hybrid] = (wall, busy, kernels, max(0.0, 1 - busy / wall))
    B, T = batches[0][0].shape
    for hybrid, name in ((False, "eager"), (True, "hybridized")):
        wall, busy, kernels, idle = timings[hybrid]
        log(f"[script] {name} step (record, backward, Trainer.step) at "
            f"B={B}, T={T}, fp32: wall {wall:.3f} ms (median of "
            f"{SCRIPT_TIMED}), busy {busy:.3f} ms, {kernels:.0f} kernels, "
            f"idle share {idle:.3f}, {B * T / wall * 1e3:.0f} training "
            f"tokens/s; the ten hybridized steps' median {statistics.median(ms[2:]):.3f} ms"
            f" (first two {ms[0]:.1f}, {ms[1]:.1f}); card {smi_line}")
    del nets, data
    _release()
    return timings


def _script_c5_c4(smi_line):
    """(v) a hybridized body with a host constant, captured once; (vi) the
    C4 body eager and hybridized under ``record()``, against the CPU."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx  # noqa: F401

    class Masked(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = gluon.nn.Dense(768, in_units=768, flatten=False)

        def forward(self, x, mask):
            return mnp.where(mask, self.fc(x),
                             mnp.array(-1e30, dtype="float32"))

    rng = onp.random.RandomState(SEED + 11)
    xs = rng.randn(4, 1024, 768).astype("float32")
    mask = rng.rand(4, 1024, 768) < 0.75
    net = Masked()
    net.initialize(seed=11)
    x, m = mx.np.array(xs), mx.np.array(mask)
    eager = net(x, m)._data.clone()
    net.hybridize()
    outs = [net(x, m)._data.clone() for _ in range(3)]
    (cop, _, _), = net._cached.values()
    stats = cop.graph_stats()[0]
    same = all(torch.equal(o, eager) for o in outs)
    log(f"[script] (v) a hybridized body building mx.np.array(-1e30): "
        f"{cop._captures} capture, {stats['replays']} replays, replays "
        f"equal to the eager output: {same}; host constants kept "
        f"{len(cop._gpool.consts)}")
    check(cop._captures == 1 and stats["replays"] == 3 and same,
          f"(v) captures {cop._captures}, replays {stats['replays']}, "
          f"equal {same}")

    class C4(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = gluon.nn.Dense(3, in_units=4)

        def forward(self, x):
            return mnp.tanh(self.fc(x))

    xs = rng.randn(2, 4).astype("float32")
    results = {}
    for where, hybrid in (("cpu", False), ("cuda", False), ("cuda", True)):
        with (mx.cpu() if where == "cpu" else mx.gpu()):
            net = C4()
            net.initialize(seed=4)
            if hybrid:
                net.hybridize()
            for _ in range(2):     # the second call replays on the card
                x = mx.np.array(xs)
                x.attach_grad()
                with autograd.record():
                    y = net(x).sum()
                y.backward()
            results[(where, hybrid)] = (x.grad._data.cpu(),
                                        net.fc.weight.grad()._data.cpu())
    want = results[("cpu", False)]
    errs = {k: max(_max_rel(g, w) for g, w in zip(v, want))
            for k, v in results.items()}
    nonzero = all(float(g.abs().max()) > 0 for v in results.values()
                  for g in v)
    log(f"[script] (vi) mx.np.tanh(Dense(x)) under record(): x and weight "
        f"gradients against the CPU's, relative to each largest entry: "
        f"eager {errs[('cuda', False)]:.3g}, hybridized "
        f"{errs[('cuda', True)]:.3g}; nonzero {nonzero}; card {smi_line}")
    check(nonzero and errs[("cuda", False)] <= 1e-6 and
          errs[("cuda", True)] <= 1e-6,
          f"(vi) C4 gradients: {errs}, nonzero {nonzero}")


def phase_script(smi_line, arrays, batches, phase4_losses):
    """Phase 11: the reference's GPT body, written as a user would
    (``tests/torch_script_gpt.py``), at GPT-2 small's full width and depth
    (see the module docstring). Returns the phase's launch counts."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    sg = _script_module()
    ck.reset_launch_counts()
    x0, y0 = batches[0]
    with tempfile.TemporaryDirectory(prefix="script-") as where:
        path = os.path.join(where, "gpt2_small.params")
        with open(path, "wb") as fh:
            onp.savez(fh, **arrays)
        eager = _script_parity(sg, smi_line, path,
                               mx.np.array(x0, ctx=mx.gpu()),
                               mx.np.array(y0, ctx=mx.gpu()))
        log(f"[script] (iv) launches of one eager step (record, backward): "
            f"{eager}")
        check(eager == TRAIN_WANT, f"(iv) an eager step launched {eager}, "
              f"not {TRAIN_WANT}")
        _script_train(sg, smi_line, path, batches, phase4_losses)
    _script_c5_c4(smi_line)
    check_default_tiles("script")
    counts = read_counts("script")
    log(f"[script] kernel launches on the path: {counts}")
    check(all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq", "layer_norm")),
          f"script: a kernel of the path did not launch: {counts}")
    log(f"[script] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the optimizers (LAMB through the Learner, the Trainer's
# nineteen), the norms, ReflectionPad2D and the losses
# ---------------------------------------------------------------------------
OPTIM_LR = 1e-4                 # (i) LAMB(1e-4, wd 0.01) in the bench
OPTIM_CHECK_BATCH = 2           # (ii) BERT-Base fp32 batch
OPTIM_MOMENT_RTOL = 1e-6        # (ii) LAMB moments, card against CPU
OPTIM_WEIGHT_ULPS = 2.0         # (ii) LAMB's updated weights: within 2 x
OPTIM_RATIO_RTOL = 1e-6         # (fp32 ulp of the larger of the weight
#   before and after + 1e-6 of the entry's update). The ulp is the sum's
#   rounding; 1e-6 the card's float32 tree norm of 2.4 M values against
#   the CPU's float64 one, which moves the trust ratio
OPTIM_SHAPES = {"word_embed.weight": (30522, 1024),
                "ffn_1.weight": (4096, 1024), "ffn_2.weight": (1024, 4096),
                "ffn_2.bias": (1024,), "ln.gamma": (1024,)}
OPTIM_STEPS = 3
OPTIM_WHOLE = ("lamb", "lans", "lars")  # (iii) norms of whole tensors
OPTIM_ROW_STRIDE = 16           # (iii) the CPU holds every 16th row of the
#   others: their recurrences are elementwise (GroupAdaGrad's row-wise), so
#   a row's trajectory is its own, and the CPU's seconds drop 16-fold
OPTIM_RTOL = 1e-5               # (iii) fp32 weights, masters and states
OPTIM_BF16_RTOL = 2.0 ** -7     # (iii) bf16 weights: one bf16 rounding
NORM_RTOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -6)}
LOSS_RTOL = 1e-5                # (iv) losses and gradients, fp32; but
LOSS_RTOL_OF = {"CTCLoss": 2e-4,   # T = 400 log-space steps: T eps x 4
                "SDMLLoss": 5e-4}  # logits: ~2e3 squared distances, whose
#   float32 ulp (1.2e-4) moves the softmax
NORM_SHAPES = {"group": (32, 256, 56, 56),      # ResNet stage 2, 103 MB
               "image": (8, 64, 256, 256),      # a style generator's input
               "rms": (8 * 1024, 4096)}         # a 7B-class decoder's rows
LOSS_SHAPE = (1024, 1000)
CTC_SHAPE = dict(T=400, B=32, V=29, L=100)
_OPTIM_KINDS = (("trust-ratio norms (foreach LpNorm)", ("lpnorm",)),
                ("other multi-tensor passes (foreach)",
                 ("multi_tensor_apply",)),
                ("GEMMs", ("gemm", "cutlass", "sm90_", "xmma", "cublas")),
                ("flash and LayerNorm (port kernels)", ("flash", "ln_",
                                                        "layer_norm")))


def _by_kind(by_name, reps=3):
    kinds = {}
    for name, us in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in _OPTIM_KINDS
                     if any(w in low for w in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / reps / 1e3
    return {k: round(v, 4) for k, v in sorted(kinds.items())}


def _optim_bert_large(smi_line, taken):
    """(i) ``bench_bert_pretrain("large")`` with LAMB in AdamW's place."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    if not BERT_LARGE_ADAMW:       # a partial run: phase 9's Large first
        adamw, learner, peak = _watched_bench("large")
        ck.reset_launch_counts()
        BERT_LARGE_ADAMW.update(_bert_numbers(
            "(i) Large, B=8, remat, AdamW", "large", adamw, learner, peak,
            smi_line))
        del learner
        _release()
    ck.reset_launch_counts()
    lamb, learner, peak = _watched_bench(
        "large", optimizer=mx.optimizer.LAMB(learning_rate=OPTIM_LR,
                                             wd=0.01), probe=True)
    probe = (learner.probe_first, learner.probe_last, learner.probe_steps)
    counts = ck.launch_counts()
    check(all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq", "layer_norm")),
          f"(i) a kernel of the path did not launch: {counts}")
    _take_counts(taken)
    nl = _bert_numbers("(i) Large, B=8, remat, LAMB", "large", lamb,
                       learner, peak, smi_line)
    del learner
    _release()
    aw = BERT_LARGE_ADAMW
    check(nl["launches"] == aw["launches"],
          f"(i) LAMB's launches a step {nl['launches']} != phase 9's "
          f"{aw['launches']}")
    losses = nl["losses"]
    check(all(math.isfinite(v) for v in probe[:2]) and probe[1] < probe[0],
          f"(i) LAMB's float32 loss on the bench's batch did not fall over "
          f"the bench's {probe[2]} steps: {probe}")
    log(f"[optim] (i) BERT-Large pretraining, B=8, T=128, bf16, remat, one "
        f"replay a step: LAMB against AdamW (phase 9, this run): wall "
        f"{nl['wall']:.3f} / {aw['wall']:.3f} ms, busy {nl['busy']:.3f} / "
        f"{aw['busy']:.3f} ms, idle {nl['idle']:.3f} / {aw['idle']:.3f}, "
        f"kernels a step {nl['kernels']:.0f} / {aw['kernels']:.0f}, "
        f"tokens/s {nl['tokens_s']} / {aw['tokens_s']}, MFU {nl['mfu']} / "
        f"{aw['mfu']}, peak {nl['peak'] / 2**20:.0f} / "
        f"{aw['peak'] / 2**20:.0f} MiB; LAMB's bf16 loss {losses[0]:.4f} "
        f"-> {losses[probe[2] - 1]:.4f} over the bench's {probe[2]} steps, "
        f"float32 predict-mode loss on the batch {probe[0]:.6f} -> "
        f"{probe[1]:.6f}; card {smi_line}")
    log(f"[optim] (i) device ms a step by kind, LAMB: "
        f"{_by_kind(nl['by_name'])}; AdamW: {_by_kind(aw['by_name'])}")
    return nl


class _KeepGrads:
    """A ``GradientTransformation`` that keeps copies of the gradients of
    its first update (the warm step), then updates as ``tx`` does."""

    def __init__(self, tx):
        self.tx = tx
        self.grads = None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        if self.grads is None:
            self.grads = [g.detach().clone() for g in grads]
        return self.tx.update(grads, state, params)

    def apply(self, params, updates):
        self.tx.apply(params, updates)


def _optim_lamb_vs_cpu(smi_line, taken):
    """(ii) One fp32 Learner step of BERT-Base with LAMB on the card; the
    same gradients through the port's LAMB chain on the CPU from the same
    parameters and state."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel.learner import GradientTransformation

    rng = onp.random.default_rng(SEED + 17)
    shapes = {n: tuple(p.shape) for n, p in _bert_check_model(
        None, "cpu").collect_params().items()}
    arrays = train_weights(shapes, SEED + 17)
    tokens, labels = _bert_batch(rng, OPTIM_CHECK_BATCH)

    def lamb():
        return mx.optimizer.LAMB(learning_rate=1e-3, wd=0.01)

    class Keep(_KeepGrads, GradientTransformation):
        pass

    with mx.gpu():
        model = _bert_check_model(arrays, DEV)
        keep = Keep(parallel.to_optax(lamb()))
        learner = parallel.Learner(model, _pretrain_loss_fn(), keep)
        loss = float(learner.step(mx.np.array(tokens),
                                  mx.np.array(labels))._data)
        names = learner._param_names
        params = model.collect_params()
        after = {n: params[n].detach().cpu() for n in names}
        adam = learner._opt_state[0]
        mu = [m.detach().cpu() for m in adam["mu"]]
        nu = [v.detach().cpu() for v in adam["nu"]]
        grads = [g.cpu() for g in keep.grads]
    _take_counts(taken)
    del model, learner, params, keep
    _release()
    before = [torch.from_numpy(arrays[n].copy()) for n in names]
    tx = parallel.to_optax(lamb())
    state = tx.init(before)
    with torch.no_grad():
        upd = tx.update([g.clone() for g in grads], state, before)
        want = [p.clone() for p in before]
        tx.apply(want, upd)
    e_mom = max(max(_max_rel(a, b) for a, b in zip(mu, state[0]["mu"])),
                max(_max_rel(a, b) for a, b in zip(nu, state[0]["nu"])))
    e_upd = max(_max_rel(after[n] - b, w - b) for n, b, w in
                zip(names, before, want))
    eps = torch.finfo(torch.float32).eps
    e_ulp = max(float(((after[n] - w).abs() / (
        eps * torch.maximum(w.abs(), b.abs()) +
        OPTIM_RATIO_RTOL * (w - b).abs()).clamp_min(1e-30)).max())
        for n, b, w in zip(names, before, want))
    moved = sum(int(bool((w != b).any())) for b, w in zip(before, want))
    log(f"[optim] (ii) one fp32 Learner step of BERT-Base (B="
        f"{OPTIM_CHECK_BATCH}, dropout 0, loss {loss:.4f}) with LAMB on the "
        f"card, the same gradients through the CPU's LAMB chain: moments "
        f"within {e_mom:.3g} (limit {OPTIM_MOMENT_RTOL}), updated weights "
        f"within {e_ulp:.3g} x (ulp + {OPTIM_RATIO_RTOL} of the update) "
        f"(limit {OPTIM_WEIGHT_ULPS}), updates "
        f"within {e_upd:.3g} of each update's largest entry, {moved} of "
        f"{len(names)} tensors moved; card {smi_line}")
    check(e_mom <= OPTIM_MOMENT_RTOL, f"(ii) LAMB moments off by {e_mom}")
    check(e_ulp <= OPTIM_WEIGHT_ULPS,
          f"(ii) LAMB's weights off by {e_ulp} ulps")
    check(moved == len(names), f"(ii) {len(names) - moved} tensors did "
          "not move")


def _grad_net(weights, grads):
    """A block holding ``weights`` whose output, for a one-hot selector
    ``sel`` of step ``k``, has the gradients ``grads[k]``: the compiled
    step's backward hands it the seeded gradients."""
    from mxnet_tpu_torch import gluon

    class GradNet(gluon.HybridBlock):
        _tensor_body = True

        def __init__(self):
            super().__init__()
            self.names = list(weights)
            for i, w in enumerate(weights.values()):
                setattr(self, f"p{i}", gluon.Parameter(w.clone()))
            self._grads = grads

        def forward(self, sel):
            ps = [getattr(self, f"p{i}") for i in range(len(self.names))]
            total = None
            for k, gk in enumerate(self._grads):
                part = sum((p * g).sum().float() for p, g in zip(ps, gk))
                term = sel[k] * part
                total = term if total is None else total + term
            return total.reshape(1)

    return GradNet()


def _optim_host_data():
    """fp32 weights and OPTIM_STEPS gradient sets from the seed."""
    rng = onp.random.default_rng(SEED + 12)
    weights = {}
    for n, s in OPTIM_SHAPES.items():
        if n.endswith("gamma"):
            weights[n] = 1 + 0.1 * rng.standard_normal(s, dtype="float32")
        else:
            weights[n] = 0.02 * rng.standard_normal(s, dtype="float32")
    grads = [{n: 1e-2 * rng.standard_normal(s, dtype="float32")
              for n, s in OPTIM_SHAPES.items()} for _ in range(OPTIM_STEPS)]
    return weights, grads


def _optim_kw(name, mp):
    kw = dict(learning_rate=1e-2, multi_precision=mp)
    if name != "groupadagrad":
        kw["wd"] = 0.01
    return kw


def _optim_rows(name):
    """The rows (first axis) of each tensor the CPU reference holds."""
    return slice(None) if name in OPTIM_WHOLE else \
        slice(None, None, OPTIM_ROW_STRIDE)


def _optim_cpu(name, mp, weights, grads):
    """The per-parameter update on the CPU over ``_optim_rows(name)``:
    weights and states after OPTIM_STEPS steps."""
    import torch

    from mxnet_tpu_torch import gluon

    dt = torch.bfloat16 if mp else torch.float32
    rows = _optim_rows(name)
    ps = {n: gluon.Parameter(torch.from_numpy(w[rows].copy()).to(dt))
          for n, w in weights.items()}
    tr = gluon.Trainer(ps, name, _optim_kw(name, mp))
    tr._fuse = False
    for gk in grads:
        for n, p in ps.items():
            p.grad = torch.from_numpy(gk[n][rows].copy()).to(dt)
        tr.update(1)
    return [p.detach() for p in ps.values()], tr._states, rows


def _optim_errors(params, states, want):
    """(weights, float32 states, bfloat16 states) against the CPU's, each
    the largest error over its tensor's largest entry (DCASGD keeps its
    previous weight in the weight's dtype)."""
    import torch

    wp, ws, rows = want
    errs = [_max_rel(p[rows], w) for p, w in zip(params, wp)]
    serrs = {torch.float32: [0.0], torch.bfloat16: [0.0]}
    for i, st in enumerate(states):
        for k in st:
            serrs[st[k].dtype].append(_max_rel(st[k][rows], ws[i][k]))
    return max(errs), max(serrs[torch.float32]), max(serrs[torch.bfloat16])


def _optim_card(name, mp, weights, grads_dev, want, smi_line):
    """(iii) One optimizer through the fused Trainer and compile_step on the
    card, each held against the CPU's per-parameter update."""
    import torch

    from mxnet_tpu_torch import gluon

    dt = torch.bfloat16 if mp else torch.float32
    dev_w = {n: torch.from_numpy(w).to(DEV, dt)
             for n, w in weights.items()}
    ps = {n: gluon.Parameter(w.clone()) for n, w in dev_w.items()}
    tr = gluon.Trainer(ps, name, _optim_kw(name, mp))
    t0 = time.perf_counter()
    for gk in grads_dev:
        for p, g in zip(ps.values(), gk):
            p.grad = g
        tr.update(1)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    fused = _optim_errors([p.detach() for p in ps.values()], tr._states,
                          want)
    check(tr._fused_dispatches == OPTIM_STEPS,
          f"(iii) {name}: {tr._fused_dispatches} fused dispatches")
    del ps, tr
    net = _grad_net(dev_w, grads_dev)
    tr = gluon.Trainer(net.collect_params(), name, _optim_kw(name, mp))
    step = tr.compile_step(net, lambda out, y: out)
    check(step.fallback_reason is None,
          f"(iii) {name}: compile_step falls back: {step.fallback_reason}")
    y = torch.zeros(1, device=DEV)
    t0 = time.perf_counter()
    for k in range(OPTIM_STEPS):
        sel = torch.zeros(OPTIM_STEPS, device=DEV)
        sel[k] = 1.0
        step(sel, y)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    progs = list(step._cache.values())
    check(step._traces == 1 and len(progs) == 1 and
          progs[0].graph is not None,
          f"(iii) {name}: {step._traces} programs, captured "
          f"{[p.graph is not None for p in progs]}")
    comp = _optim_errors([p.detach() for p in net.collect_params().values()],
                         tr._states, want)
    del net, tr, step, progs
    _release()
    limit = OPTIM_BF16_RTOL if mp else OPTIM_RTOL
    how = "bf16 + multi_precision" if mp else "fp32"
    log(f"[optim] (iii) {name:12s} {how:22s} fused Trainer: weights "
        f"{fused[0]:.3g}, states {fused[1]:.3g} / {fused[2]:.3g}; "
        f"compile_step (1 capture): weights {comp[0]:.3g}, states "
        f"{comp[1]:.3g} / {comp[2]:.3g} (fp32 / bf16 states; limits "
        f"{limit:.3g}, {OPTIM_RTOL:.3g} / {OPTIM_BF16_RTOL:.3g}); seconds "
        f"{t_fused:.2f} / {t_comp:.2f}")
    check(fused[0] <= limit and comp[0] <= limit,
          f"(iii) {name}: weights off the CPU's by {fused[0]} / {comp[0]}")
    check(max(fused[1], comp[1]) <= OPTIM_RTOL and
          max(fused[2], comp[2]) <= OPTIM_BF16_RTOL,
          f"(iii) {name}: states off the CPU's by {fused[1:]} / {comp[1:]}")


def _optim_sgld(weights, grads_dev, smi_line):
    """(iii) SGLD: the noise's mean and variance; its compiled step takes
    the reference's fallback."""
    import warnings

    import torch

    from mxnet_tpu_torch import gluon

    lr, wd = 1e-2, 0.01
    ps = {n: gluon.Parameter(torch.from_numpy(w).to(DEV))
          for n, w in weights.items()}
    tr = gluon.Trainer(ps, "sgld", dict(learning_rate=lr, wd=wd))
    before = [p.detach().clone() for p in ps.values()]
    for p, g in zip(ps.values(), grads_dev[0]):
        p.grad = g
    tr.update(1)
    noise = torch.cat([(p.detach() - b + lr / 2 * (g + wd * b)).reshape(-1)
                       for p, b, g in zip(ps.values(), before,
                                          grads_dev[0])]).double()
    n = noise.numel()
    mean, var = float(noise.mean()), float(noise.var())
    log(f"[optim] (iii) sgld: noise over {n} values mean {mean:.3g} (4 "
        f"sigma {4 * math.sqrt(lr / n):.3g}), variance / lr {var / lr:.6f} "
        f"(4 sigma {4 * math.sqrt(2 / n):.3g}); card {smi_line}")
    check(abs(mean) < 4 * math.sqrt(lr / n), f"(iii) sgld noise mean {mean}")
    check(abs(var / lr - 1) < 4 * math.sqrt(2 / n),
          f"(iii) sgld noise variance {var} for lr {lr}")
    del ps, tr, before, noise
    net = _grad_net({n: torch.from_numpy(w).to(DEV) for n, w in
                     weights.items()}, grads_dev)
    tr = gluon.Trainer(net.collect_params(), "sgld", dict(learning_rate=lr))
    step = tr.compile_step(net, lambda out, y: out)
    check(step.fallback_reason is not None and
          "SGLD" in step.fallback_reason,
          f"(iii) sgld compile_step: fallback {step.fallback_reason!r}")
    sel = torch.zeros(OPTIM_STEPS, device=DEV)
    sel[0] = 1.0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        step(sel, torch.zeros(1, device=DEV))
    check(step._traces == 0 and any("falling back" in str(r.message)
                                    for r in rec),
          "(iii) sgld compile_step did not take the eager fallback")
    del net, tr, step
    _release()


def _optim_trainer(smi_line):
    """(iii) The nineteen registered optimizers on BERT-Large-shaped
    parameters; the CPU's references over ``_optim_rows``."""
    import torch

    import mxnet_tpu_torch as mx

    weights, grads = _optim_host_data()
    names = sorted(mx.optimizer.optimizer._registry)
    t0 = time.perf_counter()
    cpu_s = 0.0
    for mp in (False, True):
        dt = torch.bfloat16 if mp else torch.float32
        grads_dev = [[torch.from_numpy(gk[n]).to(DEV, dt)
                      for n in OPTIM_SHAPES] for gk in grads]
        if not mp:
            _optim_sgld(weights, grads_dev, smi_line)
        for name in names:
            opt = mx.optimizer.create(name, learning_rate=1e-2)
            if opt.fused_step is None or (mp and not opt.fused_step[3]):
                continue        # SGLD above; bf16 for elementwise ones
            tc = time.perf_counter()
            want = _optim_cpu(name, mp, weights, grads)
            cpu_s += time.perf_counter() - tc
            _optim_card(name, mp, weights, grads_dev, want, smi_line)
        del grads_dev
        _release()
    log(f"[optim] (iii) {len(names)} optimizers in "
        f"{time.perf_counter() - t0:.1f} s ({cpu_s:.1f} s of it the CPU's "
        f"references)")


def _norm_case(tag, make, shape, dtype, arrays=None):
    """Forward and the input's gradient of ``make()`` on the card and on
    the CPU from the same input, parameters and upstream gradient."""
    import torch

    import mxnet_tpu_torch as mx

    rng = onp.random.default_rng(SEED + 121)
    x = rng.standard_normal(shape, dtype="float32")
    outs, t_dev, g = [], None, None
    for dev in (DEV, "cpu"):
        with (mx.gpu() if dev == DEV else mx.cpu()):
            net = make()
            net.initialize()
            xt = torch.from_numpy(x).to(dev, dtype).requires_grad_(True)
            y = net(xt)             # fills the deferred shapes
            if arrays is None:
                arrays = {n: (1 + 0.1 * rng.standard_normal(p.shape,
                                                            dtype="float32"))
                          for n, p in net.collect_params().items()}
                arrays = {n: a if "gamma" in n else a - 1
                          for n, a in arrays.items()}
            if g is None:
                g = rng.standard_normal(tuple(y.shape), dtype="float32")
            net.load_dict(arrays)
            t = time.perf_counter()
            y = net(xt)
            (y * torch.from_numpy(g).to(dev, y.dtype)).sum().backward()
            if dev == DEV:
                torch.cuda.synchronize()
                t_dev = time.perf_counter() - t
            outs.append((y.detach().float().cpu(), xt.grad.float().cpu()))
        del net, xt, y
    fwd, bwd = (_max_rel(a, b) for a, b in zip(*outs))
    tol = NORM_RTOL[str(dtype).replace("torch.", "")]
    log(f"[optim] (iv) {tag} {tuple(shape)} {str(dtype)[6:]}: forward "
        f"{fwd:.3g}, input gradient {bwd:.3g} of each largest entry (limits "
        f"{tol[0]:.3g} / {tol[1]:.3g}); card s {t_dev:.3f}")
    check(fwd <= tol[0] and bwd <= tol[1],
          f"(iv) {tag} {dtype}: card against CPU {fwd} / {bwd}")


def _loss_cases():
    """The fourteen losses at (1024, 1000): (name, class, kwargs, inputs,
    call kwargs); CTC at T = 400, B = 32, V = 29 with labels up to 100 and
    an infeasible row."""
    rng = onp.random.default_rng(SEED + 122)
    n, c = LOSS_SHAPE

    def f(a):
        return onp.asarray(a, dtype="float32")

    pred = f(rng.standard_normal((n, c)))
    target = f(rng.standard_normal((n, c)))
    binary = f(rng.integers(0, 2, (n, c)))
    dist = onp.exp(target) / onp.exp(target).sum(-1, keepdims=True)
    cls = f(rng.integers(0, c, (n,)))
    T, B, V, L = (CTC_SHAPE[k] for k in ("T", "B", "V", "L"))
    ctc = f(rng.standard_normal((B, T, V)))
    lens = rng.integers(L // 5, L + 1, B)
    label = onp.full((B, L), -1.0, "float32")
    for b in range(B):
        label[b, :lens[b]] = rng.integers(0, V - 1, lens[b])
    label[0, :] = 1.0               # 100 repeats need 199 frames ...
    plen = f(onp.full(B, T))
    plen[0] = L + L // 2            # ... and get 150: infeasible
    lens[0] = L
    return [
        ("L2Loss", {}, [pred, target], {}),
        ("L1Loss", {}, [pred, target], {}),
        ("HuberLoss", {"rho": 0.5}, [pred, target], {}),
        ("SigmoidBCELoss", {}, [pred, binary], {}),
        ("SoftmaxCELoss", {}, [pred, cls], {}),
        ("KLDivLoss", {"from_logits": False}, [pred, f(dist)], {}),
        ("CTCLoss", {}, [ctc, label], {"pred_lengths": plen,
                                       "label_lengths": f(lens)}),
        ("HingeLoss", {}, [pred, 2 * binary - 1], {}),
        ("SquaredHingeLoss", {}, [pred, 2 * binary - 1], {}),
        ("LogisticLoss", {}, [pred, 2 * binary - 1], {}),
        ("TripletLoss", {}, [pred, target, f(rng.standard_normal((n, c)))],
         {}),
        ("CosineEmbeddingLoss", {}, [pred, target,
                                     f(2 * rng.integers(0, 2, n) - 1)], {}),
        ("PoissonNLLLoss", {}, [pred, f(abs(target))], {}),
        ("SDMLLoss", {}, [pred, target], {}),
    ]


def _optim_losses(smi_line):
    """(iv) Each loss and its first input's gradient, card against CPU."""
    import torch

    from mxnet_tpu_torch.gluon import loss as gloss

    worst = {}
    for name, kw, inputs, call in _loss_cases():
        outs = []
        for dev in (DEV, "cpu"):
            ts = [torch.from_numpy(a).to(dev) for a in inputs]
            ts[0].requires_grad_(True)
            out = getattr(gloss, name)(**kw)(
                *ts, **{k: torch.from_numpy(v).to(dev)
                        for k, v in call.items()})
            out.sum().backward()
            outs.append((out.detach().cpu(), ts[0].grad.cpu()))
        errs = [_max_rel(a, b) for a, b in zip(*outs)]
        worst[name] = max(errs)
        if name == "CTCLoss":
            ctc = outs[0][0]
            check(bool(torch.isfinite(ctc).all()) and float(ctc[0]) > 1e4 >
                  float(ctc[1:].max()),
                  f"(iv) CTC: infeasible row {float(ctc[0])}, others up to "
                  f"{float(ctc[1:].max())}")
            log(f"[optim] (iv) CTC T={CTC_SHAPE['T']}, B={CTC_SHAPE['B']}, "
                f"V={CTC_SHAPE['V']}, labels up to {CTC_SHAPE['L']}: the "
                f"infeasible row's loss {float(ctc[0]):.1f} (finite), the "
                f"others {float(ctc[1:].min()):.2f}-{float(ctc[1:].max()):.2f}")
    log(f"[optim] (iv) losses at {LOSS_SHAPE}, card against CPU, loss and "
        f"gradient over each largest entry (limit {LOSS_RTOL}, "
        f"{LOSS_RTOL_OF}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; card {smi_line}")
    check(all(v <= LOSS_RTOL_OF.get(k, LOSS_RTOL)
              for k, v in worst.items()),
          f"(iv) losses against the CPU: {worst}")


def phase_optim(smi_line):
    """Phase 12: LAMB through ``parallel.Learner`` at BERT-Large, LAMB's
    update card against CPU, the Trainer's optimizers fused and compiled,
    and the norms, padding and losses card against CPU; returns the path's
    launch counts ((i)'s bench and (ii)'s step: warm steps and captures)."""
    import torch

    from mxnet_tpu_torch import gluon

    t_phase = time.perf_counter()
    taken = {}
    _optim_bert_large(smi_line, taken)
    _optim_lamb_vs_cpu(smi_line, taken)
    _optim_trainer(smi_line)
    nn = gluon.nn
    for dt in (torch.float32, torch.bfloat16):
        _norm_case("GroupNorm(32)", lambda: nn.GroupNorm(32),
                   NORM_SHAPES["group"], dt)
        _norm_case("InstanceNorm", lambda: nn.InstanceNorm(),
                   NORM_SHAPES["image"], dt)
        _norm_case("ReflectionPad2D(3)", lambda: nn.ReflectionPad2D(3),
                   NORM_SHAPES["image"], dt, arrays={})
        _norm_case("RMSNorm", lambda: nn.RMSNorm(), NORM_SHAPES["rms"], dt)
        _release()
    _optim_losses(smi_line)
    _release()
    PATH_DTYPES["optim"] = taken
    log(f"[optim] kernel launches on the path ((i)'s bench and (ii)'s step: "
        f"warm steps and captures), by dtypes: {taken}")
    log(f"[optim] phase took {time.perf_counter() - t_phase:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 13: the input pipeline (gluon.data, metric, callback, io)
# ---------------------------------------------------------------------------
DATA_BATCHES = 34          # (ii) batches of TRAIN_SHAPE: 8 groups of 4 + 2
DATA_K = 4                 # (ii) steps a group (compile_multi_step)
DATA_VAL_BATCHES = 4       # (ii) Perplexity's validation loader
DATA_WORKERS = 4           # (ii), (iii) spawned workers / threads
DATA_TIMED_GROUPS = 4      # (ii) groups a timed run, A B B A
MNIST_EPOCHS = 2           # (i) examples/gluon_mnist.py's body
MNIST_MIN_ACC = 0.9
MNIST_NORM = (0.13, 0.31)  # (iii) the transform pipeline's Normalize
PPL_REPS = 3               # (iii) Perplexity.update against .asnumpy()
DATA_RATE_EPOCHS = 3       # (iii) epochs a loader rate, after a first
DATA_WANT = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "layer_norm")


class _WorkerProbe:
    """Sample i: what the process that loads it reports about itself (pid,
    CUDA initialised, CUDA_VISIBLE_DEVICES, devices torch sees, kernel
    libraries loaded or built, the device an NDArray made there lands on,
    the wall clock when it answered). Each call waits (up to 120 s) until
    ``workers`` processes have checked in under ``where``, so every worker
    of the pool answers. At module level, so spawned workers unpickle it by
    re-importing this script."""

    def __init__(self, n, where, workers):
        self.n, self.where, self.workers = n, where, workers

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import torch

        from mxnet_tpu_torch import np as mnp
        from mxnet_tpu_torch.ops import _build

        t = time.time()
        open(os.path.join(self.where, str(os.getpid())), "w").close()
        deadline = time.time() + 120
        while len(os.listdir(self.where)) < self.workers and \
                time.time() < deadline:
            time.sleep(0.01)
        where = str(mnp.zeros((1,))._data.device)
        return (os.getpid(), bool(torch.cuda.is_initialized()),
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(),
                len(_build._funcs) + len(_build.build_log), where, t)


def _shm_segments():
    """POSIX shared-memory segments Python's ``shared_memory`` made."""
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    except FileNotFoundError:
        return set()


def _tests_script(name):
    """``tests/{name}.py`` (a JAX package example with its imports changed,
    or a helper of the tests), imported by name with ``tests/`` on the
    path, so spawned workers can import it too (to unpickle a
    ``transform``)."""
    import importlib

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def _gpu_trace(fn, calls=None):
    """Run ``fn`` under ``torch.profiler`` and return its device events from
    the Chrome trace: (category, name, stream, start us, duration us,
    bytes). With a dict ``calls``, also count the host's launch calls into
    it by runtime or driver function name (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="trace-") as where:
        path = os.path.join(where, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = []
    for e in events:
        cat = e.get("cat", "")
        if calls is not None and cat in ("cuda_runtime", "cuda_driver") \
                and "Launch" in e.get("name", ""):
            calls[e["name"]] = calls.get(e["name"], 0) + 1
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            args = e.get("args", {})
            out.append((cat, e.get("name", ""), args.get("stream"),
                        float(e["ts"]), float(e["dur"]),
                        int(args.get("bytes", 0) or 0)))
    return out


def _busy_us(events):
    """Time the device was doing anything: the union of the events'
    intervals (copies on the staging stream may overlap kernels)."""
    spans = sorted((ts, ts + dur) for _, _, _, ts, dur, _ in events)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


def _h2d_overlap(events):
    """Host-to-device copies: their streams, bytes, and the share of their
    time that overlaps a kernel running on another stream."""
    copies = [e for e in events if e[0] == "gpu_memcpy" and "HtoD" in e[1]]
    kernels = [e for e in events if e[0] == "kernel"]
    streams = sorted({e[2] for e in copies}, key=str)
    total = sum(e[4] for e in copies)
    over = 0.0
    for _, _, s, ts, dur, _ in copies:
        hits = [(max(ts, k[3]), min(ts + dur, k[3] + k[4])) for k in kernels
                if k[2] != s and k[3] < ts + dur and k[3] + k[4] > ts]
        end = ts
        for lo, hi in sorted(hits):
            if hi > end:
                over += hi - max(lo, end)
                end = hi
    return {"copies": len(copies), "streams": streams,
            "bytes": sum(e[5] for e in copies), "us": total,
            "overlap_share": over / total if total else 0.0}


def _data_mnist(smi_line):
    """(i) examples/gluon_mnist.py's body on the card."""
    import functools
    import tempfile

    sm = _tests_script("torch_script_mnist")
    t0 = time.perf_counter()
    mnist = sm.MNIST
    with tempfile.TemporaryDirectory(prefix="mnist-") as where:
        # the script's datasets read their files (none: the synthetic
        # sets) from inside the run's temporary directory
        sm.MNIST = functools.partial(mnist, root=where)
        try:
            hist = sm.main(["--epochs", str(MNIST_EPOCHS), "--params",
                            os.path.join(where, "mnist_mlp.params.npz")])
        finally:
            sm.MNIST = mnist
    secs = time.perf_counter() - t0
    losses = [h[0] for h in hist]
    accs = [h[1] for h in hist]
    log(f"[data] (i) examples/gluon_mnist.py (imports changed, mx.gpu()): "
        f"synthetic MNIST 8192 / 1024, DataLoader(num_workers=2) spawned, "
        f"hybridized MLP, adam, metric.Accuracy: loss by epoch "
        f"{[round(v, 4) for v in losses]}, validation accuracy "
        f"{[round(v, 4) for v in accs]}, epochs "
        f"{[round(h[2], 2) for h in hist]} s ({secs:.1f} s with the "
        f"workers' start); card {smi_line}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"(i) the MNIST loss did not fall: {losses}")
    check(accs[-1] >= MNIST_MIN_ACC,
          f"(i) validation accuracy {accs[-1]:.4f} < {MNIST_MIN_ACC}")


def _token_windows(rng, n):
    """``n`` windows of TRAIN_SHAPE's T tokens on phase 4's cyclic task
    (one cycle, each window from its own offset), and their shifted
    targets."""
    (x, y), = cyclic_batches(rng, 50257, n, TRAIN_SHAPE[1], 1)
    return x, y


def _data_trainer(model):
    from mxnet_tpu_torch.gluon import Trainer

    return Trainer(model.collect_params(), "adamw",
                   {"learning_rate": TRAIN_LR, "beta2": 0.95, "wd": 0.01})


@contextlib.contextmanager
def _logged(name, prefix):
    """Print what logger ``name`` reports at INFO, each line after
    ``prefix``, while the block runs."""
    import logging

    logger = logging.getLogger(name)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(prefix + "%(message)s"))
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _data_gpt(smi_line):
    """(ii) GPT-2 small trained through a DataLoader with spawned workers,
    the DevicePrefetcher and compile_multi_step; returns the launches of
    the path (its warm step, capture and the Perplexity forwards), by
    dtypes, and what (iii) and (iv) reuse."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import callback, metric
    from mxnet_tpu_torch import model as mxmodel
    from mxnet_tpu_torch.gluon.data import (ArrayDataset, DataLoader,
                                            RandomSampler)
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, T = TRAIN_SHAPE
    n = DATA_BATCHES * B
    rng = onp.random.RandomState(SEED + 13)
    x, y = _token_windows(rng, n + DATA_VAL_BATCHES * B)
    x, vx, y, vy = x[:n], x[n:], y[:n], y[n:]
    data = ArrayDataset(x, y)
    model, arrays = _train_model(None, 0.0)
    twin, _ = _train_model(arrays, 0.0)
    loss_fn = SoftmaxCrossEntropyLoss()
    step = _data_trainer(model).compile_step(model, loss_fn) \
        .compile_multi_step(DATA_K)
    twin_step = _data_trainer(twin).compile_step(twin, loss_fn) \
        .compile_multi_step(DATA_K)
    loader = DataLoader(data, batch_size=B, sampler=RandomSampler(n,
                                                                  rng=SEED),
                        num_workers=DATA_WORKERS, pin_memory=True)
    losses, window, total = [], metric.Loss(), metric.Loss()
    speed = callback.Speedometer(B, frequent=DATA_K, sync=True)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with _logged("mxnet_tpu_torch", "[data] (ii) Speedometer: "):
        for g, (xs, ys) in enumerate(loader.device_prefetch(DATA_K)):
            out = step(xs, ys)
            losses.append(out)
            total.update(None, out)
            window.update(None, out)
            speed(mxmodel.BatchEndParam(0, g * DATA_K, window))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    ppl = metric.Perplexity()
    val = DataLoader(ArrayDataset(vx, vy), batch_size=B)
    for xv, yv in val:
        ppl.update(yv, mx.npx.softmax(model(xv)))
    probs = mx.npx.softmax(model(xv))
    counts = read_counts("data")
    taken = PATH_DTYPES["data"]
    log(f"[data] (ii) GPT-2 small, fp32, dropout 0, B={B}, T={T}: "
        f"{DATA_BATCHES} batches from DataLoader(batch_size={B}, "
        f"RandomSampler(rng={SEED}), num_workers={DATA_WORKERS} spawned, "
        f"pin_memory=True).device_prefetch({DATA_K}) into "
        f"compile_multi_step({DATA_K}): {len(losses)} groups "
        f"{[tuple(v.shape) for v in losses]}, {step._traces} capture; "
        f"epoch {epoch_s:.2f} s with the workers' start; metric.Loss "
        f"{total.get()[1]:.4f} over {total.num_inst} steps; losses "
        f"{[round(float(v), 4) for g in losses for v in g.asnumpy()][::4]}"
        f" (every 4th); Perplexity on {DATA_VAL_BATCHES} validation "
        f"batches {ppl.get()[1]:.4f}")
    log(f"[data] (ii) kernel launches on the path (the compiled step's warm "
        f"step and capture, {DATA_VAL_BATCHES + 1} predict-mode forwards): "
        f"{counts}")
    check(all(counts[k] > 0 for k in DATA_WANT),
          f"data: a kernel of the path did not launch: {counts}")
    check([tuple(v.shape) for v in losses] ==
          [(DATA_K,)] * (DATA_BATCHES // DATA_K) + [(DATA_BATCHES % DATA_K,)],
          f"(ii) groups {[tuple(v.shape) for v in losses]}")
    check(step._traces == 1, f"(ii) {step._traces} captures, not 1 (a "
          "trailing group replays the one-step program)")
    check(math.isfinite(ppl.get()[1]) and ppl.get()[1] > 1.0,
          f"(ii) perplexity {ppl.get()[1]}")
    check(all(bool(torch.isfinite(v._data).all()) for v in losses),
          "(ii) a loss is not finite")

    # the twin: the same batches by a serial loader, stacked by hand
    serial = list(DataLoader(data, batch_size=B,
                             sampler=RandomSampler(n, rng=SEED)))
    groups = [(torch.stack([b[0]._data for b in serial[i:i + DATA_K]]),
               torch.stack([b[1]._data for b in serial[i:i + DATA_K]]))
              for i in range(0, len(serial), DATA_K)]
    twin_losses = [twin_step(xs, ys) for xs, ys in groups]
    torch.cuda.synchronize()
    same_loss = all(torch.equal(a._data, b)
                    for a, b in zip(losses, twin_losses))
    differ = [name for (name, p), q in zip(model.collect_params().items(),
                                           twin.collect_params().values())
              if not torch.equal(p.detach(), q.detach())]
    log(f"[data] (ii) parity with the hand-fed twin (serial loader, "
        f"torch.stack on the card): losses bitwise {same_loss}, "
        f"{len(differ)} of {len(arrays)} weights differ {differ[:4]}")
    check(same_loss and not differ,
          f"(ii) the prefetcher-fed step is not bitwise equal to its "
          f"hand-fed twin: losses {same_loss}, weights {differ[:4]}")
    del twin, twin_step, twin_losses
    _release()
    _data_timing(smi_line, step, groups, loader)
    return taken, data, loader, yv, probs


def _data_timing(smi_line, step, groups, loader):
    """(ii) the step fed by the prefetcher (A: the first groups of an epoch
    of phase (ii)'s loader, whose workers are up) and from groups staged on
    the card before (B), A B B A in one call; wall, busy and idle a group,
    the top kernels of one profiled group and where the H2D copies ran."""
    import torch

    B = TRAIN_SHAPE[0]
    staged = groups[:DATA_TIMED_GROUPS]

    def fed():
        pf = loader.device_prefetch(DATA_K)
        for g, (xs, ys) in enumerate(pf):
            step(xs, ys)
            if g + 1 == DATA_TIMED_GROUPS:
                break
        pf.close()

    def pre():
        for xs, ys in staged:
            step(xs, ys)

    fed()
    pre()
    torch.cuda.synchronize()
    walls = {"A": [], "B": []}
    for tag in "ABBA":
        t0 = time.perf_counter()
        (fed if tag == "A" else pre)()
        torch.cuda.synchronize()
        walls[tag].append((time.perf_counter() - t0) * 1e3 /
                          DATA_TIMED_GROUPS)
    traces = {"A": _gpu_trace(fed), "B": _gpu_trace(pre)}
    for tag, name in (("A", "fed by the DevicePrefetcher"),
                      ("B", "from groups staged before")):
        wall = statistics.mean(walls[tag])
        busy = _busy_us(traces[tag]) / 1e3 / DATA_TIMED_GROUPS
        log(f"[data] (ii) timing {name}: wall {walls[tag][0]:.3f} / "
            f"{walls[tag][1]:.3f} ms a group of {DATA_K} steps (runs "
            f"{'1, 4' if tag == 'A' else '2, 3'}), busy {busy:.3f} ms, "
            f"idle share {max(0.0, 1 - busy / wall):.4f}, "
            f"{DATA_K * B * TRAIN_SHAPE[1] / wall * 1e3:.0f} training "
            f"tokens/s; card {smi_line}")
    by_name = {}
    for cat, name, _, _, dur, _ in traces["A"]:
        if cat == "kernel":
            by_name[name] = by_name.get(name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[data] (ii) top kernels of a prefetcher-fed group (device ms): "
        + "; ".join(f"{k[:60]} {v / 1e3 / DATA_TIMED_GROUPS:.3f}"
                    for k, v in top))
    for tag in "AB":
        ov = _h2d_overlap(traces[tag])
        log(f"[data] (ii) H2D copies in run {tag}: {ov['copies']} on "
            f"streams {ov['streams']}, {ov['bytes']} bytes, "
            f"{ov['us']:.1f} us, {ov['overlap_share']:.3f} of it overlapping"
            f" a kernel on another stream")


def _mnist_pipeline(where):
    """(iii)'s MNIST set: the synthetic training images through
    ``ToTensor`` and ``Normalize``."""
    from mxnet_tpu_torch.gluon.data.vision import MNIST
    from mxnet_tpu_torch.gluon.data.vision import transforms as T

    return MNIST(root=where, train=True).transform_first(
        T.Compose([T.ToTensor(), T.Normalize(*MNIST_NORM)]))


def _data_loaders(smi_line, data, loaders, yv, pv):
    """(iii) batches a second of the three worker models on the token
    windows and on the MNIST transform pipeline (the 4-process loaders:
    phase (ii)'s, and one whose workers started with the phase), the median
    of DATA_RATE_EPOCHS epochs after a first; Perplexity.update's time and
    host bytes against a host copy of the same probabilities."""
    import torch

    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.gluon.data import DataLoader

    sets = {"tokens": (data, TRAIN_SHAPE[0]),
            "mnist": (loaders["mnist"]._dataset, 256)}
    models = {"serial": {}, "threads": dict(num_workers=DATA_WORKERS,
                                            thread_pool=True),
              "processes": dict(num_workers=DATA_WORKERS)}
    for set_name, (ds, bs) in sets.items():
        for model_name, kw in models.items():
            ld = loaders[set_name] if model_name == "processes" else \
                DataLoader(ds, batch_size=bs, pin_memory=True, **kw)
            t0 = time.perf_counter()
            it = iter(ld)
            next(it)
            first_batch = time.perf_counter() - t0
            first = 1 + sum(1 for _ in it)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            per_epoch = []
            for _ in range(DATA_RATE_EPOCHS):
                t0 = time.perf_counter()
                nb = sum(1 for _ in ld)
                torch.cuda.synchronize()
                per_epoch.append(nb / (time.perf_counter() - t0))
            rate = statistics.median(per_epoch)
            log(f"[data] (iii) {set_name} {model_name}: {rate:.1f} batches/s"
                f" of {bs} (median of {DATA_RATE_EPOCHS} epochs of {nb}: "
                f"{[round(r, 1) for r in per_epoch]}; before them an epoch "
                f"of {warm:.3f} s, its first batch after {first_batch:.3f} s"
                f"{'; the workers started earlier' if model_name == 'processes' else ''}"
                f"); card {smi_line}")
            check(first == nb == len(ld), f"(iii) {set_name} {model_name}: "
                  f"{first} / {nb} batches")
            del it, ld
    m = metric.Perplexity()
    upd, host = [], []
    for _ in range(PPL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.update(yv, pv)
        upd.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        arr = pv.asnumpy()
        host.append((time.perf_counter() - t0) * 1e3)
    want = onp.exp(-onp.log(arr.reshape(-1, arr.shape[-1])[
        onp.arange(arr.shape[0] * arr.shape[1]),
        yv.asnumpy().reshape(-1)].astype("float64") + 1e-12).mean())
    moved = sum(e[5] for e in _gpu_trace(lambda: m.update(yv, pv))
                if e[0] == "gpu_memcpy" and "DtoH" in e[1])
    log(f"[data] (iii) Perplexity.update on {tuple(pv.shape)} fp32: "
        f"{statistics.median(upd):.3f} ms, {moved} bytes to the host; "
        f".asnumpy() of the same probabilities {statistics.median(host):.3f}"
        f" ms, {arr.nbytes} bytes; value {m.get()[1]:.6f} against the host "
        f"formula's {want:.6f}; card {smi_line}")
    check(abs(m.get()[1] - want) <= 1e-5 * want,
          f"(iii) perplexity {m.get()[1]} against the host's {want}")
    check(moved < 1024, f"(iii) Perplexity.update moved {moved} bytes")


def _data_hygiene(smi_line, data, probe, started):
    """(iv) workers without CUDA (``probe``, a loader over ``_WorkerProbe``
    whose workers started at wall time ``started``), and a mid-epoch resume
    of the prefetcher."""
    import torch

    from mxnet_tpu_torch.gluon.data import DataLoader, RandomSampler

    t0 = time.time()
    got = [r for batch in probe for r in batch]
    ready = sorted(r[6] - started for r in got)
    reports = sorted({r[:6] for r in got})
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.split()
    apps = sorted({int(p) for p in smi if p.strip().isdigit()})
    pids = sorted({r[0] for r in reports})
    log(f"[data] (iv) worker reports (pid, CUDA initialised, "
        f"CUDA_VISIBLE_DEVICES, devices, kernel libraries, NDArray "
        f"device): {reports}; answers {ready[0]:.2f}-{ready[-1]:.2f} s after"
        f" the workers' start, {time.time() - t0:.2f} s after iter(); "
        f"nvidia-smi compute apps {apps}, this process "
        f"{os.getpid()}")
    check(os.getpid() not in pids and len(pids) == DATA_WORKERS,
          f"(iv) the probe ran in {pids}")
    check(all(r[1:] == (False, "", 0, 0, "cpu") for r in reports),
          f"(iv) a worker saw CUDA: {reports}")
    check(not set(apps) & set(pids) and len(apps) <= 1,
          f"(iv) nvidia-smi lists {apps}; workers {pids}")
    del probe
    B = TRAIN_SHAPE[0]
    n = 3 * DATA_K * B

    def feed():
        return DataLoader(data.take(n), batch_size=B,
                          sampler=RandomSampler(n, rng=SEED + 1),
                          pin_memory=True).device_prefetch(DATA_K)

    whole = [[a._data.clone() for a in g] for g in feed()]
    pf = feed()
    it = iter(pf)
    next(it)
    state = pf.state_dict()
    pf.close()
    again = feed()
    again.load_state_dict(state)
    rest = [[a._data.clone() for a in g] for g in again]
    same = len(rest) == len(whole) - 1 and all(
        torch.equal(a, b) for g, h in zip(rest, whole[1:])
        for a, b in zip(g, h))
    log(f"[data] (iv) resume: state {state} after one of {len(whole)} "
        f"groups; the resumed prefetcher gave {len(rest)} groups, equal to "
        f"the unconsumed ones: {same}")
    check(state == {"epoch": 0, "offset": DATA_K} and same,
          f"(iv) resume {state}: {len(rest)} groups, equal {same}")


def phase_data(smi_line):
    """Phase 13: the input pipeline (see the module docstring). Returns the
    path's launch counts by dtypes ((ii)'s warm step, capture and
    predict-mode forwards)."""
    import tempfile

    from mxnet_tpu_torch.gluon.data import DataLoader

    t_phase = time.perf_counter()
    before = _shm_segments()
    _release()
    with tempfile.TemporaryDirectory(prefix="data-") as where:
        # the workers of (iii)'s MNIST loader and of (iv)'s probe start
        # now: they import torch (~8 s) while (i) and (ii) run
        os.mkdir(os.path.join(where, "probe"))
        loaders = {"mnist": DataLoader(_mnist_pipeline(where), batch_size=256,
                                       pin_memory=True,
                                       num_workers=DATA_WORKERS)}
        probe = DataLoader(_WorkerProbe(2 * DATA_WORKERS,
                                        os.path.join(where, "probe"),
                                        DATA_WORKERS),
                           batch_size=1, num_workers=DATA_WORKERS,
                           batchify_fn=list)
        started = time.time()
        for ld in (loaders["mnist"], probe):
            ld._ensure_pool()
        _data_mnist(smi_line)
        taken, data, loaders["tokens"], yv, probs = _data_gpt(smi_line)
        _data_loaders(smi_line, data, loaders, yv, probs)
        del probs, loaders
        _release()
        _data_hygiene(smi_line, data, probe, started)
        del probe
    gc.collect()
    time.sleep(0.5)
    left = _shm_segments() - before
    log(f"[data] (iv) shared-memory segments left by this phase: "
        f"{sorted(left)}")
    check(not left, f"(iv) segments left in /dev/shm: {sorted(left)}")
    _release()
    log(f"[data] phase took {time.perf_counter() - t_phase:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 14: sparse — A4's remainder (legacy nd, CSR / row-sparse arrays and
# the lazy updates, LibSVMIter, the vision and sequence ops, control flow)
# ---------------------------------------------------------------------------
SPARSE_ROWS = 262144          # (i) 32 batches of Avazu's 8192
SPARSE_FEATURES = 1_000_000   # the reference's example/sparse/linear_classification
SPARSE_NNZ = 15               # nonzeros a row
SPARSE_BATCH = 8192
SPARSE_EPOCHS = 5
SPARSE_MIN_ACC = 0.9          # the example's own assert
SPARSE_LOSS_RTOL = 1e-5       # (i) losses, card vs CPU and vs float64 numpy
SPARSE_ACC_GAP = 1e-3         # (i) train accuracy, card vs float64 numpy
SPARSE_PEAK = 2 << 30         # (i) a dense (8192, 1e6) fp32 batch is 32.8 GB
SPARSE_TABLE = (1_000_000, 64)   # (ii) tests/test_kvstore.py's 1M-row table
SPARSE_STEPS = 3
SPARSE_OPT_RTOL = 1e-6        # (ii) touched rows and states, card vs CPU
SPARSE_OPTS = (("sgd", {}), ("adagrad", {}), ("adam", {"lazy_update": True}),
               ("ftrl", {}), ("groupadagrad", {}))
SPARSE_OP_RTOL = 1e-5         # (iii) ops, card vs CPU, of each largest entry
SEQ_SHAPE = (35, 32, 200)     # (iii) word_lm's bptt x batch x hidden
DCGAN = dict(batch=64, nz=100, widths=(512, 256, 128, 64, 3))
SSD = dict(batch=8, anchors=8732, classes=21, topk=400, gt=20)
ROI = dict(data=(2, 256, 50, 50), per_image=256, pooled=(7, 7), ratio=2,
           scale=0.5)
RESIZE_SHAPE = (8, 256, 64, 64)
LSTM = dict(T=35, B=32, H=200, layers=2)   # examples/word_lm.py's defaults
CF_RTOL = 1e-5                # (iv) LSTM outputs and gradients, card vs CPU


def _np_rel(got, want):
    """Largest |got - want| over the largest |want| (numpy arrays)."""
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    check(got.shape == want.shape, f"shapes {got.shape} != {want.shape}")
    return float(onp.abs(got - want).max(initial=0.0) /
                 max(float(onp.abs(want).max(initial=0.0)), 1e-30))


def _avazu_synthetic(rows, feats, nnz, seed):
    """``make_synthetic``'s recipe at Avazu's size, vectorised: ``nnz``
    distinct sorted features a row, N(0, 1) values, the label 1 where a
    seeded true weight's product with the row is positive. Returns the
    columns, the values and those i.i.d. labels, and a balanced set on the
    same columns: labels alternating 1, 0, ..., a row whose product has the
    other sign negated (still N(0, 1)), so every batch holds as many
    positives as negatives. The script's bias steps by a mean over the whole
    batch: with i.i.d. labels a batch's share of positives, varying by
    1/sqrt(8192), moves it further than 5 epochs move a row's logit (the
    float64 loop of ``_plain_sparse_linear`` shows it on both sets)."""
    rng = onp.random.RandomState(seed)
    w_true = rng.randn(feats)
    cols = onp.sort(rng.randint(0, feats, (rows, nnz)), axis=1)
    dup = (cols[:, 1:] == cols[:, :-1]).any(1)
    while dup.any():
        cols[dup] = onp.sort(rng.randint(0, feats, (int(dup.sum()), nnz)),
                             axis=1)
        dup = (cols[:, 1:] == cols[:, :-1]).any(1)
    vals = rng.randn(rows, nnz)
    iid = (w_true[cols] * vals).sum(1) > 0
    label = onp.arange(rows) % 2 == 0
    balanced = onp.where((iid != label)[:, None], -vals, vals)
    return cols, vals, iid, balanced, label


def _write_libsvm(path, cols, vals, label):
    """One row a line, ``label col:val ...``, the values with 4 decimals as
    ``make_synthetic`` writes them."""
    table = onp.empty((len(label), 1 + 2 * cols.shape[1]))
    table[:, 0] = label
    table[:, 1::2] = cols
    table[:, 2::2] = vals
    onp.savetxt(path, table, fmt="%d" + " %d:%.4f" * cols.shape[1])


def _plain_sparse_linear(cols, vals, label, feats, batch, epochs, lr=1.0):
    """The script's loop in float64 numpy, independent of the port: the
    file's rows (values rounded to 4 decimals as written) in batches of
    ``batch``, the last partial one discarded; the logistic loss's gradient
    as autograd takes the script's expression (``relu`` and ``abs`` have
    slope 0 at 0, which the first step, at w = 0, meets); the same SGD step
    and the accuracy pass. Returns (train accuracy, the losses a step)."""
    vals = onp.round(vals, 4)
    y = label.astype("float64")
    n = len(y) // batch
    w, b, losses = onp.zeros(feats), 0.0, []

    def logit(k):
        s = slice(k * batch, (k + 1) * batch)
        return cols[s], vals[s], y[s], (w[cols[s]] * vals[s]).sum(1) + b

    for _ in range(epochs):
        for k in range(n):
            c, v, t, z = logit(k)
            e = onp.exp(-onp.abs(z))
            losses.append(float(onp.mean(onp.maximum(z, 0) - z * t +
                                         onp.log1p(e))))
            d = ((z > 0) - t - onp.sign(z) * e / (1 + e)) / batch
            w -= lr * onp.bincount(c.ravel(), (v * d[:, None]).ravel(),
                                   feats)
            b -= lr * d.sum()
    hit = sum(int(((z > 0) == (t > 0.5)).sum())
              for _, _, t, z in map(logit, range(n)))
    return hit / (n * batch), losses


def _top_ops(events, n=6):
    """Device us by operation name, the ``n`` largest (all with None)."""
    by = {}
    for cat, name, _, _, dur, _ in events:
        by[name] = by.get(name, 0.0) + dur
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def _sparse_linear(smi_line, where):
    """(i) the script's loop at Avazu's shape on the card."""
    import io

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io as mio
    from mxnet_tpu_torch.io import _textparse

    ss = _tests_script("torch_script_sparse")
    F, B = SPARSE_FEATURES, SPARSE_BATCH
    path = os.path.join(where, "avazu_synthetic.libsvm")
    t0 = time.perf_counter()
    cols, vals, iid, balanced, label = _avazu_synthetic(
        SPARSE_ROWS, F, SPARSE_NNZ, SEED + 14)
    _write_libsvm(path, cols, balanced, label)
    gen_s = time.perf_counter() - t0
    n0 = _textparse.counts()["libsvm_native"]
    t0 = time.perf_counter()
    it = mio.LibSVMIter(path, data_shape=(F,), batch_size=B, sparse=True,
                        last_batch_handle="discard")
    parse_s = time.perf_counter() - t0
    check(_textparse.counts()["libsvm_native"] == n0 + 1,
          "(i) the native parser did not take the file")
    nnz = int(it.csr[0][-1])
    log(f"[sparse] (i) synthetic LibSVM: {SPARSE_ROWS} rows, {F} features, "
        f"{nnz} nonzeros, {os.path.getsize(path)} bytes, written in "
        f"{gen_s:.2f} s; native parse {parse_s:.3f} s "
        f"({SPARSE_ROWS / parse_s:.0f} rows/s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    acc, losses = ss.main(path, F, batch_size=B, epochs=SPARSE_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    check(_textparse.counts()["libsvm_native"] == n0 + 2,
          "(i) the script's iterator did not go through the native parser")
    with mx.cpu():
        acc_cpu, cpu_losses = ss.main(path, F, batch_size=B, epochs=1)
    per_epoch = SPARSE_ROWS // B
    gap = _np_rel(onp.array(losses[:per_epoch]), onp.array(cpu_losses))
    # the plain reference: the same loop in float64 numpy on the same rows;
    # and, on make_synthetic's own i.i.d. labels, what the example's
    # hyperparameters reach at this size
    acc_np, np_losses = _plain_sparse_linear(cols, balanced, label, F, B,
                                             SPARSE_EPOCHS)
    acc_iid, iid_losses = _plain_sparse_linear(cols, vals, iid, F, B,
                                               SPARSE_EPOCHS)
    np_gap = _np_rel(onp.array(losses), onp.array(np_losses))
    steps = SPARSE_EPOCHS * per_epoch
    log(f"[sparse] (i) tests/torch_script_sparse.py at Avazu's shape, "
        f"{SPARSE_EPOCHS} epochs x {per_epoch} steps of {B}: loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, train accuracy {acc:.4f} "
        f"(CPU, 1 epoch: {acc_cpu:.4f}); first epoch's losses card vs CPU "
        f"{gap:.3e} (limit {SPARSE_LOSS_RTOL}); main() {wall:.2f} s (a "
        f"parse, {steps} steps, the accuracy pass over {per_epoch} "
        f"batches): {SPARSE_EPOCHS * SPARSE_ROWS / wall:.0f} training "
        f"rows/s, {steps / wall:.2f} steps/s; peak allocated {peak} bytes; "
        f"card {smi_line}")
    log(f"[sparse] (i) the loop in float64 numpy on the same rows: train "
        f"accuracy {acc_np:.4f} (card {acc:.4f}, limit {SPARSE_ACC_GAP} "
        f"apart), losses card vs numpy {np_gap:.3e} (limit "
        f"{SPARSE_LOSS_RTOL}); on make_synthetic's i.i.d. labels "
        f"({int(iid.sum())} positives of {SPARSE_ROWS}) the same loop "
        f"reaches train accuracy {acc_iid:.4f}, loss {iid_losses[0]:.6f} -> "
        f"{iid_losses[-1]:.6f}")
    check(acc > SPARSE_MIN_ACC, f"(i) train accuracy {acc:.4f}")
    check(gap <= SPARSE_LOSS_RTOL, f"(i) losses card vs CPU {gap:.3e}")
    check(np_gap <= SPARSE_LOSS_RTOL and abs(acc - acc_np) <= SPARSE_ACC_GAP,
          f"(i) card vs float64 numpy: losses {np_gap:.3e}, accuracy "
          f"{acc:.4f} against {acc_np:.4f}")
    check(peak < SPARSE_PEAK, f"(i) peak {peak} bytes")
    # a step of the script's own loop: main() over the file parsed once
    # (its LibSVMIter is (i)'s iterator), one epoch against more
    class _Parsed:
        @staticmethod
        def LibSVMIter(*args, **kwargs):
            return it

    def run(epochs):
        with contextlib.redirect_stdout(io.StringIO()):
            ss.main(path, F, batch_size=B, epochs=epochs)
        torch.cuda.synchronize()

    real_io, ss.io = ss.io, _Parsed
    try:
        step_ms = (_wall_ms(lambda: run(3), 3) -
                   _wall_ms(lambda: run(1), 3)) / (2 * per_epoch)
        ev1 = _gpu_trace(lambda: run(1))
        ev2 = _gpu_trace(lambda: run(2))
    finally:
        ss.io = real_io
    busy = (_busy_us(ev2) - _busy_us(ev1)) / 1e3 / per_epoch
    it.reset()
    t0 = time.perf_counter()
    for _ in range(per_epoch):
        next(it)
    batch_ms = (time.perf_counter() - t0) / per_epoch * 1e3
    log(f"[sparse] (i) a step of the script's loop (its batch from "
        f"LibSVMIter, the product, loss, backward, update and zeroing; "
        f"batch {B}, ~{nnz // per_epoch} nonzeros; main() over 3 epochs "
        f"less 1, and traced over 2 less 1): wall {step_ms:.3f} ms, device "
        f"busy {busy:.3f} ms, idle share {1 - busy / step_ms:.3f}; of it a "
        f"batch made by LibSVMIter (host gather + CSRNDArray) "
        f"{batch_ms:.3f} ms; card {smi_line}")
    one = dict(_top_ops(ev1, n=None))
    epoch = sorted(((us - one.get(name, 0.0), name)
                    for name, us in _top_ops(ev2, n=None)), reverse=True)
    for us, name in epoch[:6]:
        log(f"[sparse] (i) top: {us / 1e3 / per_epoch:8.4f} ms a step  "
            f"{name[:100]}")
    return it


def _count_todense():
    """Patch ``RowSparseNDArray.todense`` to count its calls; returns the
    count list and the original."""
    from mxnet_tpu_torch.ndarray import sparse

    calls, real = [], sparse.RowSparseNDArray.todense

    def counted(self):
        calls.append(1)
        return real(self)

    sparse.RowSparseNDArray.todense = counted
    return calls, real


def _sparse_updates(smi_line, it):
    """(ii) the lazy row-sparse updates on the 1M-row table."""
    import torch

    from mxnet_tpu_torch import optimizer as mopt
    from mxnet_tpu_torch.gluon import Parameter, Trainer
    from mxnet_tpu_torch.ndarray import sparse

    R, D = SPARSE_TABLE
    ip, ix, _ = it.csr
    rng = onp.random.RandomState(SEED + 141)
    w0 = (0.1 * rng.randn(R, D)).astype("float32")
    grads = []
    for k in range(SPARSE_STEPS):
        ids = onp.unique(ix[ip[k * SPARSE_BATCH]:ip[(k + 1) * SPARSE_BATCH]])
        grads.append((ids.astype("int32"),
                      rng.randn(len(ids), D).astype("float32")))
    touched = onp.zeros(R, bool)
    for ids, _ in grads:
        touched[ids] = True
    mask = torch.from_numpy(touched).to(DEV)
    w0_g = torch.from_numpy(w0).to(DEV)
    dense_g = torch.randn(R, D, device=DEV)
    calls, real = _count_todense()
    try:
        for name, kw in SPARSE_OPTS:
            kw = dict(kw, learning_rate=0.1)
            opt_c = mopt.create(name, **kw)
            w_c = torch.from_numpy(w0.copy())
            st_c = opt_c.create_state(0, w_c)
            for ids, g in grads:
                opt_c.update(0, w_c, sparse.RowSparseNDArray(
                    g, ids, (R, D), ctx="cpu"), st_c)
            opt = mopt.create(name, **kw)
            w = w0_g.clone()
            st = opt.create_state(0, w)
            st0 = {k: v.clone() for k, v in st.items()}
            rs = [sparse.RowSparseNDArray(g, ids, (R, D), ctx=DEV)
                  for ids, g in grads]
            for r in rs:
                opt.update(0, w, r, st)
            torch.cuda.synchronize()
            check(torch.equal(w[~mask], w0_g[~mask]) and all(
                torch.equal(st[k][~mask], st0[k][~mask]) for k in st),
                f"(ii) {name}: untouched rows moved")
            gap = max([_np_rel(w[mask].cpu().numpy(),
                                w_c[torch.from_numpy(touched)].numpy())] +
                      [_np_rel(st[k][mask].cpu().numpy(),
                                st_c[k][torch.from_numpy(touched)].numpy())
                       for k in st])
            p = Parameter(w0_g.clone())
            tr = Trainer([p], name, kw)
            for r in rs:
                p.grad = r
                tr.step(1)
            tgap = _np_rel(p.detach().cpu().numpy(), w.cpu().numpy())
            check(gap <= SPARSE_OPT_RTOL and tgap <= SPARSE_OPT_RTOL,
                  f"(ii) {name}: card vs CPU {gap:.3e}, Trainer vs update "
                  f"{tgap:.3e}")
            lazy_ms = time_ms(lambda: opt.update(0, w, rs[0], st), reps=10,
                              rounds=3)
            opt_d = mopt.create(name, **kw)
            w_d = w0_g.clone()
            st_d = opt_d.create_state(0, w_d)
            dense_ms = time_ms(lambda: opt_d.update(0, w_d, dense_g, st_d),
                               reps=10, rounds=3)
            log(f"[sparse] (ii) {name}: {len(grads[0][0])} of {R} rows a "
                f"step, untouched rows and states bitwise, touched card vs "
                f"CPU {gap:.3e}, Trainer vs update {tgap:.3e}; lazy "
                f"{lazy_ms:.4f} ms a step against dense {dense_ms:.4f} ms "
                f"on the same table; card {smi_line}")
            del w, st, st0, p, tr, w_d, st_d, w_c, st_c, rs
        # bf16 weight, multi_precision: the fp32 master takes the step
        opt = mopt.create("adam", learning_rate=0.1, multi_precision=True)
        w = w0_g.to(torch.bfloat16)
        st = opt.create_state_multi_precision(0, w)
        wb = w.clone()
        for ids, g in grads:
            opt.update_multi_precision(0, w, sparse.RowSparseNDArray(
                g, ids, (R, D), ctx=DEV), st)
        check(torch.equal(w[~mask], wb[~mask]) and torch.equal(
            w, st["weight_fp32"].to(torch.bfloat16)),
            "(ii) multi-precision: untouched rows moved or the weight is "
            "not the master's rounding")
    finally:
        sparse.RowSparseNDArray.todense = real
    check(not calls, f"(ii) RowSparseNDArray.todense called {len(calls)} "
          "times on a lazy path")
    log(f"[sparse] (ii) RowSparseNDArray.todense calls on the lazy paths "
        f"(fp32 and bf16 multi_precision): {len(calls)}")
    del w0_g, dense_g
    _release()


def _both_devices(fn, inputs, grads=()):
    """``fn`` over NDArrays of ``inputs`` on the CPU and on the card under
    ``record()``: (outputs, gradients of sum(out * c) into ``grads``) of
    each, as numpy, and the card's forward ms."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import np as mnp

    res = []
    for ctx in (mx.cpu(), mx.gpu()):
        with ctx:
            arrs = [mnp.array(a) for a in inputs]
            for i in grads:
                arrs[i].attach_grad()
            with autograd.record():
                outs = fn(*arrs)
                outs = list(outs) if isinstance(outs, (list, tuple)) \
                    else [outs]
                if grads:
                    rng = onp.random.RandomState(1)
                    loss = None
                    for o in outs:
                        c = mnp.array(onp.asarray(rng.randn(*o.shape),
                                                  "float32"))
                        t = (o * c).sum()
                        loss = t if loss is None else loss + t
            if grads:
                loss.backward()
            res.append(([o.asnumpy() for o in outs],
                        [arrs[i].grad.asnumpy() for i in grads]))
    ms = time_ms(lambda: fn(*arrs), reps=5, rounds=3)   # the card's
    return res[0], res[1], ms


def _op_row(tag, cpu, card, ms, exact=False, limit=SPARSE_OP_RTOL):
    gaps = [_np_rel(g, w) for g, w in zip(card[0] + card[1],
                                          cpu[0] + cpu[1])]
    gap = max(gaps) if gaps else 0.0
    if len(gaps) > 1:
        log(f"[sparse] (iii) {tag}: gaps of the outputs, then of each "
            f"gradient: {['%.3e' % g for g in gaps]}")
    if exact:
        check(all(onp.array_equal(g, w) for g, w in
                  zip(card[0], cpu[0])), f"(iii) {tag}: card != CPU")
    check(gap <= limit, f"(iii) {tag}: card vs CPU {gap:.3e}")
    log(f"[sparse] (iii) {tag}: card vs CPU {gap:.3e} (limit "
        f"{0 if exact else limit}), {ms:.4f} ms a forward")


def _ssd_rows(rng):
    b, n = SSD["batch"], SSD["anchors"] * SSD["classes"]
    xy = rng.uniform(0.05, 0.95, (b, n, 2))
    wh = rng.uniform(0.02, 0.3, (b, n, 2))
    cls = onp.repeat(onp.arange(SSD["classes"]), SSD["anchors"])
    return onp.concatenate(
        [onp.broadcast_to(cls[None, :, None], (b, n, 1)),
         rng.uniform(0, 1, (b, n, 1)), xy - wh / 2, xy + wh / 2],
        -1).astype("float32")


def _dcgan_weights(rng):
    """Seeded (in, out, 4, 4) weights of DCGAN's five transposed
    convolutions."""
    widths = DCGAN["widths"]
    return [(0.02 * rng.randn(ci, co, 4, 4)).astype("float32")
            for ci, co in zip((DCGAN["nz"],) + widths[:-1], widths)]


def _dcgan_generator(ws):
    """DCGAN's generator as its users build it, on the current context:
    ``nn.Conv2DTranspose`` layers without ``in_channels`` (inferred at the
    first forward), ReLU between, tanh last; then the seeded weights set
    through ``set_data``. (No BatchNorm: the layers are what is checked.)"""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    for i, co in enumerate(DCGAN["widths"]):
        net.add(nn.Conv2DTranspose(co, 4, 1 if i == 0 else 2,
                                   0 if i == 0 else 1, use_bias=False),
                nn.Activation("relu" if i < len(ws) - 1 else "tanh"))
    net.initialize()
    net(mx.np.zeros((1, DCGAN["nz"], 1, 1)))
    for i, w in enumerate(ws):
        check(tuple(net[2 * i].weight.shape) == w.shape,
              f"(iii) Conv2DTranspose {i + 1} inferred "
              f"{tuple(net[2 * i].weight.shape)}, not {w.shape}")
        net[2 * i].weight.set_data(mx.np.array(w))
    return net


def _dcgan_rows(rng, smi_line):
    """(iii) ``nn.Conv2DTranspose`` through DCGAN's generator: each layer
    alone, forward and backward, on the activations the CPU's generator
    feeds it; the chain's forward eager and hybridized (one CUDA graph),
    card against CPU; the chain recorded and hybridized."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    ws = _dcgan_weights(rng)
    z = rng.randn(DCGAN["batch"], DCGAN["nz"], 1, 1).astype("float32")
    nets, pres = {}, {}
    for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu())):
        with ctx:
            nets[where] = _dcgan_generator(ws)
            h, pre = mx.np.array(z), []
            for i in range(len(ws)):
                pre.append(nets[where][2 * i](h))
                h = nets[where][2 * i + 1](pre[-1])
            pres[where] = [p.asnumpy() for p in pre] + [h.asnumpy()]
    h = z
    for i in range(len(ws)):
        runs = []
        for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu())):
            layer = nets[where][2 * i]
            with ctx:
                x = mx.np.array(h)
                x.attach_grad()
                c = mx.np.array(onp.random.RandomState(i).randn(
                    *pres["cpu"][i].shape).astype("float32"))
                with autograd.record():
                    out = layer(x)
                    (out * c).sum().backward()
                runs.append(([out.asnumpy()], [x.grad.asnumpy(),
                             layer.weight.grad.detach().cpu().numpy()]))
        with mx.gpu():
            ms = time_ms(lambda: layer(x), reps=5, rounds=3)
        _op_row(f"nn.Conv2DTranspose {i + 1} of DCGAN's generator, "
                f"{h.shape} -> {runs[1][0][0].shape}, forward and the "
                f"input's and weight's gradients", runs[0], runs[1], ms)
        out = pres["cpu"][i]
        h = onp.maximum(out, 0) if i < len(ws) - 1 else onp.tanh(out)
    out_cpu = pres["cpu"][-1]
    check(pres["card"][-1].shape == (DCGAN["batch"], 3, 64, 64),
          f"(iii) DCGAN output {pres['card'][-1].shape}")
    fwd = _np_rel(pres["card"][-1], out_cpu)
    flips = sum(int(((g > 0) != (c > 0)).sum()) for g, c in
                zip(pres["card"][:-2], pres["cpu"][:-2]))
    grads = {}
    for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu())):
        net = nets[where]
        with ctx:
            zz = mx.np.array(z)
            with autograd.record():
                net(zz).backward()
            grads[where] = [net[2 * i].weight.grad.detach().cpu().numpy()
                            for i in range(len(ws))]
    bwd = max(_np_rel(g, c) for g, c in zip(grads["card"], grads["cpu"]))
    with mx.gpu():
        card = nets["card"]
        zz = mx.np.array(z)
        eager_ms = time_ms(lambda: card(zz), reps=5, rounds=3)

        def step(net):
            with autograd.record():
                out = net(zz)
            out.backward()

        eager_step_ms = time_ms(lambda: step(card), reps=5, rounds=3)
        card.hybridize()
        for _ in range(3):
            hy = card(zz)
        (cop, _, _), = card._cached.values()
        replays = sum(s["replays"] for s in cop.graph_stats())
        hy_gap = _np_rel(hy.asnumpy(), out_cpu)
        check(cop._captures == 1 and replays >= 2 and
              hy_gap <= SPARSE_OP_RTOL,
              f"(iii) hybridized DCGAN generator: {cop._captures} captures, "
              f"{replays} replays, card vs CPU {hy_gap:.3e}")
        hy_ms = time_ms(lambda: card(zz), reps=5, rounds=3)
        rec = _dcgan_generator(ws)
        rec.hybridize()
        for _ in range(2):
            step(rec)
        (rcop, _, _), = rec._cached.values()
        prog = next(iter(rcop._recorded.values()))
        rec_gap = max(_np_rel(rec[2 * i].weight.grad.detach().cpu().numpy(),
                              g) for i, g in enumerate(grads["card"]))
        rec_ok = all(torch.isfinite(rec[2 * i].weight.grad).all()
                     for i in range(len(ws)))
        check(rcop._backward_captures == 1 and prog.backward_replays == 1
              and rec_ok, f"(iii) recorded hybridized DCGAN generator: "
              f"{rcop._backward_captures} backward captures, "
              f"{prog.backward_replays} backward replays, finite {rec_ok}")
        hy_step_ms = time_ms(lambda: step(rec), reps=5, rounds=3)
    check(fwd <= SPARSE_OP_RTOL and all(onp.isfinite(g).all()
                                        for g in grads["card"]),
          f"(iii) DCGAN generator forward card vs CPU {fwd:.3e}")
    log(f"[sparse] (iii) DCGAN's generator of nn.Conv2DTranspose layers "
        f"(batch {DCGAN['batch']}, z {DCGAN['nz']} -> 64x64x3, in_channels "
        f"inferred): forward card vs CPU {fwd:.3e} eager, {hy_gap:.3e} "
        f"hybridized (one CUDA graph, {replays} replays) (limit "
        f"{SPARSE_OP_RTOL}); ms a forward eager {eager_ms:.4f}, hybridized "
        f"{hy_ms:.4f}; forward + backward eager {eager_step_ms:.4f}, "
        f"hybridized under record() {hy_step_ms:.4f} (backward captured "
        f"once); the chain's weight gradients card vs CPU {bwd:.3e}, "
        f"hybridized vs eager on the card {rec_gap:.3e}, with {flips} ReLU "
        f"inputs of the {sum(p.size for p in pres['cpu'][:-2])} on the "
        f"other side of 0 on the card than on the CPU (such an input passes "
        f"a whole gradient entry on one device only; each layer alone is "
        f"held above); card {smi_line}")


def _sparse_ops(smi_line, where):
    """(iii) the ops at model sizes, card against CPU."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch import npx

    rng = onp.random.RandomState(SEED + 143)
    T, B, H = SEQ_SHAPE
    x = rng.randn(T, B, H).astype("float32")
    ln = rng.randint(1, T + 1, B).astype("float32")
    for name in ("sequence_mask", "sequence_reverse", "sequence_last"):
        cpu, card, ms = _both_devices(
            lambda d, l, _n=name: getattr(npx, _n)(d, l), [x, ln], (0,))
        _op_row(f"{name} {SEQ_SHAPE}", cpu, card, ms)
    _dcgan_rows(rng, smi_line)
    # SSD-300's NMS, encode and decode
    rows = _ssd_rows(rng)
    cpu, card, ms = _both_devices(
        lambda d: npx.box_nms(d, overlap_thresh=0.45, valid_thresh=0.01,
                              topk=SSD["topk"], id_index=0, score_index=1,
                              coord_start=2), [rows])
    kept = int((card[0][0][..., 0] >= 0).sum())
    _op_row(f"box_nms {rows.shape} topk {SSD['topk']} ({kept} kept)", cpu,
            card, ms, exact=True)
    b, n, m = SSD["batch"], SSD["anchors"], SSD["gt"]
    anchors = onp.concatenate([rng.uniform(0, 0.7, (b, n, 2)),
                               rng.uniform(0.75, 1.0, (b, n, 2))], -1)
    refs = onp.concatenate([rng.uniform(0, 0.5, (b, m, 2)),
                            rng.uniform(0.55, 1.0, (b, m, 2))], -1)
    enc_in = [rng.choice([-1.0, 0.0, 1.0], (b, n)),
              rng.randint(0, m, (b, n)).astype("float64"), anchors, refs]
    cpu, card, ms = _both_devices(npx.box_encode, [a.astype("float32")
                                                   for a in enc_in], (2, 3))
    _op_row(f"box_encode ({b}, {n}, 4) against {m} boxes", cpu, card, ms)
    deltas = (0.5 * rng.randn(b, n, 4)).astype("float32")
    cpu, card, ms = _both_devices(
        lambda d, a: npx.box_decode(d, a, format="corner"),
        [deltas, anchors.astype("float32")], (0, 1))
    _op_row(f"box_decode ({b}, {n}, 4)", cpu, card, ms)
    # ROI align / pooling over (2, 256, 50, 50), 256 ROIs an image
    data = rng.randn(*ROI["data"]).astype("float32")
    R = ROI["per_image"] * ROI["data"][0]
    size = ROI["data"][2] / ROI["scale"]
    lo = rng.uniform(0, size * 0.7, (R, 2))
    rois = onp.concatenate([onp.repeat(onp.arange(ROI["data"][0]),
                                       ROI["per_image"])[:, None], lo,
                            lo + rng.uniform(4, size * 0.3, (R, 2))],
                           1).astype("float32")
    cpu, card, ms = _both_devices(
        lambda d, r: npx.roi_align(d, r, pooled_size=ROI["pooled"],
                                   spatial_scale=ROI["scale"],
                                   sample_ratio=ROI["ratio"]),
        [data, rois], (0,))
    _op_row(f"roi_align {ROI['data']} {R} ROIs 7x7 ratio 2, with the "
            f"gradient", cpu, card, ms)
    cpu, card, ms = _both_devices(
        lambda d, r: npx.roi_pooling(d, r, pooled_size=ROI["pooled"],
                                     spatial_scale=ROI["scale"]),
        [data, rois])
    _op_row(f"roi_pooling {ROI['data']} {R} ROIs 7x7", cpu, card, ms)
    img = rng.randn(*RESIZE_SHAPE).astype("float32")
    for tag, fn in (("upsampling nearest x2",
                     lambda d: npx.upsampling(d, scale=2)),
                    ("bilinear_resize_2d to 128x128",
                     lambda d: npx.bilinear_resize_2d(d, height=128,
                                                      width=128)),
                    ("moments over (2, 3)",
                     lambda d: npx.moments(d, axes=(2, 3)))):
        cpu, card, ms = _both_devices(fn, [img], (0,))
        _op_row(f"{tag} {RESIZE_SHAPE}", cpu, card, ms)
    # mx.nd.save / load round trip on the card
    with mx.gpu():
        arrs = {f"w{i}": mx.np.array(w) for i, w in enumerate(_dcgan_weights(
            onp.random.RandomState(SEED + 145)))}
        fname = os.path.join(where, "dcgan.params")
        nd.save(fname, arrs)
        back = nd.load(fname)
    check(sorted(back) == sorted(arrs) and all(
        back[k]._data.is_cuda and torch.equal(back[k]._data, arrs[k]._data)
        for k in arrs), "(iii) nd.save/load round trip")
    log(f"[sparse] (iii) mx.nd.save/load of {len(arrs)} DCGAN weights "
        f"({os.path.getsize(fname)} bytes): bitwise, back on the card")
    _release()


def _lstm_case(rng):
    """examples/word_lm.py's 2-layer LSTM cell written in mx.np for
    ``npx.foreach``: (data, h/c of each layer, numpy weights)."""
    T, B, H, L = LSTM["T"], LSTM["B"], LSTM["H"], LSTM["layers"]
    ws = [((rng.randn(H, 4 * H) / onp.sqrt(H)).astype("float32"),
           (rng.randn(H, 4 * H) / onp.sqrt(H)).astype("float32"))
          for _ in range(L)]
    data = rng.randn(T, B, H).astype("float32")
    states = [(0.1 * rng.randn(B, H)).astype("float32")
              for _ in range(2 * L)]
    return data, states, ws


def _lstm_fn(ws_nd):
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx

    H = LSTM["H"]

    def body(x, states):
        new = []
        for k, (wi, wh) in enumerate(ws_nd):
            h, c = states[2 * k], states[2 * k + 1]
            g = mnp.dot(x, wi) + mnp.dot(h, wh)
            i, f, o, u = (g[:, j * H:(j + 1) * H] for j in range(4))
            c = npx.sigmoid(f) * c + npx.sigmoid(i) * mnp.tanh(u)
            h = npx.sigmoid(o) * mnp.tanh(c)
            new += [h, c]
            x = h
        return x, new

    def run(data, *states):
        outs, final = npx.foreach(body, data, list(states))
        return (outs, *final)

    return run


def _sparse_control_flow(smi_line):
    """(iv) foreach (the LSTM), while_loop and cond, eager and hybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon.block import HybridBlock

    class Fn(HybridBlock):
        def __init__(self, fn):
            super().__init__()
            self._fn = fn

        def forward(self, *args):
            return self._fn(*args)

    rng = onp.random.RandomState(SEED + 144)
    data, states, ws = _lstm_case(rng)
    inputs = [data] + states
    runs = {}
    for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu())):
        with ctx:
            fn = _lstm_fn([(mnp.array(a), mnp.array(b)) for a, b in ws])
            arrs = [mnp.array(a) for a in inputs]
            for a in arrs:
                a.attach_grad()
            with autograd.record():
                outs = fn(*arrs)
                loss = sum((o * o).sum() for o in outs)
            loss.backward()
            runs[where] = ([o.asnumpy() for o in outs],
                           [a.grad.asnumpy() for a in arrs])
            if where == "card":
                eager_ms = time_ms(lambda: fn(*arrs), reps=3, rounds=3)

                def train_step(f):
                    with autograd.record():
                        outs = f(*arrs)
                        loss = sum((o * o).sum() for o in outs)
                    loss.backward()

                eager_step_ms = time_ms(lambda: train_step(fn), reps=3,
                                        rounds=3)
                net = Fn(fn)
                net.hybridize()
                for _ in range(3):
                    hy = net(*arrs)
                (cop, _, _), = net._cached.values()
                replays = sum(s["replays"] for s in cop.graph_stats())
                hy_gap = max(_np_rel(h.asnumpy(), e) for h, e in
                             zip(hy, runs["card"][0]))
                check(cop._captures == 1 and replays >= 2 and
                      hy_gap <= 1e-6,
                      f"(iv) hybridized foreach: {cop._captures} captures, "
                      f"{replays} replays, gap {hy_gap:.3e}")
                hy_ms = time_ms(lambda: net(*arrs), reps=3, rounds=3)
                rec = Fn(fn)
                rec.hybridize()
                for _ in range(2):
                    for a in arrs:
                        a.grad._data.zero_()
                    train_step(rec)
                (rcop, _, _), = rec._cached.values()
                prog = next(iter(rcop._recorded.values()))
                rgap = max(_np_rel(a.grad.asnumpy(), g) for a, g in
                           zip(arrs, runs["card"][1]))
                check(rcop._backward_captures == 1 and prog.replays == 1
                      and prog.backward_replays == 1 and rgap <= 1e-6,
                      f"(iv) recorded foreach: {rcop._captures} / "
                      f"{rcop._backward_captures} captures, replays "
                      f"{prog.replays} / {prog.backward_replays}, gradient "
                      f"gap {rgap:.3e}")
                rec_ms = time_ms(lambda: train_step(rec), reps=3, rounds=3)
    gap = max(_np_rel(g, c) for g, c in
              zip(runs["card"][0] + runs["card"][1],
                  runs["cpu"][0] + runs["cpu"][1]))
    check(gap <= CF_RTOL, f"(iv) LSTM via foreach card vs CPU {gap:.3e}")
    log(f"[sparse] (iv) npx.foreach over a 2-layer LSTM cell (T {LSTM['T']},"
        f" B {LSTM['B']}, H {LSTM['H']}): outputs and gradients into the "
        f"data and the 4 initial states card vs CPU {gap:.3e}; eager "
        f"{eager_ms:.3f} ms, hybridized (one CUDA graph, {replays} replays) "
        f"{hy_ms:.3f} ms a forward, gap {hy_gap:.3e}; under record() "
        f"forward and backward (the body run once) {eager_step_ms:.3f} ms "
        f"eager, {rec_ms:.3f} ms hybridized (captured once), gradients "
        f"{rgap:.3e} from eager; card {smi_line}")
    with mx.gpu():
        i0, v0 = mnp.array(0.0), mnp.array(rng.randn(1024).astype("float32"))

        def wl(i, v):
            return npx.while_loop(lambda i, v: i < 5,
                                  lambda i, v: (v * 2, (i + 1, v + 1)),
                                  (i, v), max_iterations=8)

        want = wl(i0, v0)
        net = Fn(lambda i, v: (lambda o, f: (o, *f))(*wl(i, v)))
        net.hybridize()
        for _ in range(3):
            got = net(i0, v0)
        (cop, _, _), = net._cached.values()
        ok = all(onp.array_equal(g.asnumpy(), w.asnumpy()) for g, w in
                 zip(got, [want[0]] + want[1]))
        check(cop._captures == 1 and ok,
              f"(iv) while_loop hybridized: {cop._captures} captures, "
              f"equal {ok}")
        x = mnp.array(rng.randn(1024).astype("float32"))
        cnet = Fn(lambda p, a: npx.cond(p, lambda t: t * 2,
                                        lambda t: t - 1, [a]))
        cnet.hybridize()
        for p in (1.0, 0.0, 1.0, 0.0):
            got = cnet(mnp.array(p), x)
            want = npx.cond(mnp.array(p), lambda t: t * 2, lambda t: t - 1,
                            [x])
            check(onp.array_equal(got.asnumpy(), want.asnumpy()),
                  f"(iv) cond hybridized, predicate {p}")
        (ccop, _, _), = cnet._cached.values()
        check(ccop._captures == 1, f"(iv) cond: {ccop._captures} captures")
    log(f"[sparse] (iv) while_loop (max_iterations 8, masked form) and cond "
        f"(both branches and a select) hybridized: one capture each, "
        f"replays equal to eager for both predicates")
    _release()


def phase_sparse(smi_line):
    """Phase 14: A4's remainder (see the module docstring). Returns the
    path's launch counts by dtypes (no port kernel on it)."""
    import tempfile

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    ck.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="sparse-") as where:
        it = _sparse_linear(smi_line, where)
        _sparse_updates(smi_line, it)
        del it
        _sparse_ops(smi_line, where)
    _sparse_control_flow(smi_line)
    taken = read_counts("sparse")
    log(f"[sparse] launches of the port's kernels on this path: {taken}")
    log(f"[sparse] phase took {time.perf_counter() - t_phase:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 15: A9's vision part — SSD-300, the zoo at ImageNet input, the warp
# and deformable ops at the sizes of the models that use them, the STN
VISION_SSD = dict(batch=32, image=300, classes=20, labels=8, steps=10,
                  lr=0.01, momentum=0.9, anchors=1944)
VISION_CHECK_BATCH = 2        # (i), (ii) card against CPU
VISION_BATCH = 32             # (ii) the zoo's throughput batch
VISION_RTOL = 1e-4            # card vs CPU outputs, fp32, TF32 off
# card gradients against a float64 CPU twin, of the net's largest: within
# VISION_GRAD_FACTOR times the CPU fp32 run's own distance from it, or
# VISION_GRAD_RTOL, whichever is larger. At batch 2 an fp32 step lies 5e-3
# to 3e-2 from float64 on the CPU itself (training-mode BatchNorm over two
# images; a ReLU input or a max-pool's runner-up within rounding flips a
# last-stage weight's gradient, a sum of 98 positions there), and two fp32
# runs' distances differ by 0.07-2.3x across the families
VISION_GRAD_RTOL = 1e-3
VISION_GRAD_FACTOR = 4.0
VISION_EXACT_RTOL = 1e-5      # (i) targets/detections' floats, same inputs
VISION_ANCHOR_ATOL = 2.0 ** -22
SSD_FIRST_LOSS_RTOL = 1e-5    # (i) eager vs hybridized first-step loss
WARP_RTOL = 1e-4              # (iii) outputs and gradients, card vs CPU
STN_MIN_ACC = 0.9             # (iv) the example's own assert
STN_MARGIN = 0.05
VISION_LIMIT_S = 150.0        # the phase's seconds, the build excluded
VISION_ZOO = ("alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "mlp",
              "densenet121", "densenet161", "densenet169", "densenet201",
              "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
              "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.5",
              "squeezenet1.0", "squeezenet1.1", "inceptionv3",
              "ssd_300_mobilenet", "ssd_256_lite")
VISION_FAMILIES = ("alexnet", "vgg16", "densenet121", "mobilenet1.0",
                   "mobilenetv2_1.0", "squeezenet1.1", "inceptionv3")
DCN = dict(data=(1, 512, 38, 63), filters=512, kernel=3, pad=2, dilate=2)
RFCN = dict(data=(1, 7 * 7 * 21, 38, 63), rois=300, scale=1.0 / 16,
            classes=21, group=7, pooled=7, image=(600, 1000),
            sample_per_part=4, trans_std=0.1)
FLOWNET = dict(data=(4, 256, 48, 64), kernel_size=1, max_displacement=20,
               stride1=1, stride2=2, pad_size=20)
SAMPLER_SHAPE = (16, 64, 96, 96)
SUBPIXEL = ((16, 256, 24, 24), (16, 256, 48, 48))   # SRResNet's two


def _drop_off(net):
    """Every ``Dropout`` of ``net`` at rate 0: its masks come from each
    device's own generator, so a card-against-CPU step runs without."""
    from mxnet_tpu_torch.gluon import nn

    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m._rate = 0.0


def _top_grad_gap(net_a, net_b):
    """Largest |grad_a - grad_b| over the largest |grad_b|, of all of the
    two nets' parameters (the same names), in float64."""
    pa, pb = net_a.collect_params(), net_b.collect_params()
    top = max(float(p.grad.abs().max()) for p in pb.values()
              if p.grad is not None)
    gap = max(float((pa[n].grad.cpu().double() -
                     p.grad.cpu().double()).abs().max())
              for n, p in pb.items() if p.grad is not None)
    return gap / max(top, 1e-30)


def _f64_twin(make, path):
    """``make()`` on the CPU with the parameters of ``path`` in float64."""
    import torch

    import mxnet_tpu_torch as mx

    with mx.cpu():
        net = make()
        net.load_parameters(path)
    with torch.no_grad():
        for p in net.collect_params().values():
            p.data = p.data.double()
    return net


def _grad_check(tag, card, cpu, f64):
    """The card's gradients against the float64 twin's, beside the CPU fp32
    run's: (card gap, CPU gap, limit), each of the largest gradient."""
    card_gap, cpu_gap = _top_grad_gap(card, f64), _top_grad_gap(cpu, f64)
    limit = max(VISION_GRAD_FACTOR * cpu_gap, VISION_GRAD_RTOL)
    check(card_gap <= limit, f"{tag}: gradients {card_gap:.3e} from "
          f"float64 (the CPU's fp32 {cpu_gap:.3e})")
    return card_gap, cpu_gap, limit


def _ssd_labels(rng, b, m, classes):
    """(b, m, 5) rows [cls, x1, y1, x2, y2], 1 to m boxes an image, the
    rest -1."""
    lab = -onp.ones((b, m, 5), "float32")
    for i in range(b):
        n = rng.randint(1, m + 1)
        xy = rng.uniform(0.0, 0.75, (n, 2))
        wh = rng.uniform(0.08, 0.4, (n, 2))
        lab[i, :n, 0] = rng.randint(0, classes, n)
        lab[i, :n, 1:3] = xy
        lab[i, :n, 3:5] = onp.minimum(xy + wh, 1.0)
    return lab


def _ssd_loss(net, x, labels, targets=None):
    """tests/test_ssd_model.py's loss: the masked NLL of the kept anchors
    plus smooth L1 of the positives' boxes; ``targets`` given (another
    device's) or from ``ssd_target``."""
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    cls_p, box_p, anchors = net(x)
    lt, lm, ct = targets if targets is not None else \
        vision.ssd_target(anchors, cls_p, labels)
    keep = ct >= 0
    logp = npx.log_softmax(cls_p, axis=-1)
    nll = -npx.pick(logp, mnp.maximum(ct, 0), axis=-1) * keep
    box_loss = npx.smooth_l1((box_p - lt) * lm, scalar=1.0).mean()
    return nll.sum() / keep.sum() + box_loss, (cls_p, box_p, anchors)


def _vision_ssd(smi_line, where):
    """(i) SSD-300 at VOC's size: training eager and hybridized, the card
    against the CPU, the matcher and the detector on identical inputs."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    cfg = VISION_SSD
    b, s = cfg["batch"], cfg["image"]
    rng = onp.random.RandomState(SEED + 15)
    x = rng.rand(b, 3, s, s).astype("float32")
    labels = _ssd_labels(rng, b, cfg["labels"], cfg["classes"])
    path = os.path.join(where, "ssd300.params")
    with mx.cpu():
        cpu_net = vision.ssd_300_mobilenet(num_classes=cfg["classes"])
        cpu_net.initialize(seed=SEED + 15)
        cpu_net(mnp.array(x[:1]))
        cpu_net.save_parameters(path)

    def card_net(hybridize):
        with mx.gpu():
            net = vision.ssd_300_mobilenet(num_classes=cfg["classes"])
            net.load_parameters(path)
        if hybridize:
            net.hybridize()
        return net

    runs = {}
    for hyb in (False, True):
        with mx.gpu():
            net = card_net(hyb)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": cfg["lr"],
                                "momentum": cfg["momentum"]})
            xd, ld = mnp.array(x), mnp.array(labels)

            def step(net=net, tr=tr, xd=xd, ld=ld):
                with autograd.record():
                    loss, outs = _ssd_loss(net, xd, ld)
                loss.backward()
                tr.step(b)
                return loss, outs

            losses, walls = [], []
            for _ in range(cfg["steps"]):
                t = time.perf_counter()
                loss, outs = step()
                losses.append(float(loss.asnumpy()))
                walls.append((time.perf_counter() - t) * 1e3)
            check(outs[2].shape == (1, cfg["anchors"], 4) and
                  outs[0].shape == (b, cfg["anchors"], cfg["classes"] + 1),
                  f"(i) outputs {[o.shape for o in outs]}")
            check(all(math.isfinite(v) for v in losses) and
                  losses[-1] < losses[0], f"(i) losses {losses}")
            runs[hyb] = (net, step, losses, walls, outs)
    (_, _, le, we, _), (net, step, lh, wh, outs) = runs[False], runs[True]
    gap = abs(le[0] - lh[0]) / abs(le[0])
    log(f"[vision] (i) ssd_300_mobilenet(20) on ({b}, 3, {s}, {s}), "
        f"{cfg['anchors']} anchors, labels ({b}, {cfg['labels']}, 5) with "
        f"1-{cfg['labels']} boxes; SGD {cfg['lr']} momentum "
        f"{cfg['momentum']}, {cfg['steps']} steps: eager loss "
        f"{le[0]:.5f} -> {le[-1]:.5f}, hybridized {lh[0]:.5f} -> "
        f"{lh[-1]:.5f}; first-step losses {gap:.3e} apart (limit "
        f"{SSD_FIRST_LOSS_RTOL}); step wall (median of steps 3-10, with "
        f"the loss read) eager {statistics.median(we[2:]):.2f} ms, "
        f"hybridized {statistics.median(wh[2:]):.2f} ms")
    check(gap <= SSD_FIRST_LOSS_RTOL, f"(i) first-step losses {gap:.3e}")
    wall = _wall_ms(step, 5)
    events = _gpu_trace(lambda: [step() for _ in range(3)])
    busy = _busy_us(events) / 1e3 / 3
    log(f"[vision] (i) a hybridized training step (forward and backward "
        f"one CUDA graph; targets, loss and SGD eager): wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}, "
        f"{b / wall * 1e3:.1f} img/s; card {smi_line}")
    for name, us in _top_ops(events):
        log(f"[vision] (i) top: {us / 1e3 / 3:8.3f} ms a step  {name[:100]}")
    cls_p, box_p, anchors = outs
    det_ms = time_ms(lambda: vision.ssd_detect(cls_p, box_p, anchors),
                     reps=5, rounds=3)
    det = vision.ssd_detect(cls_p, box_p, anchors).asnumpy()
    kept = int((det[..., 0] >= 0).sum())
    log(f"[vision] (i) ssd_detect (softmax, decode, per-class NMS, "
        f"nms_topk 400) at batch {b}: {det_ms:.3f} ms, {kept} rows kept")
    check(kept > 0 and det.shape == (b, cfg["anchors"], 6),
          f"(i) detections {det.shape}, {kept} kept")
    del runs, net, step, outs, cls_p, box_p, anchors
    _release()

    # the card against the CPU at batch 2, the CPU's targets on both
    n2 = VISION_CHECK_BATCH
    x2, l2 = x[:n2], labels[:n2]
    with mx.cpu():
        with autograd.record():
            want_outs = cpu_net(mnp.array(x2))
        cw = [o.asnumpy() for o in want_outs]
        tgt = [o.asnumpy() for o in vision.ssd_target(
            mnp.array(cw[2]), mnp.array(cw[0]), mnp.array(l2))]
        with autograd.record():
            loss_c, _ = _ssd_loss(cpu_net, mnp.array(x2), None,
                                  [mnp.array(t) for t in tgt])
        loss_c.backward()
        f64 = _f64_twin(lambda: vision.ssd_300_mobilenet(
            num_classes=cfg["classes"]), path)
        with autograd.record():
            loss_64, _ = _ssd_loss(f64, torch.from_numpy(x2).double(), None,
                                   [torch.from_numpy(t).double()
                                    for t in tgt])
        loss_64.backward()
        probs = npx.softmax(mnp.array(cw[0]), axis=-1).asnumpy()
        det_c = npx.multibox_detection(
            mnp.array(probs.transpose(0, 2, 1)), mnp.array(cw[1]),
            mnp.array(cw[2]), nms_threshold=0.45, threshold=0.01,
            nms_topk=400).asnumpy()
        sd_c = vision.ssd_detect(*(mnp.array(o) for o in cw)).asnumpy()
    with mx.gpu():
        gnet = card_net(False)
        with autograd.record():
            loss_g, got_outs = _ssd_loss(gnet, mnp.array(x2), None,
                                         [mnp.array(t) for t in tgt])
        loss_g.backward()
        cg = [o.asnumpy() for o in got_outs]
        tgt_g = [o.asnumpy() for o in vision.ssd_target(
            mnp.array(cw[2]), mnp.array(cw[0]), mnp.array(l2))]
        probs_g = npx.softmax(mnp.array(cw[0]), axis=-1).asnumpy()
        det_g = npx.multibox_detection(
            mnp.array(probs.transpose(0, 2, 1)), mnp.array(cw[1]),
            mnp.array(cw[2]), nms_threshold=0.45, threshold=0.01,
            nms_topk=400).asnumpy()
        sd_g = vision.ssd_detect(*(mnp.array(o) for o in cw)).asnumpy()
    out_gap = max(_np_rel(cg[0], cw[0]), _np_rel(cg[1], cw[1]))
    anc_gap = float(onp.abs(cg[2] - cw[2]).max())
    loss_gap = abs(float(loss_g.asnumpy()) - float(loss_c.asnumpy())) / \
        abs(float(loss_c.asnumpy()))
    log(f"[vision] (i) card vs CPU at batch {n2} (train mode, the CPU's "
        f"targets on both): cls/box outputs {out_gap:.3e} (limit "
        f"{VISION_RTOL}), anchors {anc_gap:.3e} absolute (limit "
        f"{VISION_ANCHOR_ATOL:.3e}), loss {loss_gap:.3e}; every parameter's "
        f"gradient card vs CPU {_top_grad_gap(gnet, cpu_net):.3e} of the "
        f"largest")
    check(out_gap <= VISION_RTOL and loss_gap <= VISION_RTOL and
          anc_gap <= VISION_ANCHOR_ATOL, "(i) SSD outputs card vs CPU")
    card_gap, cpu_gap, limit = _grad_check("(i)", gnet, cpu_net, f64)
    log(f"[vision] (i) gradients against the float64 CPU twin, of the "
        f"largest: card {card_gap:.3e}, CPU fp32 {cpu_gap:.3e} (limit "
        f"{limit:.3e})")
    t_gap = _np_rel(tgt_g[0], tgt[0])
    check(onp.array_equal(tgt_g[1], tgt[1]) and
          onp.array_equal(tgt_g[2], tgt[2]) and t_gap <= VISION_EXACT_RTOL,
          f"(i) ssd_target card vs CPU: loc {t_gap:.3e}")
    d_gap = _np_rel(det_g, det_c)
    check(onp.array_equal(det_g[..., 0], det_c[..., 0]) and
          d_gap <= VISION_EXACT_RTOL, f"(i) multibox_detection {d_gap:.3e}")
    p_gap = _np_rel(probs_g, probs)
    same_rows = float((sd_g == sd_c).all(-1).mean())
    log(f"[vision] (i) identical inputs, card vs CPU: ssd_target's masks "
        f"and classes bitwise ({int((tgt[2] > 0).sum())} positives, "
        f"{int((tgt[2] == 0).sum())} mined negatives), loc targets "
        f"{t_gap:.3e}; multibox_detection on the CPU's probabilities: "
        f"classes bitwise, rows {d_gap:.3e} ({int((det_c[..., 0] >= 0).sum())}"
        f" kept); ssd_detect's softmax {p_gap:.3e}, and its rows equal on "
        f"{same_rows:.4f} of them (near ties of the scores may swap)")
    del gnet, cpu_net, f64
    _release()


def _vision_zoo(smi_line, where):
    """(ii) every name get_model registers now, at ImageNet input."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    b = VISION_BATCH
    for name in VISION_ZOO:
        size = 299 if name == "inceptionv3" else 224
        kw = {} if name.startswith("ssd") else {"classes": 1000}
        with mx.gpu():
            net = vision.get_model(name, **kw)
            net.initialize(seed=SEED)
        x = torch.rand(b, 3, size, size, device=DEV)
        with torch.no_grad():
            out = net(x)
            if name.startswith("ssd"):
                a = out[2].shape[1]
                ok = (tuple(out[0].shape) == (b, a, 21) and
                      tuple(out[1].shape) == (b, 4 * a))
            else:
                ok = tuple(out.shape) == (b, 1000)
            check(ok, f"(ii) {name}: output shapes")
            eager = time_ms(lambda: net(x), reps=3, rounds=3)
            net.hybridize()
            net(x)
            hyb = time_ms(lambda: net(x), reps=3, rounds=3)
        log(f"[vision] (ii) {name:18s} at ({b}, 3, {size}, {size}): eager "
            f"{eager:8.2f} ms ({b / eager * 1e3:8.1f} img/s), hybridized "
            f"{hyb:8.2f} ms ({b / hyb * 1e3:8.1f} img/s)")
        del net, out, x
        _release()
    # one name of each family at batch 2: predict mode and one train-mode
    # step (BatchNorm on the batch's statistics), card against CPU
    rng = onp.random.RandomState(SEED + 152)
    for name in VISION_FAMILIES:
        size = 299 if name == "inceptionv3" else 224
        xs = rng.rand(VISION_CHECK_BATCH, 3, size, size).astype("float32")
        path = os.path.join(where, f"{name}.params")
        nets, res = [], []
        for ctx, dev, dt in ((mx.cpu(), "cpu", torch.float32),
                             (mx.gpu(), DEV, torch.float32),
                             (None, "cpu", torch.float64)):
            if ctx is None:
                net = _f64_twin(lambda: vision.get_model(name, classes=1000),
                                path)
            else:
                with ctx:
                    net = vision.get_model(name, classes=1000)
                    if not nets:
                        net.initialize(seed=SEED + 2)
                        with torch.no_grad():
                            net(torch.from_numpy(xs))
                        net.save_parameters(path)
                    else:
                        net.load_parameters(path)
            _drop_off(net)
            xt = torch.from_numpy(xs).to(dev, dt)
            with torch.no_grad():
                pred = net(xt).cpu().numpy()
            xg = xt.clone().requires_grad_(True)
            with autograd.record():
                y = net(xg)
                c = torch.from_numpy(onp.random.RandomState(3).randn(
                    *y.shape)).to(dev, dt)
                (y * c).sum().backward()
            res.append((pred, y.detach().cpu().numpy(),
                        xg.grad.cpu().numpy()))
            nets.append(net)
        (p0, y0, d0), (p1, y1, d1), (_, _, d64) = res
        gaps = (_np_rel(p1, p0), _np_rel(y1, y0))
        card_gap, cpu_gap, limit = _grad_check(f"(ii) {name}", nets[1],
                                               nets[0], nets[2])
        # the input's gradient is printed, not held: where a max-pool
        # window's two largest inputs lie within rounding of each other,
        # each run sends the gradient to its own pick (VGG16: 4.2e-2 of the
        # largest from float64 in every fp32 run, the CPU's too)
        log(f"[vision] (ii) {name} card vs CPU at batch "
            f"{VISION_CHECK_BATCH}: predict {gaps[0]:.3e}, train-mode "
            f"output {gaps[1]:.3e} (limit {VISION_RTOL}); from the float64 "
            f"twin: the parameters' gradients {card_gap:.3e} of the "
            f"largest (CPU fp32 {cpu_gap:.3e}, limit {limit:.3e}), the "
            f"input's {_np_rel(d1, d64):.3e} (CPU fp32 "
            f"{_np_rel(d0, d64):.3e}; not held)")
        check(max(gaps) <= VISION_RTOL, f"(ii) {name}: card vs CPU")
        del nets, net
        _release()
    log(f"[vision] (ii) card {smi_line}")


def _layer_both(make, x, where, tag):
    """A layer built on the CPU from a seed, saved, loaded on the card:
    (outputs, input gradient, parameter gradient gap) of each and the
    card's forward and forward+backward ms."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    path = os.path.join(where, f"{tag}.params")
    res, nets = [], []
    c = torch.from_numpy(onp.random.RandomState(4).randn(
        *x.shape[:1], DCN["filters"], *x.shape[2:]).astype("float32"))
    for ctx, dev in ((mx.cpu(), "cpu"), (mx.gpu(), DEV)):
        with ctx:
            layer = make()
            if not nets:
                layer.initialize(seed=SEED + 3)
                with torch.no_grad():
                    layer(torch.from_numpy(x))
                layer.save_parameters(path)
            else:
                layer.load_parameters(path)
            xt = torch.from_numpy(x).to(dev).requires_grad_(True)
            with autograd.record():
                y = layer(xt)
                (y * c.to(dev)).sum().backward()
            res.append((y.detach().cpu().numpy(), xt.grad.cpu().numpy()))
            nets.append(layer)
    xd = torch.from_numpy(x).to(DEV)
    with torch.no_grad():
        fwd = time_ms(lambda: nets[1](xd), reps=5, rounds=3)
    cd = c.to(DEV)

    def both():
        xg = xd.clone().requires_grad_(True)
        with autograd.record():
            (nets[1](xg) * cd).sum().backward()

    full = time_ms(both, reps=3, rounds=3)
    gaps = [_np_rel(res[1][i], res[0][i]) for i in range(2)]
    return gaps + [_top_grad_gap(nets[1], nets[0])], fwd, full


def _vision_warp(smi_line, where):
    """(iii) the warp and deformable ops at their models' sizes."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon import nn

    rng = onp.random.RandomState(SEED + 153)
    x = rng.randn(*DCN["data"]).astype("float32")
    for cls in ("DeformableConvolution", "ModulatedDeformableConvolution"):
        for dg in (1, 4):
            def make(cls=cls, dg=dg):
                return getattr(nn, cls)(
                    DCN["filters"], DCN["kernel"], padding=DCN["pad"],
                    dilation=DCN["dilate"], num_deformable_group=dg,
                    in_channels=DCN["data"][1],
                    offset_weight_initializer=mx.initializer.Normal(0.01))

            gaps, fwd, full = _layer_both(make, x, where, f"{cls}{dg}")
            log(f"[vision] (iii) {cls}(512, 3x3, pad 2, dilation 2, "
                f"num_deformable_group {dg}) on {DCN['data']}: output "
                f"{gaps[0]:.3e}, input gradient {gaps[1]:.3e}, parameters' "
                f"gradients {gaps[2]:.3e} of the largest (limit "
                f"{WARP_RTOL}); forward {fwd:.3f} ms, forward+backward "
                f"{full:.3f} ms")
            check(max(gaps) <= WARP_RTOL, f"(iii) {cls} dg {dg}")
            _release()
    r = RFCN
    data = rng.randn(*r["data"]).astype("float32")
    ih, iw = r["image"]
    x1 = rng.uniform(0, iw - 64, (r["rois"], 1))
    y1 = rng.uniform(0, ih - 64, (r["rois"], 1))
    w = rng.uniform(32, 400, (r["rois"], 1))
    h = rng.uniform(32, 400, (r["rois"], 1))
    rois = onp.concatenate([onp.zeros_like(x1), x1, y1,
                            onp.minimum(x1 + w, iw - 1),
                            onp.minimum(y1 + h, ih - 1)], 1).astype("float32")
    trans = rng.randn(r["rois"], 2, r["pooled"], r["pooled"]).astype(
        "float32")
    cases = [
        ("psroi_pooling", lambda d, ro: npx.psroi_pooling(
            d, ro, spatial_scale=r["scale"], output_dim=r["classes"],
            pooled_size=r["pooled"], group_size=r["group"]),
         [data, rois], (0,)),
        ("deformable_psroi_pooling (trans)",
         lambda d, ro, t: npx.deformable_psroi_pooling(
             d, ro, t, spatial_scale=r["scale"], output_dim=r["classes"],
             group_size=r["group"], pooled_size=r["pooled"],
             part_size=r["pooled"], sample_per_part=r["sample_per_part"],
             trans_std=r["trans_std"]), [data, rois, trans], (0, 2)),
    ]
    f = FLOWNET
    d1 = rng.randn(*f["data"]).astype("float32")
    d2 = rng.randn(*f["data"]).astype("float32")
    cases.append(("correlation (FlowNetC)", lambda a, b_: npx.correlation(
        a, b_, kernel_size=f["kernel_size"],
        max_displacement=f["max_displacement"], stride1=f["stride1"],
        stride2=f["stride2"], pad_size=f["pad_size"]), [d1, d2], (0, 1)))
    n, ch, hh, ww = SAMPLER_SHAPE
    img = rng.randn(*SAMPLER_SHAPE).astype("float32")
    grid = rng.uniform(-1.05, 1.05, (n, 2, hh, ww)).astype("float32")
    theta = (onp.array([1, 0, 0, 0, 1, 0]) + 0.2 * rng.randn(n, 6)).astype(
        "float32")
    flow = (2.0 * rng.randn(n, 2, hh, ww)).astype("float32")
    cases += [
        ("bilinear_sampler", lambda d, g: npx.bilinear_sampler(d, g),
         [img, grid], (0, 1)),
        ("grid_generator (affine)", lambda t: npx.grid_generator(
            t, transform_type="affine", target_shape=(hh, ww)), [theta], (0,)),
        ("grid_generator (warp)", lambda fl: npx.grid_generator(
            fl, transform_type="warp"), [flow], (0,)),
    ]
    for tag, fn, inputs, grads in cases:
        cpu, card, ms = _both_devices(fn, inputs, grads)
        gaps = [_np_rel(g, w_) for g, w_ in zip(card[0] + card[1],
                                                 cpu[0] + cpu[1])]
        shape = tuple(card[0][0].shape)
        log(f"[vision] (iii) {tag}: output {shape}, card vs CPU "
            f"{['%.3e' % g for g in gaps]} (output, then each gradient; "
            f"limit {WARP_RTOL}), {ms:.3f} ms a forward")
        check(max(gaps) <= WARP_RTOL, f"(iii) {tag}: {max(gaps):.3e}")
        _release()
    check(shape == (n, 2, hh, ww), "(iii) warp grid shape")
    for shape in SUBPIXEL:
        xs = rng.randn(*shape).astype("float32")
        cpu, card, ms = _both_devices(lambda a: nn.PixelShuffle2D(2)(a),
                                      [xs], (0,))
        check(all(onp.array_equal(g, w_) for g, w_ in
                  zip(card[0] + card[1], cpu[0] + cpu[1])),
              f"(iii) PixelShuffle2D {shape}")
        log(f"[vision] (iii) PixelShuffle2D(2) {shape} -> "
            f"{tuple(card[0][0].shape)}: output and gradient bitwise equal "
            f"to the CPU's, {ms:.3f} ms a forward")
    for cls, shape, factor in (("PixelShuffle1D", (4, 12, 9), 3),
                               ("PixelShuffle3D", (2, 16, 3, 4, 5), 2)):
        xs = rng.randn(*shape).astype("float32")
        cpu, card, _ = _both_devices(
            lambda a, cls=cls, factor=factor: getattr(nn, cls)(factor)(a),
            [xs], (0,))
        check(all(onp.array_equal(g, w_) for g, w_ in
                  zip(card[0] + card[1], cpu[0] + cpu[1])), f"(iii) {cls}")
    log(f"[vision] (iii) PixelShuffle1D(3) and PixelShuffle3D(2): bitwise "
        f"equal to the CPU's; card {smi_line}")


def _vision_stn(smi_line):
    """(iv) the STN example at its own size on the card, hybridized."""
    import mxnet_tpu_torch as mx

    stn = _tests_script("torch_script_stn")
    with mx.gpu():
        mx.random.seed(SEED)
        xs, ys = stn.make_translated_digits(512)
        t = time.perf_counter()
        acc_stn = stn.train(True, xs, ys)
        t_stn = time.perf_counter() - t
        t = time.perf_counter()
        acc_fixed = stn.train(False, xs, ys)
        t_fixed = time.perf_counter() - t
    log(f"[vision] (iv) tests/torch_script_stn.py's train, 512 digits, 40 "
        f"epochs of 8 batches, hybridized: STN train accuracy "
        f"{acc_stn:.4f}, fixed warp {acc_fixed:.4f}; an epoch "
        f"{t_stn / 40 * 1e3:.1f} ms with the STN, {t_fixed / 40 * 1e3:.1f} "
        f"ms without (the model's setup and the accuracy pass included); "
        f"card {smi_line}")
    check(acc_stn > STN_MIN_ACC and acc_stn > acc_fixed + STN_MARGIN,
          f"(iv) STN {acc_stn:.4f} against fixed {acc_fixed:.4f}")


def phase_vision(smi_line):
    """Phase 15: A9's vision part (see the module docstring). Returns the
    path's launch counts (no port kernel on it)."""
    import tempfile

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    ck.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="vision-") as where:
        t = time.perf_counter()
        _vision_ssd(smi_line, where)
        log(f"[vision] (i) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        _vision_zoo(smi_line, where)
        log(f"[vision] (ii) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        _vision_warp(smi_line, where)
        log(f"[vision] (iii) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _vision_stn(smi_line)
    log(f"[vision] (iv) took {time.perf_counter() - t:.1f} s")
    taken = read_counts("vision")
    log(f"[vision] launches of the port's kernels on this path: {taken}")
    took = time.perf_counter() - t_phase
    log(f"[vision] phase took {took:.1f} s (limit {VISION_LIMIT_S})")
    check(took <= VISION_LIMIT_S, f"phase 15 took {took:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 16: A9's RNN stack — the PTB-medium LSTM language model trained eager
# and hybridized, the rnn op against cuDNN's, the cells and word_lm
RNN_LM = dict(vocab=10000, embed=650, hidden=650, layers=2, dropout=0.5,
              batch=32, bptt=35, steps=20, lr=1e-3, clip=0.25)
RNN_FOLLOW = 0.3              # (i) the stream's share of fixed successors
RNN_CHECK_BATCH = 2           # (i) card against CPU, dropout 0
RNN_RTOL = 1e-5               # outputs and states: card vs CPU, op vs cuDNN
RNN_GRAD_RTOL = 1e-4          # (i) each gradient card vs CPU, of its largest
RNN_FIRST_LOSS_RTOL = 1e-5    # (i) eager vs hybridized first-step loss
RNN_OP = dict(T=35, B=32, H=650)    # (ii) the op at PTB-medium's shape
RNN_CELLS = dict(T=35, B=8, H=200)  # (iii) word_lm's own width
RNN_CELL_NAMES = ("RNNCell", "LSTMCell", "GRUCell", "LSTMPCell",
                  "SequentialRNNCell", "HybridSequentialRNNCell",
                  "DropoutCell", "ZoneoutCell", "ResidualCell",
                  "BidirectionalCell", "VariationalDropoutCell")
RNN_LIMIT_S = 150.0           # the phase's seconds, the build excluded


def _word_stream(n, vocab, seed):
    """``n`` tokens standing in for PTB's text: Zipf(1.1) frequencies, as
    words' in text, with RNN_FOLLOW of them the fixed successor of the
    token before (31 t + 7 mod vocab), something for the recurrence to
    learn. PTB is not in the repo and is not fetched."""
    rng = onp.random.RandomState(seed)
    draws = onp.minimum(rng.zipf(1.1, n), vocab) - 1
    follow = rng.rand(n) < RNN_FOLLOW
    out = onp.empty(n, "int32")
    out[0] = draws[0]
    for i in range(1, n):
        out[i] = (out[i - 1] * 31 + 7) % vocab if follow[i] else draws[i]
    return out


def _grad_gaps(card, cpu):
    """{name: |card grad - cpu grad| max over the CPU grad's largest}."""
    pc = card.collect_params()
    out = {}
    for name, p in cpu.collect_params().items():
        if p.grad is None:
            continue
        want = p.grad.detach().double()
        got = pc[name].grad.detach().cpu().double()
        out[name] = float((got - want).abs().max()) / \
            max(float(want.abs().max()), 1e-30)
    return out


def _lm_step_once(net, tokens, targets, ctx):
    """One word_lm forward and backward of ``net`` from zero states in the
    context ``ctx``: (logits, states, loss) as tensors."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import np as mnp

    with ctx:
        states = net.begin_state(tokens.shape[0])
        with autograd.record():
            logits, states = net(mnp.array(tokens), states)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                logits, mnp.array(targets)).mean()
        loss.backward()
    return logits._data, [s._data for s in states], loss._data


def _rnn_lm(smi_line, where):
    """(i) the PTB-medium LSTM LM: word_lm's loop eager and hybridized at
    B = 32, T = 35, and one step card against CPU at B = 2."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch.gluon.model_zoo import rnn_lm

    cfg = RNN_LM
    b, t, vocab = cfg["batch"], cfg["bptt"], cfg["vocab"]
    stream = _word_stream(b * (t * cfg["steps"] + 1), vocab,
                          SEED + 16).reshape(b, -1)

    def make(dropout):
        return rnn_lm.rnn_lm(vocab_size=vocab, embed_size=cfg["embed"],
                             hidden_size=cfg["hidden"],
                             num_layers=cfg["layers"], dropout=dropout,
                             tie_weights=True)

    path = os.path.join(where, "ptb_medium.params")
    with mx.cpu():
        cpu_net = make(0.0)
        cpu_net.initialize(mx.initializer.Xavier(), seed=SEED + 16)
        cpu_net(mnp.array(stream[:1, :t]))      # the deferred input size
        cpu_net.save_parameters(path)
    n_params = sum(p.numel() for p in cpu_net.collect_params().values())

    runs = {}
    for hyb in (False, True):
        tag = "hybridized" if hyb else "eager"
        with mx.gpu():
            net = make(cfg["dropout"])
            net.load_parameters(path)
            if hyb:
                net.hybridize()
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": cfg["lr"],
                                "clip_gradient": cfg["clip"]})
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            held = {"states": net.begin_state(b)}

            def step(i, net=net, tr=tr, held=held, loss_fn=loss_fn):
                data = mnp.array(stream[:, i:i + t])
                target = mnp.array(stream[:, i + 1:i + 1 + t])
                states = [s.detach() for s in held["states"]]
                with autograd.record():
                    logits, states = net(data, states)
                    loss = loss_fn(logits, target).mean()
                loss.backward()
                tr.step(1)
                held["states"] = states
                return loss

            mx.random.seed(SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held_before = torch.cuda.memory_allocated() / 2 ** 20
            losses, walls = [], []
            for k in range(cfg["steps"]):
                t0 = time.perf_counter()
                losses.append(float(step(k * t).asnumpy()))
                walls.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 20 - held_before
            check(all(math.isfinite(v) for v in losses) and
                  losses[-1] < losses[0], f"(i) {tag} losses {losses}")
            check(all(s._data.is_cuda for s in held["states"]),
                  f"(i) {tag}: the detached states left the card")
            wall = _wall_ms(lambda: step(0), 5)
            calls = {}
            events = _gpu_trace(lambda: [step(0) for _ in range(3)], calls)
            busy = _busy_us(events) / 1e3 / 3
            kernels = sum(1 for e in events if e[0] == "kernel") / 3
            launches = {k: v / 3 for k, v in sorted(calls.items())}
            log(f"[rnn] (i) {tag}: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
                f"in {cfg['steps']} steps; step wall (median of steps "
                f"3-{cfg['steps']}, the loss read) "
                f"{statistics.median(walls[2:]):.2f} ms; a step synchronised "
                f"{wall:.3f} ms wall, device busy {busy:.3f} ms, idle share "
                f"{1 - busy / wall:.3f}, {b * t / wall * 1e3:.1f} tokens/s; "
                f"peak memory {peak:.1f} MiB above the {held_before:.1f} MiB "
                f"held before the run; {kernels:.0f} device kernels "
                f"and host launch calls {launches} a step; card {smi_line}")
            for name, us in _top_ops(events):
                log(f"[rnn] (i) {tag} top: {us / 1e3 / 3:8.3f} ms a step  "
                    f"{name[:100]}")
            if hyb:
                stats = next(iter(net._cached.values()))[0].graph_stats()
                log(f"[rnn] (i) hybridized programs: {stats}")
            runs[hyb] = losses
            del net, tr, held, step
            _release()
    gap = abs(runs[False][0] - runs[True][0]) / abs(runs[False][0])
    log(f"[rnn] (i) rnn_lm(vocab {vocab}, embed {cfg['embed']}, hidden "
        f"{cfg['hidden']}, {cfg['layers']} layers, dropout "
        f"{cfg['dropout']}, tied), {n_params} parameters, B {b} x T {t}, "
        f"adam {cfg['lr']} clip {cfg['clip']}: first-step losses eager "
        f"{runs[False][0]:.6f}, hybridized {runs[True][0]:.6f}, "
        f"{gap:.3e} apart (limit {RNN_FIRST_LOSS_RTOL})")
    check(gap <= RNN_FIRST_LOSS_RTOL, f"(i) first-step losses {gap:.3e}")

    # one step, the card against the CPU at B = 2, dropout 0
    n2 = RNN_CHECK_BATCH
    tok2, tgt2 = stream[:n2, :t], stream[:n2, 1:t + 1]
    cl, cs, closs = _lm_step_once(cpu_net, tok2, tgt2, mx.cpu())
    with mx.gpu():
        card = make(0.0)
        card.load_parameters(path)
    gl, gs, gloss = _lm_step_once(card, tok2, tgt2, mx.gpu())
    out_gap = max(_max_rel(gl, cl), *(_max_rel(g, c) for g, c in
                                      zip(gs, cs)))
    gaps = _grad_gaps(card, cpu_net)
    worst = max(gaps, key=gaps.get)
    log(f"[rnn] (i) card vs CPU at B {n2}, dropout 0: logits and states "
        f"{out_gap:.3e} of the largest (limit {RNN_RTOL}), loss "
        f"{float(gloss.detach()):.7f} / {float(closs.detach()):.7f}; "
        f"gradients, each of its largest: worst {gaps[worst]:.3e} "
        f"({worst}; limit {RNN_GRAD_RTOL})")
    check(out_gap <= RNN_RTOL, f"(i) outputs card vs CPU {out_gap:.3e}")
    check(gaps[worst] <= RNN_GRAD_RTOL,
          f"(i) gradients card vs CPU {gaps[worst]:.3e} ({worst})")
    del card, cpu_net
    _release()


def _rnn_weights(rng, mode, layers, ndir, n_in, n_h, device):
    """The op's flat weights, uniform in +-1/sqrt(hidden) as cuDNN's
    default."""
    import torch

    from mxnet_tpu_torch.ops.rnn import GATES

    ng, k = GATES[mode], 1.0 / math.sqrt(n_h)
    out = []
    for layer in range(layers):
        width = n_in if layer == 0 else n_h * ndir
        for _ in range(ndir):
            for shape in ((ng * n_h, width), (ng * n_h, n_h), (ng * n_h,),
                          (ng * n_h,)):
                out.append(torch.tensor(
                    rng.uniform(-k, k, shape).astype("float32"),
                    device=device, requires_grad=True))
    return out


def _cudnn_twin(mode, layers, ndir, n_h, weights):
    """torch.nn.LSTM / GRU / RNN (cuDNN on the card) holding ``weights``;
    gate orders are the reference's (i, f, g, o; r, z, n)."""
    import torch

    kw = dict(num_layers=layers, bidirectional=ndir == 2)
    if mode == "lstm":
        mod = torch.nn.LSTM(n_h, n_h, **kw)
    elif mode == "gru":
        mod = torch.nn.GRU(n_h, n_h, **kw)
    else:
        mod = torch.nn.RNN(n_h, n_h, nonlinearity=mode[4:], **kw)
    mod = mod.cuda()
    with torch.no_grad():
        k = 0
        for layer in range(layers):
            for d in range(ndir):
                sfx = f"l{layer}" + ("_reverse" if d else "")
                for name in ("weight_ih", "weight_hh", "bias_ih",
                             "bias_hh"):
                    getattr(mod, f"{name}_{sfx}").copy_(weights[k])
                    k += 1
    return mod


def _rnn_op_vs_cudnn(smi_line):
    """(ii) the ``rnn`` op alone at (35, 32, 650), every mode, one and two
    layers, one and two directions: forward and forward+backward ms eager
    and replayed from a CUDA graph, beside cuDNN's (``torch.nn.LSTM`` /
    ``GRU`` / ``RNN`` holding the same weights) and its outputs."""
    import torch

    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.rnn import MODES

    T, B, H = RNN_OP["T"], RNN_OP["B"], RNN_OP["H"]
    rng = onp.random.RandomState(SEED + 161)
    for mode in MODES:
        for layers in (1, 2):
            for ndir in (1, 2):
                n = layers * ndir
                x = torch.tensor(rng.randn(T, B, H).astype("float32"),
                                 device="cuda", requires_grad=True)
                states = [torch.tensor((0.5 * rng.randn(n, B, H)).astype(
                    "float32"), device="cuda") for _ in
                    range(2 if mode == "lstm" else 1)]
                ws = _rnn_weights(rng, mode, layers, ndir, H, H, "cuda")
                f = get_op("rnn").fn(mode=mode, num_layers=layers,
                                     hidden_size=H,
                                     bidirectional=ndir == 2, dropout=0.0)
                ref = _cudnn_twin(mode, layers, ndir, H, ws)
                args = [x, *states, *ws]
                gout = torch.tensor(rng.randn(T, B, H * ndir).astype(
                    "float32"), device="cuda")
                leaves = [x, *ws]
                with torch.no_grad():
                    got = f(*args)
                    want = ref(x, tuple(states) if mode == "lstm"
                               else states[0])
                want = [want[0], *(want[1] if mode == "lstm"
                                   else (want[1],))]
                gap = max(_max_rel(g, w) for g, w in zip(got, want))
                cudnn_params = list(ref.parameters())

                def fwd():
                    with torch.no_grad():
                        f(*args)

                def fwd_bwd():
                    torch.autograd.grad(f(*args)[0], leaves, gout)

                def ref_fwd():
                    with torch.no_grad():
                        ref(x, tuple(states) if mode == "lstm"
                            else states[0])

                def ref_fwd_bwd():
                    out = ref(x, tuple(states) if mode == "lstm"
                              else states[0])[0]
                    torch.autograd.grad(out, [x, *cudnn_params], gout)

                ms = {"fwd": time_ms(fwd, reps=3, rounds=3),
                      "fwd+bwd": time_ms(fwd_bwd, reps=3, rounds=3),
                      "fwd replayed": graph_ms(fwd, reps=1, rounds=3),
                      "fwd+bwd replayed": graph_ms(fwd_bwd, reps=1,
                                                   rounds=3),
                      "cudnn fwd": time_ms(ref_fwd, reps=3, rounds=3),
                      "cudnn fwd+bwd": time_ms(ref_fwd_bwd, reps=3,
                                               rounds=3)}
                log(f"[rnn] (ii) {mode} {layers} layer(s) "
                    f"{'bi' if ndir == 2 else 'uni'} at ({T}, {B}, {H}): "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
                    + f"; outputs and states vs cuDNN {gap:.3e} (limit "
                    f"{RNN_RTOL}); card {smi_line}")
                check(gap <= RNN_RTOL,
                      f"(ii) {mode} {layers} {ndir}: {gap:.3e} from cuDNN")
                del x, states, ws, ref, args, leaves, cudnn_params
    _release()


def _rnn_cell(rnn, name, n_h, n_in):
    if name == "RNNCell":
        return rnn.RNNCell(n_h, input_size=n_in)
    if name == "LSTMCell":
        return rnn.LSTMCell(n_h, input_size=n_in)
    if name == "GRUCell":
        return rnn.GRUCell(n_h, input_size=n_in)
    if name == "LSTMPCell":
        return rnn.LSTMPCell(n_h, n_h // 2, input_size=n_in)
    if name in ("SequentialRNNCell", "HybridSequentialRNNCell"):
        cell = getattr(rnn, name)()
        cell.add(rnn.LSTMCell(n_h, input_size=n_in))
        cell.add(rnn.GRUCell(n_h, input_size=n_h))
        return cell
    if name == "DropoutCell":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(n_h, input_size=n_in))
        cell.add(rnn.DropoutCell(0.5))
        return cell
    if name == "ZoneoutCell":
        return rnn.ZoneoutCell(rnn.LSTMCell(n_h, input_size=n_in), 0.5, 0.5)
    if name == "ResidualCell":
        return rnn.ResidualCell(rnn.GRUCell(n_in, input_size=n_in))
    if name == "BidirectionalCell":
        return rnn.BidirectionalCell(rnn.LSTMCell(n_h, input_size=n_in),
                                     rnn.GRUCell(n_h, input_size=n_in))
    return rnn.VariationalDropoutCell(rnn.LSTMCell(n_h, input_size=n_in),
                                      0.5, 0.5, 0.5)


def _rnn_cells(smi_line, where):
    """(iii) every cell's ``unroll`` (NTC, ``valid_length``, predict mode)
    on the card against the CPU on the same weights and inputs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch.gluon import rnn

    T, B, H = RNN_CELLS["T"], RNN_CELLS["B"], RNN_CELLS["H"]
    rng = onp.random.RandomState(SEED + 162)
    x = rng.randn(B, T, H).astype("float32")
    valid = rng.randint(1, T + 1, B).astype("int32")
    rows = []
    for k, name in enumerate(RNN_CELL_NAMES):
        path = os.path.join(where, f"cell{k}.params")
        with mx.cpu():
            cpu = _rnn_cell(rnn, name, H, H)
            cpu.initialize(mx.initializer.Uniform(0.1), seed=SEED + k)
            want = cpu.unroll(T, mnp.array(x), merge_outputs=True,
                              valid_length=mnp.array(valid))
            cpu.save_parameters(path)
        with mx.gpu():
            card = _rnn_cell(rnn, name, H, H)
            card.load_parameters(path)
            xd, vd = mnp.array(x), mnp.array(valid)

            def run(card=card, xd=xd, vd=vd):
                return card.unroll(T, xd, merge_outputs=True,
                                   valid_length=vd)

            got = run()
            ms = time_ms(run, reps=3, rounds=3)
        gap = max(_max_rel(g._data, w._data) for g, w in
                  zip([got[0], *got[1]], [want[0], *want[1]]))
        rows.append(f"{name} {gap:.2e} ({ms:.2f} ms)")
        check(gap <= RNN_RTOL, f"(iii) {name}: card vs CPU {gap:.3e}")
    log(f"[rnn] (iii) unroll at B {B}, T {T}, {H} wide, valid lengths "
        f"{valid.tolist()}, card vs CPU (limit {RNN_RTOL}; the card's eager "
        f"unroll ms): " + "; ".join(rows) + f"; card {smi_line}")


def _rnn_word_lm(smi_line):
    """(iii) ``tests/torch_script_word_lm.py`` at its own defaults for one
    epoch on the card."""
    import contextlib
    import io as _io

    import mxnet_tpu_torch as mx

    wl = _tests_script("torch_script_word_lm")
    buf = _io.StringIO()
    t = time.perf_counter()
    with mx.gpu(), contextlib.redirect_stdout(buf):
        epochs = wl.main(["--epochs", "1"])
    took = time.perf_counter() - t
    loss, ppl = epochs[0]
    log(f"[rnn] (iii) tests/torch_script_word_lm.py --epochs 1 (its "
        f"defaults: 100,000 synthetic tokens, vocab 64, hidden 200, 2 "
        f"layers, B 32, bptt 35, adam 1e-3, clip 0.25, dropout 0.2, tied): "
        f"{buf.getvalue().strip()}; loss {loss:.4f}, perplexity {ppl:.3f}, "
        f"{took:.1f} s with the model's setup; card {smi_line}")
    check(math.isfinite(loss) and ppl < 64,
          f"(iii) word_lm loss {loss}, perplexity {ppl}")


def phase_rnn(smi_line):
    """Phase 16: A9's RNN stack (see the module docstring). Returns the
    path's launch counts (no port kernel on it)."""
    import tempfile

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    ck.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="rnn-") as where:
        t = time.perf_counter()
        _rnn_lm(smi_line, where)
        log(f"[rnn] (i) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        _rnn_op_vs_cudnn(smi_line)
        log(f"[rnn] (ii) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        _rnn_cells(smi_line, where)
    _rnn_word_lm(smi_line)
    log(f"[rnn] (iii) took {time.perf_counter() - t:.1f} s")
    taken = read_counts("rnn")
    log(f"[rnn] launches of the port's kernels on this path: {taken}")
    took = time.perf_counter() - t_phase
    log(f"[rnn] phase took {took:.1f} s (limit {RNN_LIMIT_S})")
    check(took <= RNN_LIMIT_S, f"phase 16 took {took:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 17: A9 (b)'s legacy tensor tier — MXNet's legacy-symbol AlexNet
# trained through simple_bind, every name of the tier on the card against
# the CPU, and the heavy ops at the sizes that use them
LEGACY_ALEX = dict(batch=128, image=224, classes=1000, steps=12, batches=4,
                   width=1)
LEGACY_CHECK_BATCH = 2        # (i) card against CPU, dropout 0
LEGACY_RTOL = 1e-5            # (i) loss and probabilities, card vs CPU
LEGACY_GRAD_RTOL = 1e-4       # (i) gradients: the floor of the twin limit
LEGACY_GRAD_FACTOR = 4.0      # (i) ... or this times the CPU fp32 run's gap
LEGACY_LRN_SITES = ((128, 96, 54, 54), (128, 256, 26, 26))   # lrn1, lrn2
LEGACY_LRN_RTOL = 1e-5        # (iii) LRN card vs CPU and vs F.lrn
LEGACY_LINALG = (256, 64, 64)             # (iii) SPD batch, fp32
LEGACY_LINALG_RTOL = 1e-4     # (iii) against float64 on the CPU
LEGACY_RROI = dict(data=(2, 256, 50, 50), rois=512, pooled=(7, 7),
                   scale=1.0 / 16)
LEGACY_RROI_RTOL = 1e-4       # (iii) card vs CPU
LEGACY_MASK = (32 * 512, 768, 0.15)       # (iii) BERT's masked positions
LEGACY_UNIQUE = (1 << 20, 30522)          # (iii) token ids, BERT's vocab
LEGACY_LIMIT_S = 120.0        # the phase's seconds, the build excluded


def _legacy_grad_gaps(card, cpu, twin):
    """{name: (card gap, CPU gap)} of each gradient from the float64
    twin's, over the twin's largest entry."""
    out = {}
    for n, t in twin.items():
        scale = max(float(abs(t).max()), 1e-30)
        out[n] = (float(abs(card[n] - t).max()) / scale,
                  float(abs(cpu[n] - t).max()) / scale)
    return out


def _legacy_alexnet(smi_line):
    """(i) the legacy AlexNet at batch 128, 224^2, 1000 classes through
    ``simple_bind`` / ``forward`` / ``backward`` / ``get_updater(SGD)``;
    the predict-mode bind; and one batch-2 step card against CPU."""
    import torch

    import mxnet_tpu_torch as mx

    alex = _tests_script("torch_script_legacy_alexnet")
    cfg = LEGACY_ALEX
    b, img, classes, wd = (cfg["batch"], cfg["image"], cfg["classes"],
                           cfg["width"])
    sym = alex.alexnet_symbol(mx, wd, classes, b)
    weights = alex.init_weights(wd, img, classes, seed=SEED + 17)
    batches = alex.synthetic_batches(cfg["batches"], b, img, classes,
                                     seed=SEED + 17)
    n_params = sum(w.size for w in weights.values())
    ctx = mx.gpu()
    with ctx:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated() / 2 ** 20
        exe = alex.bind(mx, sym, weights, b, img, ctx)
        check(all(a._data.is_cuda for a in exe.arg_dict.values()) and
              all(a.grad._data.is_cuda for n, a in exe.arg_dict.items()
                  if n in alex.param_names(sym)),
              "(i) an argument or gradient of the Executor left the card")
        t = time.perf_counter()
        losses = alex.train(mx, exe, sym, batches, cfg["steps"], ctx)
        train_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 20 - held_before
        nb = cfg["batches"]
        first, last = statistics.mean(losses[:nb]), \
            statistics.mean(losses[-nb:])
        check(all(math.isfinite(v) for v in losses) and last < first,
              f"(i) losses {losses}")
        # the step alone, its batch staged on the card
        data = mx.nd.array(batches[0][0], ctx=ctx)
        label = mx.nd.array(batches[0][1], ctx=ctx)
        opt = mx.optimizer.SGD(learning_rate=0.01, momentum=0.9, wd=5e-4)
        updater = mx.optimizer.get_updater(opt)
        names = alex.param_names(sym)

        def step():
            exe.forward(is_train=True, data=data, label=label)
            exe.backward()
            for i, n in enumerate(names):
                w = exe.arg_dict[n]
                updater(i, w.grad, w)

        step()
        wall = _wall_ms(step, 5)
        calls = {}
        events = _gpu_trace(lambda: [step() for _ in range(3)], calls)
        busy = _busy_us(events) / 1e3 / 3
        kernels = sum(1 for e in events if e[0] == "kernel") / 3
        launches = {k: v / 3 for k, v in sorted(calls.items())}
        stats = exe._cop.graph_stats()
        log(f"[legacy] (i) AlexNet (legacy symbol, {n_params} parameters, "
            f"LRN after relu1 and relu2) B {b} x 3 x {img} x {img}, "
            f"{classes} classes, SGD 0.01 momentum 0.9 wd 5e-4, dropout "
            f"0.5, {nb} batches cycled, {cfg['steps']} steps ({train_s:.2f} s "
            f"with the captures): the mean loss of the first pass over the "
            f"batches {first:.5f}, of the last {last:.5f}; losses "
            f"{[round(v, 5) for v in losses]}")
        log(f"[legacy] (i) a step (forward + backward replays, 16 SGD "
            f"updates, the batch on the card) {wall:.3f} ms wall, device "
            f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
            f"{b / wall * 1e3:.1f} img/s; peak memory {peak:.1f} MiB above "
            f"the {held_before:.1f} MiB held before; {kernels:.0f} device "
            f"kernels and host launch calls {launches} a step; the "
            f"Executor's programs {stats}; card {smi_line}")
        top = _top_ops(events, 8)
        for name, us in top:
            log(f"[legacy] (i) top: {us / 1e3 / 3:8.3f} ms a step  "
                f"{name[:100]}")
        # the predict-mode bind
        psym = alex.alexnet_symbol(mx, wd, classes, b, train=False)
        pexe = alex.bind(mx, psym, weights, b, img, ctx, grad_req="null")
        probs = pexe.forward(is_train=False, data=data)[0]
        rows = probs.asnumpy().sum(-1)
        check(probs.shape == (b, classes) and
              float(abs(rows - 1).max()) <= 1e-5,
              f"(i) predict rows sum to {rows.min()}..{rows.max()}")
        pms = _wall_ms(lambda: pexe.forward(is_train=False, data=data), 5)
        log(f"[legacy] (i) predict bind (SoftmaxActivation head, "
            f"is_train=False): {pms:.3f} ms a batch, {b / pms * 1e3:.1f} "
            f"img/s; rows sum to 1 within {float(abs(rows - 1).max()):.2e}")
        del exe, pexe, data, label, probs
        _release()

    # one step at B = 2, dropout 0: the card against the CPU and float64
    n2 = LEGACY_CHECK_BATCH
    sym2 = alex.alexnet_symbol(mx, wd, classes, n2, dropout=0.0)
    psym2 = alex.alexnet_symbol(mx, wd, classes, n2, train=False)
    batch2 = (batches[0][0][:n2], batches[0][1][:n2])
    res = {}
    for name, ctx in (("cpu", mx.cpu()), ("gpu", mx.gpu())):
        with ctx:
            exe = alex.bind(mx, sym2, weights, n2, img, ctx)
            out = exe.forward(is_train=True,
                              data=mx.nd.array(batch2[0], ctx=ctx),
                              label=mx.nd.array(batch2[1], ctx=ctx))
            exe.backward()
            pexe = alex.bind(mx, psym2, weights, n2, img, ctx,
                             grad_req="null")
            prob = pexe.forward(is_train=False,
                                data=mx.nd.array(batch2[0], ctx=ctx))[0]
            res[name] = (out[0].asnumpy(), prob.asnumpy(), {
                n: exe.arg_dict[n].grad.asnumpy()
                for n in alex.param_names(sym2)})
            del exe, pexe
    twin = alex.f64_grads(mx, sym2, weights, batch2)
    loss_gap = _np_rel(res["gpu"][0], res["cpu"][0])
    prob_gap = _np_rel(res["gpu"][1], res["cpu"][1])
    gaps = _legacy_grad_gaps(res["gpu"][2], res["cpu"][2], twin)
    worst = max(gaps, key=lambda n: gaps[n][0] /
                max(LEGACY_GRAD_FACTOR * gaps[n][1], LEGACY_GRAD_RTOL))
    g, c = gaps[worst]
    limit = max(LEGACY_GRAD_FACTOR * c, LEGACY_GRAD_RTOL)
    log(f"[legacy] (i) card vs CPU at B {n2}, dropout 0: loss "
        f"{loss_gap:.3e} and probabilities {prob_gap:.3e} of the largest "
        f"(limit {LEGACY_RTOL}); gradients from a float64 twin, each of its "
        f"largest: card worst {max(v[0] for v in gaps.values()):.3e}, CPU "
        f"fp32 worst {max(v[1] for v in gaps.values()):.3e}; nearest its "
        f"limit {worst}: card {g:.3e}, CPU {c:.3e}, limit {limit:.3e}")
    check(loss_gap <= LEGACY_RTOL and prob_gap <= LEGACY_RTOL,
          f"(i) loss {loss_gap:.3e} / probabilities {prob_gap:.3e}")
    check(g <= limit, f"(i) gradient {worst}: {g:.3e} > {limit:.3e}")
    _release()
    return busy


def _legacy_sweep(smi_line):
    """(ii) every name of the tier on the card against the CPU, on the CPU
    tests' inputs; the data-dependent ones also refused inside a
    capture."""
    import torch

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.registry import get_op

    lc = _tests_script("torch_legacy_cases")
    held, refused, failed, eig = 0, 0, {}, "runs"
    for name in sorted(lc.ALL):
        try:
            lc.check_card(name)
            held += 1
        except MXNetError as e:
            if lc.target(name) in ("linalg_eig", "linalg_eigvals") and \
                    "torch.linalg.eig does not run" in str(e):
                eig = f"refused: {e}"
                held += 1
            else:
                failed[name] = repr(e)[:200]
        except Exception as e:  # noqa: BLE001 — a failed name, reported
            failed[name] = repr(e)[:200]
    for name in lc.DATA_DEPENDENT:
        ins = [torch.from_numpy(a).cuda() for a in lc.inputs(name, 0)]
        f = get_op(name).fn(**lc.cases(name)[0][1])
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        torch.cuda.synchronize()
        ok = False
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                try:
                    f(*ins)
                except MXNetError as e:
                    ok = f"op '{name}'" in str(e)
        torch.cuda.synchronize()
        if ok:
            refused += 1
        else:
            failed[name + " (capture)"] = "ran or failed otherwise"
    log(f"[legacy] (ii) {len(lc.ALL)} names card vs CPU: {held} held; "
        f"{refused} of {len(lc.DATA_DEPENDENT)} data-dependent names raised "
        f"MXNetError inside a CUDA graph capture as expected; "
        f"linalg_eig on the card: {eig}; failed: {failed or 'none'}; card "
        f"{smi_line}")
    check(not failed, f"(ii) names failed: {sorted(failed)}")


def _legacy_heavy(smi_line, step_busy_ms):
    """(iii) LRN at AlexNet's two sites beside F.local_response_norm, the
    linalg family on a (256, 64, 64) SPD batch against float64,
    rroi_align, boolean_mask and unique at the sizes that use them."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.registry import get_op

    rng = onp.random.RandomState(SEED + 17)
    lrn = get_op("lrn").fn(alpha=1e-4, beta=0.75, knorm=2.0, nsize=5)
    share = 0.0
    for site, shape in zip(("lrn1", "lrn2"), LEGACY_LRN_SITES):
        x = torch.from_numpy(onp.maximum(rng.randn(*shape), 0).astype(
            "float32") * 4)
        g = torch.from_numpy(rng.randn(*shape).astype("float32"))
        xc = x.cuda().requires_grad_()
        gc_ = g.cuda()
        lib = F.local_response_norm(xc.detach(), 5, alpha=1e-4, beta=0.75,
                                    k=2.0)
        out = lrn(xc.detach())
        xh = x.clone().requires_grad_()
        cpu_out = lrn(xh)
        (cpu_grad,) = torch.autograd.grad(cpu_out, xh, g)
        (card_grad,) = torch.autograd.grad(lrn(xc), xc, gc_)
        gaps = (_max_rel(out, cpu_out), _max_rel(card_grad, cpu_grad),
                _max_rel(lib, out))
        fwd = graph_ms(lambda: lrn(xc.detach()), reps=5)
        lib_fwd = graph_ms(lambda: F.local_response_norm(
            xc.detach(), 5, alpha=1e-4, beta=0.75, k=2.0), reps=5)

        def both(f):
            def run():
                y = f(xc)
                return torch.autograd.grad(y, xc, gc_)
            return run

        fb = time_ms(both(lrn), reps=5, rounds=3)
        lib_fb = time_ms(both(lambda t: F.local_response_norm(
            t, 5, alpha=1e-4, beta=0.75, k=2.0)), reps=5, rounds=3)
        share += fb
        log(f"[legacy] (iii) {site} LRN at {shape}: card vs CPU out "
            f"{gaps[0]:.3e}, grad {gaps[1]:.3e}; F.local_response_norm vs "
            f"the op {gaps[2]:.3e} (limit {LEGACY_LRN_RTOL}); forward "
            f"{fwd:.3f} ms (F.local_response_norm {lib_fwd:.3f} ms), "
            f"forward+backward {fb:.3f} ms (F.local_response_norm "
            f"{lib_fb:.3f} ms); card {smi_line}")
        check(max(gaps) <= LEGACY_LRN_RTOL, f"(iii) {site}: {gaps}")
        del x, g, xc, gc_, lib, out, card_grad
    log(f"[legacy] (iii) LRN's forward+backward at its two sites "
        f"{share:.3f} ms, {share / step_busy_ms:.3f} of (i)'s step device "
        f"busy {step_busy_ms:.3f} ms")

    # the linalg family against float64 on the CPU
    n = LEGACY_LINALG
    a = rng.randn(*n)
    spd = a @ onp.swapaxes(a, -1, -2) + n[-1] * onp.eye(n[-1])
    rhs = rng.randn(*n)
    spd32, rhs32 = (torch.from_numpy(v.astype("float32")).cuda()
                    for v in (spd, rhs))
    spd64, rhs64 = torch.from_numpy(spd), torch.from_numpy(rhs)
    chol32 = get_op("linalg_potrf").fn()(spd32)
    chol64 = get_op("linalg_potrf").fn()(spd64)
    rows = []
    for name, args32, args64 in (
            ("linalg_gemm2", (spd32, rhs32), (spd64, rhs64)),
            ("linalg_potrf", (spd32,), (spd64,)),
            ("linalg_trsm", (chol32, rhs32), (chol64, rhs64)),
            ("linalg_potri", (chol32,), (chol64,)),
            ("linalg_syevd", (spd32,), (spd64,))):
        f = get_op(name).fn()
        got, want = f(*args32), f(*args64)
        if name == "linalg_syevd":
            u, w = got
            recon = u.mT.double() @ (w.double()[..., None] * u.double())
            gap = max(_max_rel(recon, spd64), _max_rel(w, want[1]))
        else:
            gap = _max_rel(got, want)
        # eager: the factorizations check cuSOLVER's info on the host
        ms = time_ms(lambda f=f, args32=args32: f(*args32), reps=3,
                     rounds=3)
        rows.append(f"{name} {gap:.3e} {ms:.3f} ms")
        check(gap <= LEGACY_LINALG_RTOL, f"(iii) {name}: {gap:.3e}")
    log(f"[legacy] (iii) linalg on {n} SPD fp32 against float64 on the CPU "
        f"(syevd by U^T diag(w) U; limit {LEGACY_LINALG_RTOL}): "
        + "; ".join(rows) + f"; card {smi_line}")

    # rroi_align, boolean_mask, unique
    cfg = LEGACY_RROI
    data = rng.rand(*cfg["data"]).astype("float32")
    size = cfg["data"][-1] / cfg["scale"]
    rois = onp.zeros((cfg["rois"], 6), "float32")
    rois[:, 0] = rng.randint(0, cfg["data"][0], cfg["rois"])
    rois[:, 1:3] = rng.uniform(0, size, (cfg["rois"], 2))
    rois[:, 3:5] = rng.uniform(16, size / 2, (cfg["rois"], 2))
    rois[:, 5] = rng.uniform(-180, 180, cfg["rois"])
    f = get_op("rroi_align").fn(pooled_size=cfg["pooled"],
                                spatial_scale=cfg["scale"])
    td, tr = torch.from_numpy(data), torch.from_numpy(rois)
    dc, rc = td.cuda(), tr.cuda()
    gap = _max_rel(f(dc, rc), f(td, tr))
    ms = time_ms(lambda: f(dc, rc), reps=5, rounds=3)
    log(f"[legacy] (iii) rroi_align {cfg['data']}, {cfg['rois']} rotated "
        f"ROIs, {cfg['pooled']}: card vs CPU {gap:.3e} (limit "
        f"{LEGACY_RROI_RTOL}), {ms:.3f} ms")
    check(gap <= LEGACY_RROI_RTOL, f"(iii) rroi_align {gap:.3e}")
    rows_n, width, frac = LEGACY_MASK
    hidden = torch.from_numpy(rng.randn(rows_n, width).astype("float32"))
    mask = torch.from_numpy((rng.rand(rows_n) < frac).astype("float32"))
    f = get_op("boolean_mask").fn()
    got, want = f(hidden.cuda(), mask.cuda()), f(hidden, mask)
    check(torch.equal(got.cpu(), want), "(iii) boolean_mask card != CPU")
    hc, mc = hidden.cuda(), mask.cuda()
    ms = time_ms(lambda: f(hc, mc), reps=5, rounds=3)
    log(f"[legacy] (iii) boolean_mask ({rows_n}, {width}) keeping "
        f"{want.shape[0]} rows ({frac:.0%}): card == CPU bitwise, "
        f"{ms:.3f} ms (eager, one device sync for the row count)")
    n_ids, vocab = LEGACY_UNIQUE
    ids = torch.from_numpy(rng.zipf(1.2, n_ids) % vocab)
    f = get_op("unique").fn(return_index=True, return_inverse=True,
                            return_counts=True)
    got, want = f(ids.cuda()), f(ids)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "(iii) unique card != CPU")
    ic = ids.cuda()
    ms = time_ms(lambda: f(ic), reps=3, rounds=3)
    log(f"[legacy] (iii) unique of {n_ids} int64 token ids ({want[0].shape[0]}"
        f" distinct) with return_index/inverse/counts: card == CPU "
        f"bitwise, {ms:.3f} ms; card {smi_line}")


def phase_legacy(smi_line):
    """Phase 17: A9 (b)'s legacy tensor tier (see the module docstring).
    Returns the path's launch counts (no port kernel on it)."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    _release()
    ck.reset_launch_counts()
    t = time.perf_counter()
    busy = _legacy_alexnet(smi_line)
    log(f"[legacy] (i) took {time.perf_counter() - t:.1f} s")
    taken = read_counts("legacy")
    t = time.perf_counter()
    _legacy_sweep(smi_line)
    log(f"[legacy] (ii) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _legacy_heavy(smi_line, busy)
    log(f"[legacy] (iii) took {time.perf_counter() - t:.1f} s")
    _release()
    log(f"[legacy] launches of the port's kernels on this path: {taken}")
    took = time.perf_counter() - t_phase
    log(f"[legacy] phase took {took:.1f} s (limit {LEGACY_LIMIT_S})")
    check(took <= LEGACY_LIMIT_S, f"phase 17 took {took:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 18: A9 (b)'s extra.py and optimizer_ops.py — a GluonNLP-style
# BERT-Base with interleaved attention and op-level LAMB trained, every name
# of the two modules on the card against the CPU, the heavy ones at the
# sizes that use them
INTERLEAVED_SHAPE = (32, 128)     # (i) BERT's phase-1 batch x length
INTERLEAVED_STEPS = 10            # (i) (b) bf16 LAMB steps, dropout 0.1
INTERLEAVED_LR = 2e-3             # (i) LAMB's learning rate
INTERLEAVED_ZOO_RTOL = 1e-4       # (i) (a) fp32 encoder vs the zoo's flash route
INTERLEAVED_CHECK_BATCH = 2       # (i) (c) card against CPU, fp32, dropout 0
INTERLEAVED_RTOL = 1e-4           # (i) (c) loss, card vs CPU
INTERLEAVED_GRAD_RTOL = 1e-4      # (i) (c) gradients: the floor of the twin limit
INTERLEAVED_GRAD_FACTOR = 4.0     # (i) (c) ... or this times the CPU fp32 run's gap
INTERLEAVED_LN_A_STEP = 26        # LayerNorm launches a forward: 2 x 12 + 2
INTERLEAVED_ATT = (("BERT-Base self-attention", "selfatt", 32, 12, 64, 128,
                    128),
                   ("Transformer-base cross-attention", "encdec", 64, 8, 64,
                    128, 128))   # (ii) (kind, B, H, D, Tq, Tk)
INTERLEAVED_IM2COL = dict(data=(32, 64, 56, 56), kernel=(3, 3), pad=(1, 1))
INTERLEAVED_OP_RTOL = 1e-5        # (i) (c), (ii) ops card vs CPU, of the largest
INTERLEAVED_BF16_STEP = 2.0 ** -8  # (ii) a bf16 output: one step of the largest
INTERLEAVED_CPU_STRIDE = 4        # (ii) the CPU holds every 4th tensor's update
INTERLEAVED_LIMIT_S = 120.0       # the phase's seconds, the build excluded
BERT_BASE_STEP = {}               # phase 9 (ii)'s numbers, for (i) (b)


def _interleaved_weights(sb, cfg, where):
    """BERT-Base's seeded weights written as a zoo ``.params`` file under
    ``where``; its path."""
    path = os.path.join(where, "bert_base.params")
    sb.save_params(path, sb.init_weights(cfg, seed=SEED + 18))
    return path


def _interleaved_vs_zoo(sb, mx, cfg, path, batch, ctx):
    """(i) (a): the fp32 interleaved encoder against the zoo ``BERTModel``
    (its flash-attention route) on the same weights."""
    import torch

    with ctx:
        P = sb.load_params(mx, path, cfg, ctx)
        data = sb.to_nd(mx, batch, cfg, ctx)
        got = sb.encoder(mx, P, data, cfg)
        torch.cuda.synchronize()
        ms = _wall_ms(lambda: sb.encoder(mx, P, data, cfg), 3)
        got = got.asnumpy().transpose(1, 0, 2)
        zoo = sb.zoo_sequence(mx, path, cfg, batch, ctx)
    gap = _np_rel(got, zoo)
    log(f"[interleaved] (i) (a) fp32 interleaved encoder (B {batch['valid'].size}"
        f", T {batch['tokens'].shape[1]}, valid lengths "
        f"{int(batch['valid'].min())}-{int(batch['valid'].max())}) vs the zoo "
        f"bert_base (multihead_attention, the flash kernels) on the same "
        f"weights: {gap:.3e} of the largest entry (limit "
        f"{INTERLEAVED_ZOO_RTOL}); the encoder's forward {ms:.3f} ms wall "
        f"(eager, TF32 off)")
    check(gap <= INTERLEAVED_ZOO_RTOL, f"(i) (a) encoder vs zoo {gap:.3e}")
    del P, data
    _release()


def _interleaved_train(sb, mx, cfg, path, batch, ctx, smi_line):
    """(i) (b): bf16 LAMB steps through the ops, eager; their numbers.
    Returns the LayerNorm kernel's launches on the path."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    b, t = batch["tokens"].shape
    with ctx:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 20
        P = sb.load_params(mx, path, cfg, ctx, dtype="bfloat16")
        state = sb.lamb_state(mx, P, ctx)
        data = sb.to_nd(mx, batch, cfg, ctx)
        check(all(w._data.is_cuda and w.grad._data.is_cuda
                  for w in P.values()),
              "(i) (b) a weight or gradient left the card")
        scaler = sb.LossScaler()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        run = [sb.train_step(mx, P, state, data, cfg, scaler, INTERLEAVED_LR,
                             i + 1, dropout=0.1)
               for i in range(INTERLEAVED_STEPS)]
        train_s = time.perf_counter() - t0
        taken = read_counts("interleaved")
        losses = [v for v, _ in run]
        check(all(ok for _, ok in run), f"(i) (b) a step overflowed: {run}")
        check(all(math.isfinite(v) for v in losses) and
              statistics.mean(losses[-3:]) < losses[0],
              f"(i) (b) losses {losses}")
        want = INTERLEAVED_LN_A_STEP * INTERLEAVED_STEPS
        check(taken["layer_norm"] == want,
              f"(i) (d) LayerNorm launches {taken['layer_norm']} != {want}")
        dts = {str(w.dtype) for w in P.values()}
        check(dts == {"bfloat16", "float32"} and
              all(str(s_["w32"].dtype) == "float32" for s_ in state.values()),
              f"(i) (b) weight dtypes {dts}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20 - held
        step_i = [INTERLEAVED_STEPS]

        def step():
            step_i[0] += 1
            sb.train_step(mx, P, state, data, cfg, scaler, INTERLEAVED_LR,
                          step_i[0], dropout=0.1)

        wall = _wall_ms(step, 5)
        calls = {}
        events = _gpu_trace(lambda: [step() for _ in range(3)], calls)
        busy = _busy_us(events) / 1e3 / 3
        kernels = sum(1 for e in events if e[0] == "kernel") / 3
        launches = {k: v / 3 for k, v in sorted(calls.items())}
        upd_wall = _wall_ms(lambda: sb.update_mp_lamb(
            mx, P, state, INTERLEAVED_LR, step_i[0], scaler.scale), 5)
        upd_busy = _busy_us(_gpu_trace(lambda: sb.update_mp_lamb(
            mx, P, state, INTERLEAVED_LR, step_i[0], scaler.scale))) / 1e3
        n_params = sum(w.size for w in P.values())
        log(f"[interleaved] (i) (b) BERT-Base ({n_params} parameters, "
            f"{len(P)} tensors; bf16 Dense weights, fp32 tables, LayerNorms "
            f"and masters), B {b} x T {t}, dropout 0.1, dynamic loss scale "
            f"{scaler.scale:g}, LAMB {INTERLEAVED_LR} through one "
            f"multi_mp_lamb_update a step, {INTERLEAVED_STEPS} steps "
            f"({train_s:.2f} s): losses {[round(v, 4) for v in losses]}")
        log(f"[interleaved] (i) (b) a step {wall:.3f} ms wall, device busy "
            f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
            f"{b * t / wall * 1e3:.1f} tokens/s; peak memory {peak:.1f} MiB "
            f"above the {held:.1f} MiB held before; {kernels:.0f} device "
            f"kernels and host launch calls {launches} a step; "
            f"multi_mp_lamb_update alone {upd_wall:.3f} ms wall "
            f"({upd_wall / wall:.3f} of the step), {upd_busy:.3f} ms busy "
            f"({upd_busy / busy:.3f} of the step's busy); card {smi_line}")
        for name, us in _top_ops(events, 8):
            log(f"[interleaved] (i) (b) top: {us / 1e3 / 3:8.3f} ms a step  "
                f"{name[:100]}")
        if BERT_BASE_STEP:
            z = BERT_BASE_STEP
            log(f"[interleaved] (i) (b) beside phase 9 (ii)'s zoo BERT-Base "
                f"step (Learner, one CUDA graph, AdamW, bf16, B 32 x T 128): "
                f"{z['wall']:.3f} ms wall, {z['busy']:.3f} busy, idle "
                f"{z['idle']:.3f}, {z['tokens_s']} tokens/s; this eager "
                f"op-level step {wall:.3f} / {busy:.3f}, "
                f"{b * t / wall * 1e3:.1f} tokens/s")
        del P, state, data
    _release()
    return taken


def _interleaved_vs_cpu(sb, mx, cfg, path, batch, smi_line):
    """(i) (c): one fp32 step at batch 2 on the card and on the CPU: the
    loss, every gradient against a float64 twin, and the masters after one
    ``multi_mp_lamb_update`` of the same gradients (the CPU's, on both: a
    first LAMB step is about the gradient's sign, so where a gradient is
    near 0 the card's own gradient may step the other way)."""
    import torch

    res = {}
    for name, ctx in (("cpu", mx.cpu()), ("gpu", mx.gpu())):
        with ctx:
            P = sb.load_params(mx, path, cfg, ctx)
            state = sb.lamb_state(mx, P, ctx)
            data = sb.to_nd(mx, batch, cfg, ctx)
            loss = sb.backward(mx, P, data, cfg, 1.0, "float32")
            grads = {n: w.grad.asnumpy() for n, w in P.items()}
            own = dict(grads)
            if name == "gpu":
                for n, w in P.items():      # the CPU's gradients
                    w.grad._data.copy_(torch.from_numpy(res["cpu"][1][n]))
            sb.update_mp_lamb(mx, P, state, INTERLEAVED_LR, 1, 1.0)
            res[name] = (loss.asnumpy(), own,
                         {n: s_["w32"].asnumpy() for n, s_ in state.items()})
            del P, state, data
    twin = sb.f64_grads(mx, path, cfg, batch)
    loss_gap = _np_rel(res["gpu"][0], res["cpu"][0])
    gaps = _legacy_grad_gaps(res["gpu"][1], res["cpu"][1], twin)
    worst = max(gaps, key=lambda n: gaps[n][0] /
                max(INTERLEAVED_GRAD_FACTOR * gaps[n][1],
                    INTERLEAVED_GRAD_RTOL))
    g, c = gaps[worst]
    limit = max(INTERLEAVED_GRAD_FACTOR * c, INTERLEAVED_GRAD_RTOL)
    master_gap = max(_np_rel(res["gpu"][2][n], res["cpu"][2][n])
                     for n in res["cpu"][2])
    log(f"[interleaved] (i) (c) card vs CPU at B {batch['valid'].size}, fp32, "
        f"dropout 0: loss {loss_gap:.3e} (limit {INTERLEAVED_RTOL}); "
        f"gradients from a float64 twin, each of its largest: card worst "
        f"{max(v[0] for v in gaps.values()):.3e}, CPU fp32 worst "
        f"{max(v[1] for v in gaps.values()):.3e}; nearest its limit {worst}: "
        f"card {g:.3e}, CPU {c:.3e}, limit {limit:.3e}; masters after one "
        f"multi_mp_lamb_update of the CPU's gradients {master_gap:.3e} "
        f"(limit {INTERLEAVED_OP_RTOL}); card {smi_line}")
    check(loss_gap <= INTERLEAVED_RTOL, f"(i) (c) loss {loss_gap:.3e}")
    check(g <= limit, f"(i) (c) gradient {worst}: {g:.3e} > {limit:.3e}")
    check(master_gap <= INTERLEAVED_OP_RTOL,
          f"(i) (c) masters {master_gap:.3e}")
    _release()


def _interleaved_sweep(smi_line):
    """(ii) every name of the two modules on the card against the CPU, on
    the CPU tests' inputs."""
    ec = _tests_script("torch_extra_cases")
    failed = {}
    for name in sorted(ec.ALL):
        try:
            ec.check_card(name)
        except Exception as e:  # noqa: BLE001 — a failed name, reported
            failed[name] = repr(e)[:200]
    log(f"[interleaved] (ii) {len(ec.ALL)} names ({len(ec.EXTRA)} of extra, "
        f"{len(ec.OPTIM)} of optimizer_ops) card vs CPU: "
        f"{len(ec.ALL) - len(failed)} held; failed: {failed or 'none'}; card "
        f"{smi_line}")
    check(not failed, f"(ii) names failed: {sorted(failed)}")


def _interleaved_heavy(sb, mx, cfg, smi_line):
    """(ii) the interleaved quartet at BERT-Base's and Transformer-base's
    attention, ``im2col``/``col2im`` at a ResNet-50 stage beside
    ``F.unfold``/``F.fold``, ``multi_mp_lamb_update`` and
    ``multi_mp_adamw_update`` over BERT-Base's tensors beside the
    ``Learner``'s LAMB: card against CPU, CUDA-event ms."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.parallel.learner import to_optax

    rng = onp.random.RandomState(SEED + 18)
    for tag, kind, b, h, d, tq, tk in INTERLEAVED_ATT:
        c = h * d
        if kind == "selfatt":
            ins = [rng.randn(tq, b, 3 * c).astype("float32")]
            qk = get_op("interleaved_matmul_selfatt_qk").fn(heads=h)
            va = get_op("interleaved_matmul_selfatt_valatt").fn(heads=h)
            first = (lambda x: qk(x[0]))
            second = (lambda x, a: va(x[0], a))
        else:
            ins = [rng.randn(tq, b, c).astype("float32"),
                   rng.randn(tk, b, 2 * c).astype("float32")]
            qk = get_op("interleaved_matmul_encdec_qk").fn(heads=h)
            va = get_op("interleaved_matmul_encdec_valatt").fn(heads=h)
            first = (lambda x: qk(x[0], x[1]))
            second = (lambda x, a: va(x[1], a))
        cpu = [torch.from_numpy(a) for a in ins]
        card = [a.cuda() for a in cpu]
        att_cpu = torch.softmax(first(cpu), -1)
        att_card = att_cpu.cuda()
        gaps = (_max_rel(first(card), first(cpu)),
                _max_rel(second(card, att_card), second(cpu, att_cpu)))
        ms = (time_ms(lambda: first(card), reps=10, rounds=3),
              time_ms(lambda: second(card, att_card), reps=10, rounds=3))
        flops = 2 * b * h * tq * tk * d
        log(f"[interleaved] (ii) {kind} qk / valatt at {tag} (B {b}, H {h}, "
            f"D {d}, Tq {tq}, Tk {tk}), fp32, TF32 off: card vs CPU "
            f"{gaps[0]:.3e} / {gaps[1]:.3e} (limit {INTERLEAVED_OP_RTOL}); "
            f"{ms[0]:.3f} / {ms[1]:.3f} ms ({flops / ms[0] / 1e9:.1f} / "
            f"{flops / ms[1] / 1e9:.1f} TFLOP/s); card {smi_line}")
        check(max(gaps) <= INTERLEAVED_OP_RTOL, f"(ii) {kind}: {gaps}")
        del cpu, card, att_cpu, att_card

    cfg2 = INTERLEAVED_IM2COL
    x = torch.from_numpy(rng.randn(*cfg2["data"]).astype("float32"))
    xc = x.cuda()
    im = get_op("im2col").fn(kernel=cfg2["kernel"], pad=cfg2["pad"])
    col_card, col_cpu = im(xc), im(x)
    lib = F.unfold(xc, cfg2["kernel"], padding=cfg2["pad"])
    check(torch.equal(col_card.cpu(), col_cpu) and torch.equal(col_card, lib),
          "(ii) im2col: card != CPU or != F.unfold")
    ms, lib_ms = (time_ms(lambda: im(xc), reps=5, rounds=3),
                  time_ms(lambda: F.unfold(xc, cfg2["kernel"],
                                           padding=cfg2["pad"]),
                          reps=5, rounds=3))
    out_hw = cfg2["data"][2:]
    co = get_op("col2im").fn(output_size=out_hw, kernel=cfg2["kernel"],
                             pad=cfg2["pad"])
    back_card, back_cpu = co(col_card), co(col_cpu)
    back_lib = F.fold(col_card, out_hw, cfg2["kernel"], padding=cfg2["pad"])
    gaps = (_max_rel(back_card, back_cpu), _max_rel(back_card, back_lib))
    ms2, lib_ms2 = (time_ms(lambda: co(col_card), reps=5, rounds=3),
                    time_ms(lambda: F.fold(col_card, out_hw, cfg2["kernel"],
                                           padding=cfg2["pad"]),
                            reps=5, rounds=3))
    log(f"[interleaved] (ii) im2col {cfg2['data']} 3x3 pad 1 -> "
        f"{tuple(col_card.shape)}: card == CPU == F.unfold bitwise, "
        f"{ms:.3f} ms (F.unfold {lib_ms:.3f} ms); col2im back: card vs CPU "
        f"{gaps[0]:.3e}, vs F.fold {gaps[1]:.3e} (limit "
        f"{INTERLEAVED_OP_RTOL}), {ms2:.3f} ms (F.fold {lib_ms2:.3f} ms); "
        f"card {smi_line}")
    check(max(gaps) <= INTERLEAVED_OP_RTOL, f"(ii) col2im: {gaps}")
    del x, xc, col_card, col_cpu, lib, back_card, back_cpu, back_lib
    _release()

    # the multi-tensor updates over BERT-Base's tensors: timed over all of
    # them on the card; held card against CPU on every
    # INTERLEAVED_CPU_STRIDE-th tensor (the CPU's passes over 110 M values
    # would take tens of seconds on the host)
    shapes = sb.param_shapes(cfg)
    names = list(shapes)
    r = onp.random.default_rng(SEED + 19)
    host = {n: (r.standard_normal(shapes[n], dtype=onp.float32) * 0.02,
                r.standard_normal(shapes[n], dtype=onp.float32) * 1e-3)
            for n in names}

    def tensors(dev, some):
        out = []
        for n in some:
            w, g = (torch.from_numpy(a) for a in host[n])
            low = torch.float32 if sb.is_fp32(n) else torch.bfloat16
            out += [w.to(dev, low), g.to(dev, low),
                    torch.zeros_like(w, device=dev),
                    torch.zeros_like(w, device=dev), w.to(dev)]
        return out

    def ops(some):
        k_ = len(some)
        wds = tuple(sb.weight_decay(n) for n in some)
        return (("multi_mp_lamb_update", get_op("multi_mp_lamb_update").fn(
                    learning_rates=(1e-3,) * k_, wds=wds,
                    step_count=(1,) * k_, num_tensors=k_, **sb.LAMB), []),
                ("multi_mp_adamw_update", get_op("multi_mp_adamw_update").fn(
                    lrs=(1e-3,) * k_, wds=wds, etas=(1.0,) * k_,
                    num_weights=k_), [torch.tensor(1.0)]))

    k = len(names)
    held = names[::INTERLEAVED_CPU_STRIDE]
    rows = []
    for (op_name, fn, extra), (_, fn_held, _) in zip(ops(names), ops(held)):
        cpu = tensors("cpu", held) + extra
        want = fn_held(*cpu)
        got = fn_held(*(tensors("cuda", held) + [e.cuda() for e in extra]))
        # fp32 outputs within INTERLEAVED_OP_RTOL; the bf16 weights (the
        # masters rounded) within one bf16 step of the largest entry, where
        # a master 1e-7 apart rounds the other way
        gap = max(_max_rel(g_, w_) / (INTERLEAVED_BF16_STEP
                                      if g_.dtype == torch.bfloat16 else
                                      INTERLEAVED_OP_RTOL)
                  for g_, w_ in zip(got, want))
        del cpu, want, got
        card = tensors("cuda", names) + [e.cuda() for e in extra]
        ms = time_ms(lambda: fn(*card), reps=3, rounds=3)
        rows.append((op_name, gap, ms))
        check(gap <= 1.0, f"(ii) {op_name}: {gap:.3f} of its limit")
    params = [t for i, t in enumerate(card[:-1]) if i % 5 == 4]
    grads = [t.float() for i, t in enumerate(card[:-1]) if i % 5 == 1]
    tx = to_optax(mx.optimizer.LAMB(learning_rate=1e-3, wd=0.01))
    tx_state = tx.init(params)

    def learner_update():
        tx.apply(params, tx.update([g_.clone() for g_ in grads], tx_state,
                                   params))

    lms = time_ms(learner_update, reps=3, rounds=3)
    n_params = sum(int(onp.prod(s_)) for s_ in shapes.values())
    log(f"[interleaved] (ii) over BERT-Base's {k} tensors ({n_params} "
        f"values; bf16 Dense weights and gradients, fp32 masters and "
        f"moments), card vs CPU on every {INTERLEAVED_CPU_STRIDE}th tensor "
        f"({len(held)}), the largest gap as a share of its limit "
        f"({INTERLEAVED_OP_RTOL} of an fp32 output's largest entry, "
        f"{INTERLEAVED_BF16_STEP} of a bf16 one's): "
        + "; ".join(f"{n} {gap:.3f}, {ms:.3f} ms" for n, gap, ms in rows)
        + "; the Learner's LAMB (to_optax: "
        f"chunked foreach passes, fp32) update of the same tensors "
        f"{lms:.3f} ms; card {smi_line}")
    del card, params, grads, tx_state
    _release()


def phase_interleaved(smi_line):
    """Phase 18: A9 (b)'s extra.py and optimizer_ops.py (see the module
    docstring). Returns the path's launch counts: the LayerNorm kernel's
    launches of (i) (b)'s steps."""
    import tempfile

    import mxnet_tpu_torch as mx

    t_phase = time.perf_counter()
    _release()
    sb = _tests_script("torch_script_interleaved_bert")
    cfg = sb.config()
    b, t = INTERLEAVED_SHAPE
    batch = sb.make_batch(cfg, b, t, seed=SEED + 18)
    small = sb.make_batch(cfg, INTERLEAVED_CHECK_BATCH, t, seed=SEED + 18)
    with tempfile.TemporaryDirectory(prefix="interleaved-") as where:
        t0 = time.perf_counter()
        path = _interleaved_weights(sb, cfg, where)
        log(f"[interleaved] (i) BERT-Base's seeded weights written in "
            f"{time.perf_counter() - t0:.1f} s")
        _interleaved_vs_zoo(sb, mx, cfg, path, batch, mx.gpu())
        log(f"[interleaved] (i) (a) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        taken = _interleaved_train(sb, mx, cfg, path, batch, mx.gpu(),
                                   smi_line)
        log(f"[interleaved] (i) (b) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _interleaved_vs_cpu(sb, mx, cfg, path, small, smi_line)
        log(f"[interleaved] (i) (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _interleaved_sweep(smi_line)
    _interleaved_heavy(sb, mx, cfg, smi_line)
    log(f"[interleaved] (ii) took {time.perf_counter() - t0:.1f} s")
    _release()
    log(f"[interleaved] (i) (d) launches of the port's kernels on this path "
        f"(the bf16 steps): {taken}")
    took = time.perf_counter() - t_phase
    log(f"[interleaved] phase took {took:.1f} s (limit {INTERLEAVED_LIMIT_S})")
    check(took <= INTERLEAVED_LIMIT_S, f"phase 18 took {took:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 19: quantized (A9 (b)'s quantized tier: int8 after training)
# ---------------------------------------------------------------------------
QUANT_SERVE = (32, 128)           # (i) serving batch x length
QUANT_CALIB = (2, 8, 128)         # (i) entropy calibration: batches x B x T
QUANT_VALID = (16, 128)           # (i) valid lengths drawn in this range
QUANT_CHECK_BATCH = 2             # (i) (a), (ii) card against CPU
QUANT_SCALE_RTOL = 1e-5           # (i) (a), (ii) scales card vs CPU: equal
QUANT_ENTROPY_RTOL = 0.1          # (i) (a) an entropy scale whose KL minimum
                                  # moved to another candidate (see below)
QUANT_FP32_RTOL = 1e-4            # (i) (a) fp32 sequence output, card vs CPU
QUANT_FLIP_SHARE = 1.0            # (i) (a) int8 card vs CPU, of int8 vs fp32
QUANT_FLIP_RATE = 1e-3            # (i) (a) first layer's codes that differ
QUANT_RESNET_FP32_RTOL = 1e-3     # (ii) fp32 logits card vs CPU (phase 7's)
QUANT_RESNET_BATCH = 32           # (ii) calibration and img/s
QUANT_RESNET_IMAGE = 224          # (ii) ImageNet's input
QUANT_CONV = ((32, 128, 28, 28), (128, 128, 3, 3))   # (iii) ResNet-50 stage 2
QUANT_FFN = ((4096, 768), (3072, 768))               # (iii) BERT-Base's FFN
QUANT_LIMIT_S = 75.0              # the phase's seconds, the build excluded


def _quant_wrapper(bert):
    """BERT over one packed int32 batch, tokens and each row's valid length
    in the last column: ``calibrate_net`` passes a batch as one argument."""
    from mxnet_tpu_torch import gluon

    class _WithLengths(gluon.HybridBlock):
        _tensor_body = True

        def __init__(self, inner):
            super().__init__()
            self.bert = inner

        def forward(self, packed):
            return self.bert(packed[:, :-1], None, packed[:, -1])

    return _WithLengths(bert)


def _quant_packed(rng, b, t):
    tok = rng.integers(0, 30522, (b, t), dtype="int32")
    vl = rng.integers(QUANT_VALID[0], QUANT_VALID[1] + 1, (b, 1),
                      dtype="int32")
    return onp.concatenate([tok, vl], axis=1)


def _quant_layers(net):
    """``{path: QuantizedDense or _QuantizedConvCore}`` of a quantized net,
    by the paths ``calibrate_net`` names."""
    return {n[:-len("._q")]: m for n, m in net.named_modules()
            if n.endswith("._q")}


def _quant_run(tag, fn, tokens, reps, smi_line, int8_names=()):
    """A forward's wall against device busy, idle share, tokens (or images)
    a second and peak memory; the int8 GEMMs' share of busy."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 20
    fn()
    wall = _wall_ms(fn, reps)
    events = _gpu_trace(lambda: [fn() for _ in range(3)])
    busy = _busy_us(events) / 1e3 / 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 - held
    i8 = sum(e[4] for e in events if e[0] == "kernel" and
             e[1] in int8_names) / 1e3 / 3
    row = dict(wall=wall, busy=busy, idle=max(0.0, 1 - busy / wall),
               rate=tokens / wall * 1e3, peak=peak, i8=i8)
    log(f"[quantized] {tag}: {wall:.3f} ms wall, device busy {busy:.3f} ms, "
        f"idle share {row['idle']:.3f}, {row['rate']:.1f} a second, peak "
        f"memory {peak:.1f} MiB above the {held:.1f} held"
        + (f", int8 GEMMs {i8:.3f} ms ({i8 / busy:.3f} of busy)"
           if int8_names else "") + f"; card {smi_line}")
    return row, events


def _quant_bert(smi_line):
    """(i): BERT-Base calibrated (entropy) and served in int8; returns the
    path's launch counts."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops.quantized_ops import _codes, _recip, int8_matmul

    rng = onp.random.default_rng(SEED + 19)
    b, t = QUANT_SERVE
    nets = {dev: _quant_wrapper(bert_base(dropout=0.0, device=dev))
            for dev in ("cuda", "cpu")}
    arrays = numpy_weights({n: tuple(p.shape) for n, p in
                            nets["cpu"].bert.collect_params().items()},
                           SEED + 19)
    for net in nets.values():
        net.bert.load_dict(arrays)
    del arrays
    calib = [_quant_packed(rng, *QUANT_CALIB[1:])
             for _ in range(QUANT_CALIB[0])]
    serve = torch.from_numpy(_quant_packed(rng, b, t)).cuda()
    small = _quant_packed(rng, QUANT_CHECK_BATCH, t)
    net = nets["cuda"]
    tokens = b * t

    def fwd():
        with torch.no_grad():
            return net(serve)

    small_fp32 = {}
    with torch.no_grad():
        small_fp32["card"] = net(torch.from_numpy(small).cuda())[0] \
            .cpu().numpy()
        with mx.cpu():
            small_fp32["cpu"] = nets["cpu"](torch.from_numpy(small))[0] \
                .numpy()
    # (c) fp32 first, eager and hybridized, and its output for (b)
    fp32_seq = fwd()[0].float()
    rows = {}
    rows["fp32 eager"], _ = _quant_run(
        f"(i) (c) fp32 BERT-Base eager forward, B {b} x T {t}", fwd, tokens,
        5, smi_line)
    net.hybridize()
    rows["fp32 hybridized"], _ = _quant_run(
        f"(i) (c) fp32 hybridized (one CUDA graph), B {b} x T {t}", fwd,
        tokens, 10, smi_line)
    net.hybridize(False)
    _release()

    # calibration on the card (the path) and on the CPU, the same batches
    t0 = time.perf_counter()
    q.quantize_net(net, calib_data=iter(torch.from_numpy(c).cuda()
                                        for c in calib),
                   calib_mode="entropy", num_calib_batches=QUANT_CALIB[0])
    calib_s = time.perf_counter() - t0
    layers = _quant_layers(net)
    check(len(layers) == 12 * 4 + 1 and all(
        type(m).__name__ == "QuantizedDense" and m.qweight.is_cuda and
        m.qweight.dtype == torch.int8 for m in layers.values()),
        f"(i) quantized layers: {len(layers)}")
    with mx.cpu():
        t1 = time.perf_counter()
        q.quantize_net(nets["cpu"], calib_data=iter(
            torch.from_numpy(c) for c in calib), calib_mode="entropy",
            num_calib_batches=QUANT_CALIB[0])
        cpu_s = time.perf_counter() - t1
    cpu_layers = _quant_layers(nets["cpu"])
    # an entropy scale is the threshold of least KL divergence among ~120
    # candidates; where two candidates' divergences lie closer than the
    # card's and the CPU's histograms (a few counts apart) make them, the
    # two pick different ones: those layers are listed with their gaps
    gaps = {p: abs(m.act_scale - cpu_layers[p].act_scale) /
            cpu_layers[p].act_scale for p, m in layers.items()}
    moved = {p: round(g, 5) for p, g in gaps.items() if g > QUANT_SCALE_RTOL}
    left = sum(p.numel() for p in net.parameters()) / 1e6
    log(f"[quantized] (i) (a) BERT-Base ({left:.2f} M float parameters "
        f"left) calibrated (entropy) on {QUANT_CALIB[0]} batches "
        f"of {QUANT_CALIB[1]} x {QUANT_CALIB[2]}: {len(layers)} Dense layers "
        f"to int8 in {calib_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; "
        f"scales card vs CPU: {len(gaps) - len(moved)} of {len(gaps)} "
        f"within {QUANT_SCALE_RTOL}; KL minimum on another candidate: "
        f"{moved or 'none'} (limit {QUANT_ENTROPY_RTOL} relative)")
    check(max(gaps.values()) <= QUANT_ENTROPY_RTOL,
          f"(i) (a) scales apart by {max(gaps.values()):.3e}")

    # (a) the CPU's int8 model with the card's scales, at batch 2
    for p, m in cpu_layers.items():
        m.act_scale = layers[p].act_scale
    first = "bert.encoder.layers.0.attn_qkv"
    seen = {"cpu": {}, "card": {}}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, _p=p, _s=side: seen[_s].setdefault(
            _p, args[0].detach().cpu().clone()))
        for side, lay in (("cpu", cpu_layers), ("card", layers))
        for p, m in lay.items()]
    with torch.no_grad(), mx.cpu():
        want = nets["cpu"](torch.from_numpy(small))[0].numpy()
    with torch.no_grad():
        got = net(torch.from_numpy(small).cuda())[0].cpu().numpy()
    for h in hooks:
        h.remove()
    seq_gap = _np_rel(got, want)
    noise = _np_rel(want, small_fp32["cpu"])
    means = [float(onp.abs(a - want).mean() / onp.abs(want).mean())
             for a in (got, small_fp32["cpu"])]
    fp32_gap = _np_rel(small_fp32["card"], small_fp32["cpu"])
    # every layer's input codes from each side's own activations, and its
    # int32 accumulators from the CPU's codes on both sides
    flips, exact = {}, True
    for p, m in layers.items():
        r = _recip(m.act_scale)
        x = seen["cpu"][p]
        codes = _codes(x.reshape(-1, x.shape[-1]) * r)
        flips[p] = float((_codes(seen["card"][p].reshape(codes.shape) * r)
                          != codes).sum()) / codes.numel()
        qw = cpu_layers[p].qweight
        exact = exact and torch.equal(m.qweight.cpu(), qw) and torch.equal(
            int8_matmul(codes.cuda(), m.qweight).cpu(),
            int8_matmul(codes, qw))
    depth = [max(v for p, v in flips.items() if f"layers.{i}." in p)
             for i in range(len(net.bert.encoder.layers))] + \
        [flips["bert.pooler"]]
    log(f"[quantized] (i) (a) card vs CPU at B {QUANT_CHECK_BATCH} x T {t}: "
        f"fp32 sequence output {fp32_gap:.3e} of its largest entry; int8 "
        f"(the card's scales on both) {seq_gap:.3e} (mean |diff| "
        f"{means[0]:.3e} of the mean |output|), against the CPU's own int8 "
        f"vs fp32 gap {noise:.3e} (mean {means[1]:.3e}), limit that gap "
        f"times {QUANT_FLIP_SHARE}; the share of each layer's input codes "
        f"that differ, largest of its four Dense, layers 0-11 and the "
        f"pooler: {[f'{v:.1e}' for v in depth]} ({first}: limit "
        f"{QUANT_FLIP_RATE}; a code on the other side of a half moves the "
        f"next layer's inputs by a quantum's share, and more of them fall "
        f"over); int8 weights and every layer's int32 accumulators from "
        f"the CPU's codes ({len(layers)} products, K 768 and 3072, the "
        f"pooler's 2 rows padded) bitwise: {exact}")
    check(fp32_gap <= QUANT_FP32_RTOL, f"(i) (a) fp32 {fp32_gap:.3e}")
    check(seq_gap <= QUANT_FLIP_SHARE * noise,
          f"(i) (a) int8 sequence {seq_gap:.3e} against {noise:.3e}")
    check(flips[first] <= QUANT_FLIP_RATE,
          f"(i) (a) {flips[first]:.3e} of {first}'s codes differ")
    check(exact, "(i) (a) int8 weights or accumulators differ")
    del nets, cpu_layers, want, got, seen
    _release()

    # (b) int8 against fp32 on the card, the serving batch
    int8_seq = fwd()[0].float()
    check(bool(torch.isfinite(int8_seq).all()), "(i) (b) int8 not finite")
    rel = float((int8_seq - fp32_seq).abs().max() / fp32_seq.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(
        int8_seq.reshape(1, -1).double(), fp32_seq.reshape(1, -1).double()))
    log(f"[quantized] (i) (b) int8 vs fp32 sequence output on the card, "
        f"B {b} x T {t}: max relative error {rel:.4e} of the largest entry, "
        f"cosine {cos:.6f}")
    check(math.isfinite(rel) and math.isfinite(cos), "(i) (b) not finite")

    # (c) the int8 path, eager and hybridized; its launches (d)
    shapes = [(b * t, 768, 2304), (b * t, 768, 768), (b * t, 768, 3072),
              (b * t, 3072, 768), (b, 768, 768)]
    ops = [(torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device="cuda"),
            torch.randint(-127, 128, (n, k), dtype=torch.int8,
                          device="cuda")) for m, k, n in shapes]
    int8_names = {e[1] for e in _gpu_trace(
        lambda: [int8_matmul(a, w) for a, w in ops]) if e[0] == "kernel"}
    ck.reset_launch_counts()
    rows["int8 eager"], _ = _quant_run(
        f"(i) (c) int8 BERT-Base eager forward, B {b} x T {t}", fwd, tokens,
        5, smi_line, int8_names)
    net.hybridize()
    rows["int8 hybridized"], events = _quant_run(
        f"(i) (c) int8 hybridized (one CUDA graph), B {b} x T {t}", fwd,
        tokens, 10, smi_line, int8_names)
    taken = read_counts("quantized")
    replay = fwd()[0].float()
    check(torch.equal(replay, int8_seq), "(i) (c) replay != eager")
    for name_, us in _top_ops(events, 6):
        log(f"[quantized] (i) (c) top: {us / 1e3 / 3:8.3f} ms a forward  "
            f"{name_[:100]}")
    f, i = rows["fp32 hybridized"], rows["int8 hybridized"]
    log(f"[quantized] (i) (c) hybridized int8 vs fp32: {i['wall']:.3f} / "
        f"{f['wall']:.3f} ms wall ({f['wall'] / i['wall']:.2f}x), "
        f"{i['busy']:.3f} / {f['busy']:.3f} ms busy, {i['rate']:.1f} / "
        f"{f['rate']:.1f} tokens/s, peak {i['peak']:.1f} / {f['peak']:.1f} "
        f"MiB; eager int8 {rows['int8 eager']['wall']:.3f} / fp32 "
        f"{rows['fp32 eager']['wall']:.3f} ms; card {smi_line}")
    a8 = torch.randint(-127, 128, (4096, 768), dtype=torch.int8,
                       device="cuda")
    w8 = torch.randint(-127, 128, (3072, 768), dtype=torch.int8,
                       device="cuda")
    a32, w32 = a8.float(), w8.float()
    a16, w16 = a8.bfloat16(), w8.bfloat16()
    mm = {"torch._int_mm int8": time_ms(lambda: torch._int_mm(a8, w8.t()),
                                        reps=20, rounds=5),
          "torch.matmul fp32 (TF32 off)": time_ms(
              lambda: torch.matmul(a32, w32.t()), reps=20, rounds=5),
          "torch.matmul bf16": time_ms(lambda: torch.matmul(a16, w16.t()),
                                       reps=20, rounds=5)}
    flops = 2 * 4096 * 768 * 3072
    log("[quantized] (i) (c) (4096, 768) x (768, 3072): " + "; ".join(
        f"{k} {v:.4f} ms ({flops / v / 1e9:.1f} T ops/s)"
        for k, v in mm.items()) + f"; card {smi_line}")
    log(f"[quantized] (i) (d) launches of the port's kernels on the int8 "
        f"path (eager forwards, the warm call and the capture; replays move "
        f"no counter): {taken}")
    check(taken["layer_norm"] > 0, f"(i) (d) no LayerNorm launch: {taken}")
    del net, serve, ops, a8, w8, a32, w32, a16, w16
    _release()
    return taken


def _quant_resnet(smi_line):
    """(ii): ResNet-50 v1 calibrated (naive) and run through the conv
    route, card against CPU, img/s."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as q

    arrays = resnet_weights(SEED + 19)
    with mx.cpu():
        cpu = _resnet_net(arrays)
    card = _resnet_net(arrays)
    rs = onp.random.default_rng(SEED + 20)
    x = rs.standard_normal((QUANT_RESNET_BATCH, 3, QUANT_RESNET_IMAGE,
                            QUANT_RESNET_IMAGE), dtype="float32")
    xc = torch.from_numpy(x).cuda()

    def fwd():
        with torch.no_grad():
            return card(xc)

    fp32 = _quant_run(f"(ii) fp32 ResNet-50 v1 eager forward, batch "
                      f"{QUANT_RESNET_BATCH}, {QUANT_RESNET_IMAGE}^2", fwd,
                      QUANT_RESNET_BATCH, 5, smi_line)[0]
    small = x[:QUANT_CHECK_BATCH]
    with torch.no_grad():
        fp32_card = card(xc[:QUANT_CHECK_BATCH]).cpu().numpy()
        with mx.cpu():
            fp32_cpu = cpu(torch.from_numpy(small)).numpy()
    t0 = time.perf_counter()
    q.quantize_net(card, calib_data=iter([xc]), calib_mode="naive",
                   num_calib_batches=1)
    calib_s = time.perf_counter() - t0
    with mx.cpu():
        q.quantize_net(cpu, calib_data=iter([torch.from_numpy(x)]),
                       calib_mode="naive", num_calib_batches=1)
    layers, cpu_layers = _quant_layers(card), _quant_layers(cpu)
    convs = sum(type(m).__name__ == "_QuantizedConvCore"
                for m in layers.values())
    gap_s = max(abs(m.act_scale - cpu_layers[p].act_scale) /
                cpu_layers[p].act_scale for p, m in layers.items())
    for p, m in cpu_layers.items():
        m.act_scale = layers[p].act_scale
    with torch.no_grad(), mx.cpu():
        want = cpu(torch.from_numpy(small)).numpy()
    with torch.no_grad():
        got = card(xc[:QUANT_CHECK_BATCH]).cpu().numpy()
        int8_full = card(xc)
    gap, noise = _np_rel(got, want), _np_rel(want, fp32_cpu)
    fp32_gap = _np_rel(fp32_card, fp32_cpu)
    check(bool(torch.isfinite(int8_full).all()), "(ii) int8 not finite")
    int8 = _quant_run(f"(ii) int8 ResNet-50 v1 eager forward (the conv "
                      f"route), batch {QUANT_RESNET_BATCH}", fwd,
                      QUANT_RESNET_BATCH, 5, smi_line)[0]
    log(f"[quantized] (ii) ResNet-50 v1: {convs} convolutions and "
        f"{len(layers) - convs} Dense to int8 (naive, one batch of "
        f"{QUANT_RESNET_BATCH}) in {calib_s:.2f} s; scales card vs CPU "
        f"{gap_s:.3e} (limit {QUANT_SCALE_RTOL}); logits card vs CPU at "
        f"batch {QUANT_CHECK_BATCH}: fp32 {fp32_gap:.3e} of the largest "
        f"(limit {QUANT_RESNET_FP32_RTOL}), int8 with the card's scales on "
        f"both {gap:.3e} against the CPU's own int8 vs fp32 gap "
        f"{noise:.3e} (limit that gap times {QUANT_FLIP_SHARE}); "
        f"{int8['rate']:.1f} img/s int8 against {fp32['rate']:.1f} fp32, "
        f"eager; card {smi_line}")
    check(len(layers) == 54 and convs == 53, f"(ii) layers {len(layers)}")
    check(gap_s <= QUANT_SCALE_RTOL, f"(ii) scales {gap_s:.3e}")
    check(fp32_gap <= QUANT_RESNET_FP32_RTOL, f"(ii) fp32 {fp32_gap:.3e}")
    check(gap <= QUANT_FLIP_SHARE * noise,
          f"(ii) int8 logits {gap:.3e} against {noise:.3e}")
    del card, cpu, xc, int8_full
    _release()


def _quant_sweep(smi_line):
    """(iii) every name card against CPU, then the heavy ones at model
    sizes: integer outputs bitwise, with their ms."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.registry import get_op

    qc = _tests_script("torch_quantized_cases")
    failed = {}
    for name in sorted(qc.ALL):
        try:
            qc.check_card(name)
        except Exception as e:  # noqa: BLE001 — a failed name, reported
            failed[name] = repr(e)[:200]
    log(f"[quantized] (iii) {len(qc.ALL)} names "
        f"({len(qc.ALL) - len(qc.CONTRIB)} of quantized_ops, "
        f"{len(qc.CONTRIB)} of contrib.quantization) card vs CPU: "
        f"{len(qc.ALL) - len(failed)} held; failed: {failed or 'none'}; "
        f"card {smi_line}")
    check(not failed, f"(iii) names failed: {sorted(failed)}")

    rng = onp.random.default_rng(SEED + 21)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape,
                                             dtype="int8"))

    rng_t = [torch.tensor(v, dtype=torch.float32)
             for v in (-2.0, 1.5, -0.3, 0.31)]
    xs, ws = QUANT_CONV
    qx, qw = i8(*xs), i8(*ws)
    conv = get_op("quantized_conv").fn(kernel=(3, 3), pad=(1, 1),
                                       num_filter=ws[0])
    card_in = [qx.cuda(), qw.cuda()] + [v.cuda() for v in rng_t]
    same = torch.equal(conv(*card_in)[0].cpu(), conv(qx, qw, *rng_t)[0])
    ms = time_ms(lambda: conv(*card_in), reps=5, rounds=3)
    xf, wf = card_in[0].float(), card_in[1].float()
    lib = time_ms(lambda: F.conv2d(xf, wf, padding=1), reps=5, rounds=3)
    flops = 2 * xs[0] * xs[2] * xs[3] * ws[0] * ws[1] * 9
    log(f"[quantized] (iii) quantized_conv {xs} x {ws} pad 1 (im2col of "
        f"the codes, one torch._int_mm): card == CPU bitwise {same}, "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} T ops/s) beside F.conv2d fp32 "
        f"(TF32 off) on the same values {lib:.3f} ms; card {smi_line}")
    check(same, "(iii) quantized_conv card != CPU")
    (m_, k_), (n_, _) = QUANT_FFN
    qa, qb = i8(m_, k_), i8(n_, k_)
    fc = get_op("quantized_fully_connected_v2").fn(no_bias=True,
                                                   num_hidden=n_)
    ig = get_op("intgemm_fully_connected").fn(no_bias=True)
    scale = torch.tensor(3e-4)
    rows = []
    for tag, f, args in (("quantized_fully_connected_v2", fc,
                          [qa, qb] + rng_t),
                         ("intgemm_fully_connected", ig, [qa, qb, scale])):
        card_args = [a.cuda() for a in args]
        got, want = f(*card_args), f(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        ms = time_ms(lambda: f(*card_args), reps=10, rounds=3)
        rows.append(f"{tag} card == CPU bitwise {same}, {ms:.4f} ms "
                    f"({2 * m_ * k_ * n_ / ms / 1e9:.1f} T ops/s)")
        check(same, f"(iii) {tag} card != CPU")
    log(f"[quantized] (iii) at BERT-Base's FFN ({m_}, {k_}) x ({n_}, {k_}): "
        + "; ".join(rows) + f"; card {smi_line}")
    _release()


def phase_quantized(smi_line):
    """Phase 19: A9 (b)'s quantized tier (see the module docstring).
    Returns the path's launch counts: the int8 BERT-Base's forwards."""
    t_phase = time.perf_counter()
    _release()
    t0 = time.perf_counter()
    taken = _quant_bert(smi_line)
    log(f"[quantized] (i) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _quant_resnet(smi_line)
    log(f"[quantized] (ii) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _quant_sweep(smi_line)
    log(f"[quantized] (iii) took {time.perf_counter() - t0:.1f} s")
    took = time.perf_counter() - t_phase
    log(f"[quantized] phase took {took:.1f} s (limit {QUANT_LIMIT_S})")
    check(took <= QUANT_LIMIT_S, f"phase 19 took {took:.1f} s")
    return taken


# ---------------------------------------------------------------------------
# phase 20: image — A10 (3)'s image pipeline and graph_image_ops.py
# ---------------------------------------------------------------------------
IMAGE_NET = dict(records=1280, side=(300, 500), classes=1000)  # (i) JPEGs
IMAGE_ITER = dict(data_shape=(3, 224, 224), batch_size=128, resize=256,
                  rand_crop=True, rand_mirror=True, shuffle=True,
                  mean_r=123.68, mean_g=116.779, mean_b=103.939,
                  std_r=58.393, std_g=57.12, std_b=57.375, seed=SEED)
IMAGE_THREADS = (1, 4, 8)     # (i) preprocess_threads timed
IMAGE_RATE_BATCHES = 3        # (i) batches an iterator rate
IMAGE_STEPS = 8               # (i) fed and pre-staged ResNet-50 steps
IMAGE_DET = dict(records=256, size=(500, 375), boxes=(1, 6), classes=20,
                 batch=32, workers=4, steps=4)   # (ii) VOC-sized detection
IMAGE_BAND = dict(B=1, L=512, H=12, D=64, w=128)  # (iii) card vs CPU
IMAGE_BAND_RTOL = 1e-5
IMAGE_LONGFORMER = dict(B=1, L=4096, H=12, D=64, w=256)  # attention_window 512
IMAGE_GRAPH = dict(vertices=20000, edges=200000, adjacency=2000, pairs=1000)
IMAGE_LIMIT_S = 90.0          # the phase's seconds, the build excluded


def _image_rates(smi_line, path):
    """(i) The iterator alone on the host at each thread count: img/s, the
    batches of 1 and 8 threads (the same seed) held equal, and one image's
    stages on one thread. Returns the first batch of 8 threads and the
    thread count that read fastest."""
    import mxnet_tpu_torch as mx

    cores = len(os.sched_getaffinity(0))
    kept, rates, secs_of = {}, [], {}
    with mx.cpu():
        for threads in IMAGE_THREADS:
            it = mx.io.ImageRecordIter(path, preprocess_threads=threads,
                                       **IMAGE_ITER)
            t = time.perf_counter()
            got = [next(it).data[0].asnumpy()
                   for _ in range(IMAGE_RATE_BATCHES)]
            secs = secs_of[threads] = time.perf_counter() - t
            rates.append(f"{threads} threads "
                         f"{len(got) * IMAGE_ITER['batch_size'] / secs:.1f}")
            kept[threads] = got
            del it
    log(f"[image] (i) ImageRecordIter alone (decode, resize 256, random "
        f"crop 224, mirror, normalize; {IMAGE_RATE_BATCHES} batches of "
        f"{IMAGE_ITER['batch_size']} a rate): img/s " + ", ".join(rates)
        + f"; host cores {os.cpu_count()} ({cores} usable); card "
        f"{smi_line}")
    same = all(onp.array_equal(a, b) for a, b in zip(kept[1], kept[8]))
    log(f"[image] (i) batches at 1 and 8 threads bitwise equal: {same}")
    check(same, "(i) ImageRecordIter batches differ between 1 and 8 threads")
    # where one image's time goes, on one thread: the iterator's own steps
    from mxnet_tpu_torch.recordio import MXIndexedRecordIO, unpack_img

    rec = MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx", path, "r")
    payloads = [rec.read_idx(k)
                for k in rec.keys[:IMAGE_ITER["batch_size"]]]
    rec.close()
    with mx.cpu():
        it = mx.io.ImageRecordIter(path, preprocess_threads=1, **IMAGE_ITER)
    stages = {"draws (caller's thread)": lambda p: it._draws(p),
              "decode (PIL)": unpack_img,
              "decode, resize, crop, mirror, normalize":
              lambda p: it._decode_one(p, 0, 0, True)}
    per = {}
    for name, fn in stages.items():
        t = time.perf_counter()
        for p in payloads:
            fn(p)
        per[name] = (time.perf_counter() - t) * 1e3 / len(payloads)
    del it
    log("[image] (i) one image on one thread, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per.items()))
    best = max(IMAGE_THREADS, key=lambda n: len(kept[n]) / secs_of[n])
    return kept[8][0], best


def _image_resnet(smi_line, path, host_first, arrays, threads):
    """(i) ResNet-50 v1 (weights ``arrays``) through the AMP
    ``compile_step``, fed by the iterator (``threads`` decode threads) and
    on pre-staged batches."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, optimizer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    batch = IMAGE_ITER["batch_size"]
    it = mx.io.ImageRecordIter(path, preprocess_threads=8, **IMAGE_ITER)
    first = next(it)
    check(first.data[0]._data.device.type == torch.device(DEV).type,
          "(i) batch not on the card")
    same = onp.array_equal(first.data[0].asnumpy(), host_first)
    log(f"[image] (i) the iterator's first batch on the card equals the "
        f"host's bitwise: {same}; the fed run reads with {threads} threads, "
        f"the fastest above")
    check(same, "(i) a landed batch differs from the host's")
    del it
    it = mx.io.ImageRecordIter(path, preprocess_threads=threads,
                               **IMAGE_ITER)
    first = next(it)
    amp.init("bfloat16")
    try:
        net = _resnet_net(arrays)
        trainer = gluon.Trainer(net.collect_params(), optimizer.SGD(
            learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM))
        step = trainer.compile_step(net, SoftmaxCrossEntropyLoss())
        t = time.perf_counter()
        for _ in range(2):   # the warm step and the capture
            step(first.data[0], first.label[0])
        torch.cuda.synchronize()
        log(f"[image] (i) warm step and capture {time.perf_counter() - t:.1f}"
            f" s")

        def fed():
            """IMAGE_STEPS steps, each on the iterator's next batch."""
            out = []
            for _ in range(IMAGE_STEPS):
                b = next(it)
                out.append((b, step(b.data[0], b.label[0])))
            return out

        def staged():
            """The same steps on the fed run's batches, already on the
            card."""
            return [(b, step(b.data[0], b.label[0])) for b in batches]

        runs = {}
        for tag, run in (("fed", fed), ("pre-staged", staged)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / IMAGE_STEPS
            peak = torch.cuda.max_memory_allocated()
            if tag == "fed":
                batches = [b for b, _ in res]
                it.reset()
                next(it)     # the traced run takes the same place an epoch
            busy = _busy_us(_gpu_trace(run)) / 1e3 / IMAGE_STEPS
            runs[tag] = (wall, busy, [v for _, v in res], peak)
        for tag, (wall, busy, losses, peak) in runs.items():
            vals = [float(v.asnumpy()) for v in losses]
            log(f"[image] (i) ResNet-50 v1 AMP compile_step, {tag} "
                f"({IMAGE_STEPS} steps of {batch}): step wall {wall:.2f} ms,"
                f" device busy {busy:.2f} ms, idle share "
                f"{max(0.0, 1 - busy / wall):.3f}, "
                f"{batch / wall * 1e3:.1f} img/s, peak "
                f"{peak / 2**20:.0f} MiB; losses "
                + " ".join(f"{v:.4f}" for v in vals) + f"; card {smi_line}")
            check(all(math.isfinite(v) for v in vals), f"(i) {tag} loss")
        log(f"[image] (i) captures {step._traces}")
        check(step._traces == 1, "(i) a capture after the warm step")
    finally:
        amp.disable()
    del it, step, trainer, net, batches, first, runs
    _release()


def _image_detection(smi_line, loader, serial, pool_s, pool_t0):
    """(ii) SSD-300 trained from ``ImageBboxDataLoader``'s workers, whose
    pool was started at ``pool_t0`` (``pool_s`` seconds to start)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    cfg = IMAGE_DET
    t = time.perf_counter()
    batches = iter(loader)
    first = next(batches)
    start_s = time.perf_counter() - t
    ready_s = time.perf_counter() - pool_t0
    t = time.perf_counter()
    got = [first] + list(batches)
    rate = (len(got) - 1) / (time.perf_counter() - t)
    log(f"[image] (ii) ImageBboxDataLoader ({cfg['workers']} spawned "
        f"workers; expand, crop with constraints, flip, resize 300): pool "
        f"start {pool_s:.2f} s, first batch {ready_s:.2f} s after it (its "
        f"wait here {start_s:.2f} s, (i) ran between), then {rate:.2f} "
        f"batches/s "
        f"({rate * cfg['batch']:.1f} img/s); {len(got)} batches, boxes "
        f"{[tuple(b[1].shape) for b in got[:3]]}...; card {smi_line}")
    with mx.cpu():
        want = next(iter(serial))
    same = onp.array_equal(got[0][1].asnumpy(), want[1].asnumpy()) and \
        onp.array_equal(got[0][0].asnumpy(), want[0].asnumpy())
    log(f"[image] (ii) the workers' first batch (images and boxes) equals "
        f"the serial loader's bitwise: {same}")
    check(same, "(ii) worker batch differs from the serial loader's")

    def inputs(b):
        x = b[0]._data.permute(0, 3, 1, 2).float().div(255.0).contiguous()
        box = b[1]._data
        lab = torch.cat([box[..., 4:5], box[..., :4] / 300.0], -1)
        lab = torch.where(box[..., 4:5] < 0, torch.full_like(lab, -1.0), lab)
        return NDArray(x), NDArray(lab)

    with mx.gpu():
        net = vision.ssd_300_mobilenet(num_classes=cfg["classes"])
        net.initialize(seed=SEED + 22)
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": VISION_SSD["lr"],
                        "momentum": VISION_SSD["momentum"]})

    def step(b):
        x, lab = inputs(b)
        with autograd.record():
            loss, _ = _ssd_loss(net, x, lab)
        loss.backward()
        tr.step(cfg["batch"])
        return loss

    for b in got[:2]:    # the warm call and the capture
        step(b)
    rows = []
    for i, b in enumerate(got[1:1 + cfg["steps"]]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        busy = _busy_us(_gpu_trace(lambda: step(b))) / 1e3
        val = float(loss.asnumpy())
        check(math.isfinite(val), f"(ii) step {i} loss {val}")
        rows.append(f"step {i + 1}: wall {wall:.2f} ms, busy {busy:.2f} ms, "
                    f"idle {max(0.0, 1 - busy / wall):.3f}, loss {val:.4f}")
    log("[image] (ii) hybridized ssd_300_mobilenet(20) fed by the loader: "
        + "; ".join(rows) + f"; card {smi_line}")
    del net, tr, got, first
    _release()


def _band_case(fn_s, fn_c, q, k, v, dil, g_s, g_c):
    """Score, context and the gradients of q, k, v through both ops."""
    import torch

    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    s = fn_s(qq, kk, dil)
    c = fn_c(s, vv, dil)
    torch.autograd.backward([s, c], [g_s, g_c])
    return [s.detach(), c.detach(), qq.grad, kk.grad, vv.grad]


def _image_ops(smi_line):
    """(iii) The 40 names on the card against the CPU, and sldwin's times
    at Longformer-base's shape."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry as reg

    rng = onp.random.RandomState(SEED + 23)
    cfg = IMAGE_BAND
    B, L, H, D, w = (cfg[k] for k in ("B", "L", "H", "D", "w"))
    dil = onp.tile(onp.arange(1, 5), H // 4).astype("int32")
    errs = []
    for sym in (True, False):
        W = 2 * w + 1 if sym else w + 1
        host = [torch.from_numpy(rng.randn(*s).astype("float32")) for s in
                ((B, L, H, D),) * 3 + ((B, L, H, W), (B, L, H, D))]
        fs = reg.get_op("sldwin_atten_score").fn(w=w, symmetric=sym)
        fc = reg.get_op("sldwin_atten_context").fn(w=w, symmetric=sym)
        want = _band_case(fs, fc, *host[:3], torch.from_numpy(dil),
                          *host[3:])
        got = _band_case(fs, fc, *(t.to(DEV) for t in host[:3]),
                         torch.from_numpy(dil).to(DEV),
                         *(t.to(DEV) for t in host[3:]))
        for name, g, wv in zip(("score", "context", "dq", "dk", "dv"), got,
                               want):
            errs.append((f"{'symmetric' if sym else 'causal'} {name}",
                         _max_rel(g, wv)))
    worst = max(e for _, e in errs)
    log(f"[image] (iii) sldwin score -> context forward and backward at "
        f"(B {B}, L {L}, H {H}, D {D}, w {w}), dilations {dil.tolist()}, "
        f"card vs CPU max |diff| / largest: "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs)
        + f" (limit {IMAGE_BAND_RTOL})")
    check(worst <= IMAGE_BAND_RTOL, f"(iii) sldwin card vs CPU {worst:.2e}")

    cfg = IMAGE_LONGFORMER
    B, L, H, D, w = (cfg[k] for k in ("B", "L", "H", "D", "w"))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 24)
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device=DEV)
               for _ in range(3))
    dil1 = torch.ones(H, dtype=torch.int32, device=DEV)
    fs = reg.get_op("sldwin_atten_score").fn(w=w, symmetric=True)
    fc = reg.get_op("sldwin_atten_context").fn(w=w, symmetric=True)
    scale = 1.0 / math.sqrt(D)
    mask = reg.get_op("sldwin_atten_mask_like").fn(w=w, symmetric=True)(
        fs(q, k, dil1), dil1, torch.full((B,), L, device=DEV))

    def forward(q=q, k=k, v=v):
        s = fs(q, k, dil1) * scale
        p = torch.softmax(s.masked_fill(mask == 0, float("-inf")), -1)
        return fc(p, v, dil1)

    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    g = torch.randn((B, L, H, D), generator=gen, device=DEV)

    def both():
        out = forward(qq, kk, vv)
        out.backward(g)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fwd_ms = time_ms(forward, reps=3, rounds=3)
    fwd_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    both_ms = time_ms(both, reps=3, rounds=3)
    both_peak = torch.cuda.max_memory_allocated() - base
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(L, device=DEV)
    band = (pos[:, None] - pos[None, :]).abs() <= w

    def dense():
        s = (qt @ kt.transpose(-1, -2)) * scale
        return torch.softmax(s.masked_fill(~band, float("-inf")), -1) @ vt

    dense_ms = time_ms(dense, reps=3, rounds=3)
    err = _max_rel(dense().transpose(1, 2), forward())
    log(f"[image] (iii) sldwin attention (score, band softmax, context) at "
        f"Longformer-base's (B {B}, L {L}, H {H}, D {D}), w {w}, dilation "
        f"1, fp32: forward {fwd_ms:.3f} ms, forward and backward "
        f"{both_ms:.3f} ms, peak above the operands {fwd_peak / 2**20:.0f} / "
        f"{both_peak / 2**20:.0f} MiB (the reference's whole-band gather "
        f"would be {B * H * L * (2 * w + 1) * D * 4 / 2**30:.2f} GiB); a "
        f"dense masked torch.matmul attention at the same shape, a reference"
        f" point and not a bound: {dense_ms:.3f} ms (outputs "
        f"{err:.2e} apart); card {smi_line}")
    check(err <= 1e-4, f"(iii) band attention vs dense {err:.2e}")
    del q, k, v, qq, kk, vv, g, mask, qt, kt, vt, band
    _release()

    # the DGL ops on a seeded CSR
    cfg = IMAGE_GRAPH
    n, e = cfg["vertices"], cfg["edges"]
    deg = rng.multinomial(e, onp.ones(n) / n)
    indptr = onp.concatenate([[0], onp.cumsum(deg)]).astype("int64")
    indices = rng.randint(0, n, e).astype("int64")
    vids = rng.choice(n, cfg["adjacency"], replace=False).astype("int64")
    sub = reg.get_op("dgl_subgraph").fn()(torch.from_numpy(indptr),
                                          torch.from_numpy(indices),
                                          torch.from_numpy(vids))
    cases = [
        ("dgl_subgraph", {"return_mapping": True}, [indptr, indices, vids]),
        ("dgl_adjacency", {}, [sub[0].numpy(), sub[1].numpy()]),
        ("dgl_graph_compact", {}, [indptr, indices, onp.concatenate(
            [vids[:500], -onp.ones(12, "int64")])]),
        ("edge_id", {}, [indptr, indices,
                         rng.randint(0, n, cfg["pairs"]),
                         indices[rng.randint(0, e, cfg["pairs"])]]),
        ("dgl_csr_neighbor_uniform_sample",
         dict(num_hops=2, num_neighbor=5, max_num_vertices=2000),
         [indptr, indices, vids[:64]]),
        ("dgl_csr_neighbor_non_uniform_sample",
         dict(num_hops=2, num_neighbor=5, max_num_vertices=2000),
         [indptr, indices, rng.rand(n).astype("float32"), vids[:64]]),
        ("getnnz", {"axis": 0}, [(indices.reshape(-1, 100) % 7)]),
    ]
    img = rng.randint(0, 256, (375, 500, 3)).astype("uint8")
    import io as _pyio

    from PIL import Image

    buf = _pyio.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    cases += [
        ("image_to_tensor", {}, [img]),
        ("image_normalize", {"mean": (0.485, 0.456, 0.406),
                             "std": (0.229, 0.224, 0.225)},
         [(img.transpose(2, 0, 1) / 255.0).astype("float32")]),
        ("image_resize", {"size": (300, 300)}, [img]),
        ("image_resize", {"size": 256, "keep_ratio": True}, [img]),
        ("image_crop", {"x": 10, "y": 20, "width": 224, "height": 200},
         [img]),
        ("image_random_crop", {"size": (224, 224)}, [img]),
        ("image_random_resized_crop", {"size": 224}, [img]),
        ("cvimresize", {"w": 320, "h": 240}, [img]),
        ("cvcopyMakeBorder", {"top": 4, "bot": 4, "left": 8, "right": 8,
                              "value": 127.0}, [img]),
        ("cvimdecode", {}, [onp.frombuffer(buf.getvalue(), "uint8")]),
    ]
    rows = []
    for name, attrs, arrays in cases:
        fn = reg.get_op(name).fn(**attrs)
        outs, ms = [], None
        for dev in ("cpu", DEV):
            mx.random.seed(SEED + 25)
            args = [torch.from_numpy(onp.array(a)).to(dev) for a in arrays]
            t = time.perf_counter()
            got = fn(*args)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            check(all(o.device.type == torch.device(dev).type for o in got),
                  f"(iii) {name} output off its operands' device")
            outs.append([o.cpu() for o in got])
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        rows.append(f"{name} {'bitwise' if same else 'DIFFERS'} "
                    f"({ms:.2f} ms)")
        check(same, f"(iii) {name} card != CPU")
    log(f"[image] (iii) DGL ops on a seeded CSR of {n} vertices and {e} "
        f"edges (adjacency of the {cfg['adjacency']}-vertex subgraph), "
        f"getnnz, and the image and cv ops on a 500 x 375 image, card "
        f"against CPU (the card's wall ms, eager host ops included): "
        + "; ".join(rows))
    _release()


def phase_image(smi_line):
    """Phase 20: A10 (3)'s image pipeline and ``ops/graph_image_ops.py``
    (see the module docstring). Returns the path's launch counts: (i)'s and
    (ii)'s training, no port kernel on it."""
    import tempfile

    from mxnet_tpu_torch.gluon.contrib.data import vision as cv
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    ic = _tests_script("torch_image_cases")
    t_phase = time.perf_counter()
    _release()
    with tempfile.TemporaryDirectory(prefix="image-") as where:
        t = time.perf_counter()
        det = ic.pack_detection(os.path.join(where, "voc"),
                                IMAGE_DET["records"], SEED + 21,
                                size=IMAGE_DET["size"],
                                boxes=IMAGE_DET["boxes"],
                                classes=IMAGE_DET["classes"])
        det_s = time.perf_counter() - t
        dataset = ic.SeededDetection(ImageRecordDataset(det), SEED + 21)
        blocks = [cv.ImageBboxRandomExpand(fill=(124, 116, 104)),
                  cv.ImageBboxRandomCropWithConstraints(),
                  cv.ImageBboxRandomFlipLeftRight(),
                  cv.ImageBboxResize(300, 300)]
        loader = cv.ImageBboxDataLoader(
            dataset, IMAGE_DET["batch"], bbox_transforms=blocks,
            num_workers=IMAGE_DET["workers"], last_batch="discard")
        serial = cv.ImageBboxDataLoader(
            dataset, IMAGE_DET["batch"], bbox_transforms=blocks,
            last_batch="discard")
        pool_t0 = time.perf_counter()
        loader._ensure_pool()   # the workers import torch meanwhile
        pool_s = time.perf_counter() - pool_t0
        t = time.perf_counter()
        rec = ic.pack_classification(os.path.join(where, "imagenet"),
                                     IMAGE_NET["records"], SEED + 20,
                                     side=IMAGE_NET["side"],
                                     classes=IMAGE_NET["classes"])
        log(f"[image] packed {IMAGE_NET['records']} JPEGs of "
            f"{IMAGE_NET['side'][0]}-{IMAGE_NET['side'][1] - 1} px a side "
            f"(quality 95, {os.path.getsize(rec) / 2**20:.1f} MiB) in "
            f"{time.perf_counter() - t:.2f} s and {IMAGE_DET['records']} "
            f"VOC-sized ones ({os.path.getsize(det) / 2**20:.1f} MiB) in "
            f"{det_s:.2f} s, 8 threads")
        arrays = resnet_weights(SEED + 20)
        # (iii) first: the loader's workers finish their imports meanwhile,
        # and leave the host's cores to (i)'s timings
        t = time.perf_counter()
        _image_ops(smi_line)
        log(f"[image] (iii) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        host_first, threads = _image_rates(smi_line, rec)
        ck.reset_launch_counts()
        _image_resnet(smi_line, rec, host_first, arrays, threads)
        del arrays
        log(f"[image] (i) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        _image_detection(smi_line, loader, serial, pool_s, pool_t0)
        taken = read_counts("image")
        log(f"[image] (ii) took {time.perf_counter() - t:.1f} s; kernel "
            f"counters after (i) and (ii): {taken}")
        check(not any(taken.values()),
              f"image: a port kernel launched on the image path: {taken}")
        del loader, serial, dataset
    took = time.perf_counter() - t_phase
    log(f"[image] phase took {took:.1f} s (limit {IMAGE_LIMIT_S})")
    check(took <= IMAGE_LIMIT_S, f"phase 20 took {took:.1f} s")
    return taken


# phases a partial run may name (``python3 chip_smoke.py predictor``): the
# build, then those phases; it prints no result line
PARTIAL = {"kernels": lambda smi: phase_kernels(),
           "resnet": phase_resnet, "predictor": phase_predictor,
           "bert_pretrain": phase_bert_pretrain, "graph": phase_graph,
           "script": lambda smi: phase_script(smi, *phase_train(smi)[1:]),
           "optim": phase_optim, "data": phase_data,
           "sparse": phase_sparse, "vision": phase_vision,
           "rnn": phase_rnn, "legacy": phase_legacy,
           "interleaved": phase_interleaved, "quantized": phase_quantized,
           "image": phase_image,
           "amp16": lambda smi: phase_amp16(smi, None)}


# ---------------------------------------------------------------------------
def main():
    try:
        import torch
    except ImportError:
        log("chip_smoke: FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: FAIL: no CUDA device visible")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        log("chip_smoke: FAIL: run from a checkout (mxnet_tpu_torch/ is "
            "not beside this script)")
        return 1
    sys.path.insert(0, here)
    # fp32 parity phases: full-precision matmuls and convolutions; bf16
    # GEMMs (phase 4c) sum in fp32 throughout, split-K partials included,
    # as the MXU that the reference runs on accumulates in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; "
        f"allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    for var in ("MXTPU_TUNE", "MXTPU_FLASH_BLOCK_Q", "MXTPU_FLASH_BLOCK_K"):
        os.environ.pop(var, None)            # phases 1-4 run untuned
    only = sys.argv[1:]
    if any(name not in PARTIAL for name in only):
        log(f"chip_smoke: FAIL: a partial run names phases of "
            f"{sorted(PARTIAL)}, got {only}")
        return 1
    try:
        t0 = time.perf_counter()
        build_info = phase_build()
        if only:
            for name in only:
                PARTIAL[name](smi_line)
            log(f"[done] partial run of {only} passed in "
                f"{time.perf_counter() - t0:.1f} s; no result line")
            return 0
        kernels = phase_kernels()
        _, agree = phase_serve()
        _, arrays, batches, train_losses = phase_train(smi_line)
        _, fp32_run = phase_train_compiled(smi_line)
        phase_train_amp(smi_line, fp32_run)
        phase_amp16(smi_line, fp32_run)
        phase_nd(smi_line, arrays, batches)
        phase_tune(agree)
        rtc_row = phase_rtc()
        phase_resnet(smi_line)
        phase_predictor(smi_line)
        phase_bert_pretrain(smi_line)
        phase_graph(smi_line)
        phase_script(smi_line, arrays, batches, train_losses)
        del arrays, batches
        phase_optim(smi_line)
        phase_data(smi_line)
        phase_sparse(smi_line)
        phase_vision(smi_line)
        phase_rnn(smi_line)
        phase_legacy(smi_line)
        phase_interleaved(smi_line)
        phase_quantized(smi_line)
        phase_image(smi_line)
        log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 — every failure ends the run non-zero
        traceback.print_exc()
        log("chip_smoke: FAIL")
        return 1
    log(smi_line)
    for name, row in kernels.items():
        # a row counts the launches of its dtype instance: x in the dtype
        # its name's suffix names (":bf16", ":fp16", ":e4m3", ":e5m2"; no
        # suffix fp32), LayerNorm's gamma and beta in either dtype
        kernel, _, low = name.partition(":")
        by_path = {path: sum(n for (k, dts), n in counts.items()
                             if k == kernel and
                             dts[0] == SUFFIX_DTYPE[low])
                   for path, counts in PATH_DTYPES.items()}
        by_path["rtc"] = 0
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        row["graph"] = by_path.get("graph", 0)
        row["script"] = by_path.get("script", 0)
        row["optim"] = by_path.get("optim", 0)
        row["data"] = by_path.get("data", 0)
        row["sparse"] = by_path.get("sparse", 0)
        row["vision"] = by_path.get("vision", 0)
        row["rnn"] = by_path.get("rnn", 0)
        row["legacy"] = by_path.get("legacy", 0)
        row["interleaved"] = by_path.get("interleaved", 0)
        row["quantized"] = by_path.get("quantized", 0)
        row["image"] = by_path.get("image", 0)
        row["amp16"] = by_path.get("amp16", 0)
        if name in build_info:
            row["build"] = build_info[name]
        for more in row.get("more", ()):
            # LayerNorm's other gamma/beta dtype under the same x
            x_dt, _, g_dt = more.get("dtype", "").partition(" x, ")
            if g_dt.endswith(" gamma/beta"):
                more["launches"] = sum(
                    n for counts in PATH_DTYPES.values()
                    for (k, dts), n in counts.items()
                    if k == kernel and tuple(dts) == (
                        x_dt, g_dt[:-len(" gamma/beta")]))
    rtc_row["launches_by_path"] = {**{p: 0 for p in PATH_DTYPES},
                                   "rtc": rtc_row["launches"]}
    rtc_row["graph"] = rtc_row["script"] = rtc_row["optim"] = 0
    rtc_row["data"] = rtc_row["sparse"] = rtc_row["vision"] = 0
    rtc_row["rnn"] = rtc_row["legacy"] = rtc_row["interleaved"] = 0
    rtc_row["quantized"] = rtc_row["image"] = rtc_row["amp16"] = 0
    log(json.dumps({"kernels": list(kernels.values()) + [rtc_row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
