#!/usr/bin/env python3
"""Smoke run of the PyTorch port (analytics_zoo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. card    — name and power limit, from nvidia-smi
2. build   — nvcc builds every CUDA kernel from ops/csrc into build/kernels,
             one nvcc per source, all started together
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA tensors, at the main paths' shapes plus ragged ones,
             with kernel, plain and one-call library times (CUDA events)
             beside the least time the card could take:
             - the binding's floor: an empty kernel launched through the
               lookups' ctypes path
             - the fused lookup, bitwise (NaN rows compare as NaN): NCF's
               tables, mixed widths, ids out of range, the user table's
               rows one element past 16 bytes, and a wide case (b 65 536,
               8 tables of 100 000 x 64, concat and sum), fp32 and bf16;
               timed as the public call, the launcher alone and the
               public call replayed from a CUDA graph (device time); one
               public call under torch.inference_mode() makes exactly one
               launch (launch counts and the profiler)
             - flash attention forward (bf16 on the tensor cores, fp32
               on CUDA cores), fp32 within FLASH_ATOL, bf16 within
               FLASH_BF16_* (two faulty controls must fail that limit):
               BERT-Base's shape (b 32, s 512, h 12, d 64, q/k/v strided
               views of the packed projection), causal s 512, ragged s
               500, causal sq 128 over sk 512, one case with the lse, the
               fine-tuning shape (s 128, packed, with the lse) and d 128
             - flash attention backward, the dq and dk/dv kernels
               (phase 3c; bf16 on the tensor cores, fp32 on CUDA
               cores), fp32 within BWD_ATOL of the largest gradient,
               bf16 within BWD_BF16_* with a term of BWD_BF16_FLIPS ds
               or p rounding flips (bwd_flip_scale; three faulty
               controls, ds left unrounded before dS.K and dS^T.Q and p
               before P^T.dO, must fail it), two launches bit for bit:
               the fine-tuning shape (b 32, s 128, h 12, d 64, q/k/v
               strided views of the packed projection, dO strided), the
               serving shape s 512, causal s 512, ragged s 500, causal
               sq 128 over sk 512, rows that see no key (96 over 40), a
               case with a random lse cotangent, d 128 (s 512) and d 40
               (causal ragged s 500, with the cotangent); the library
               yardstick is the backward of scaled_dot_product_attention
               (its forward plus backward less its forward, each
               replayed from a CUDA graph so that the autograd engine's
               host time does not enter)
4. slice   — NeuralCF at MovieLens-1M width (6040 users, 3706 items, 5
             classes, embeddings of 20, hidden (40, 20, 10), GMF 20), with
             weights drawn from a numpy seed, served by
             InferenceModel(device="cuda").predict on 8000 rows and held
             against the same model on the CPU (plain path)
5. serving — the Python broker + ClusterServing answer a burst of records
             and a run of single requests; every result is held against
             the direct predict
6. BERT    — the BERT-Base, Uncased classifier (2 classes, use_flash=True,
             weights drawn from a numpy seed) predicts 32 x 512 tokens
             through InferenceModel(device="cuda").load_torch, fp32 with
             TF32 off: held against the same weights with use_flash=False
             (the einsum chain on cuBLAS) over the whole batch and against
             the CPU on 2 rows; then bf16 against its own use_flash=False
7. BERT serving — a burst of 128 records at batch 32 and 20 single
             requests of int32 input_ids / token_type_ids through the
             Python broker + ClusterServing; every answer equals predict

8. BERT fine-tuning — the same classifier at 32 x 128 tokens: (a) one
             step's loss and every gradient with use_flash=True against
             use_flash=False (the einsum chain under autograd), dropout
             off, fp32 with TF32 off and bf16; (b) Estimator.from_torch(
             ..., optimizer="adam").fit for 10 steps with dropout 0.1, in
             fp32 and bf16 (finite losses, step ms on the host clock after
             a warm-up step, samples/s), then evaluate and predict; (c)
             each of the three flash kernels launched 12 times per step
9. decode  — bench.py's decode configuration: Seq2Seq(8, 8, hidden 64,
             GRU, encoder 8, decoder 4), weights from a numpy seed, batch
             8, 32 greedy steps, page size 8. (a) InferenceModel(
             device="cuda").load_zoo, warm_decode(33), greedy generate
             (tokens/s, p99 step ms on the host clock); raw generate over
             the rungs bitwise the exact-length loop and within
             DECODE_RAW_ATOL of the CPU; (b) 4 streams through one
             DecodeScheduler, interleaved and one at a time, bitwise (a);
             (c) self-drafted speculative generate (spec_k 4) bitwise (a),
             its accept ratio; (d) paged="force" bitwise "off" and (a), in
             fp32 and under ZOO_KV_DTYPE=int8 (paged tokens/s, tune_paged's
             speedup, KV bytes per sequence); (e) paged_attention on the
             scheduler's live pool, tables and lengths mid-drain against
             its plain version (in float64); (f) ClusterServing answers a burst of 32
             generate records (32 tokens, engine batch 8) and 10 single
             ones, each bitwise greedy generate of its row (records/s,
             tokens/s, single-request p50), its paged="auto" by the step
             verdicts built first (paged steps and host-gather steps
             printed)
10. NCF training — bench.py's measure_ncf (NeuralCF at MovieLens-1M
             width, Adam(1e-3), batch 8000, 400 000 rows, weights from a
             numpy seed) through keras compile/fit: (a) one step on the
             card against the same step on the CPU, the loss and every
             parameter within NCF_STEP_*_ATOL and every table moved; (b)
             fit one epoch (50 steps) after a warm-up step (step ms on the
             host clock, samples/s, finite losses), evaluate and predict;
             (c) 2 lookup and 4 scatter-add launches a step; (d) the same
             for NCF with a pooled item-history column (Embedding(3707,
             20, pooling="mean") over 8 ids): 1 bag and 5 scatter-add
             launches a step
11. checkpoints — the JAX package's layout (learn/checkpoint.py): (a)
             NCF at MovieLens-1M width (Adam(1e-3), batch 8000, 2 epochs
             of 12 steps) fit with set_checkpoint and SeveralIteration(5),
             once plain and once with ZOO_FAULT_PLAN failing step 18 and
             auto_resume=True (resumed from ckpt-15, 3 batches into its
             epoch): parameters, optimizer state, step, step losses and
             history bitwise equal; (b) save_model of the trained model,
             InferenceModel(device="cuda").load of it predicts bitwise
             what the live model predicts, and serves a burst through
             ClusterServing; (c) the JAX package's checkpoints committed
             in tests/data/jax_checkpoints load on the card and predict
             within CKPT_JAX_ATOL of JAX's stored predictions (Seq2Seq:
             the same greedy tokens); (d) the history-column NCF and the
             BERT-Base classifier (all 12 blocks, one Adam step at 32 x
             128) round-trip through save/load with bitwise equal
             parameters, optimizer state and predictions (the BERT
             predict of 32 x 512 through the flash kernel); (e) write
             and read ms and MB of (a) and (d), host clock, beside the
             card's name and power limit

12. zoo models — the keras training surface: (a) Wide&Deep wide_n_deep at
             bench.py's measure_widedeep_train width (WND_DIMS, batch
             1024, Adam, its data from numpy seed 4): the lookup and the
             scatter-add at its tables (8 and 64 wide) bitwise against
             their plain versions; one step card against CPU (loss and
             every parameter within WND_ATOL, both tables moved); with
             set_tensorboard on, a warm-up fit of one step, then a fit of
             WND_STEPS steps (1 lookup and 2 scatter launches a step, the
             Loss, Throughput and LearningRate events read back at the
             flush steps, its ms a step), then bench.py's step window
             (widedeep_train_step_ms and _samples_per_sec: the batch on
             the card, STEP_WARMUP steps, STEP_WINDOW timed, host clock);
             predict against the CPU and save_model ->
             InferenceModel.load -> predict bitwise; the wide and deep
             variants one step (against the CPU) and one predict each;
             (b) SessionRecommender at MovieLens-1M's 3706 items (session
             and history 8, batch 1024): one step against the CPU at the
             CPU test's limits, a short fit, recommend_for_session's top
             SR_TOPK equal to the CPU's; (c) AnomalyDetector (8, 32, 15):
             one step with dropouts 0 against the CPU, a fit with
             dropouts 0.2 whose loss falls, detect_anomalies finding the
             spikes put into the targets; (d) Seq2Seq.fit at the decode
             configuration: one step against the CPU, a short fit, greedy
             infer bitwise the exact-length loop and generate; each of
             (a)-(d) also holds one batch's gradients on the card against
             the CPU's (each leaf within ZOO_GRAD_RTOL of its largest),
             and times its step in the step window; (e) a regularized
             Sequential's loss, penalty included, equal to the CPU's
             within WND_ATOL, its gradients as (a)-(d)'s; (f) the JAX
             package's committed Wide&Deep predicts within CKPT_JAX_ATOL of
             JAX. It writes under build/phase12/ and removes it.

13. Zouwu's TCN — bench.py's measure_tcn (TemporalConvNet, channels (32,
             32, 32), kernel 7, dropout 0.2, batch 256 x 96 x 8, Adam, mse)
             through the Orca entry points: (a) init_orca_context() with
             default_matmul_precision "float32" (the device count, the
             mesh, both TF32 flags off); (b) bench.py's step window
             (measure_tcn's batch from default_rng(2) on the card, 3
             warm-up steps, 20 timed, host clock) in fp32 with TF32 off,
             under the context's default "bfloat16" (TF32), and under the
             mixed_bfloat16 policy: ms a step, tcn_steps_per_sec,
             tcn_samples_per_sec; (c) one Adam step at dropout 0 on the
             card against the CPU (loss and every parameter within
             TCN_STEP_*_ATOL, basis dev/estimate_tcn_train_limits.py) and
             one batch's gradients (each leaf within ZOO_GRAD_RTOL of its
             largest); (d) 10 240 windows with the CPU tests' linear target
             in 16 XShards under DISK_4, TCNForecaster.fit through the
             streaming feed (a warm-up epoch, then 2 epochs of 40 steps,
             timed): every row once an epoch, peak_window_rows within a
             window of 4 shards plus a batch, the loss falling; then with
             shuffle=False the DISK_4 fit ends bitwise where the DRAM fit
             ends (cuDNN's deterministic algorithms for both); (e) predict
             and evaluate (mse, mae, smape) against the CPU from the same
             checkpoint, save/restore on the card bitwise, the JAX
             package's committed TCNForecaster within CKPT_JAX_ATOL of
             JAX, and LSTMForecaster and Seq2SeqForecaster fits card
             against CPU at the CPU tests' limits. No kernel of the port
             runs on this path (cuDNN's convolutions; JAX's TCN runs
             outside Pallas). It writes under build/phase13/ and removes
             it, and restores the precision flags and the knobs.

14. the estimator's loop options and the BERT task estimators (ROADMAP
             A3): (a) measure_ncf's NCF (Adam(1e-3), batch 8000, 400 000
             rows) through TorchEstimator.fit per step,
             fit(steps_per_loop=10) (bench.py's "staged") and
             fit(cache="device") ("cached"), three epochs each with
             shuffle off: staged and cached bitwise the per-step fit in
             every parameter and step loss; two epochs of each timed in
             turns (ms a step, samples/s), one profiled for host-to-device
             copies and kernels a step over 10 steps after a lead of 2 (a
             loop for the staged fit; the cached epoch makes no copy);
             a shuffled cached epoch's order on the card covers every
             row; (b) each of the eight optimizers (rmsprop, adagrad,
             adadelta, adamax, nadam, lars, lamb, lbfgs with its 100
             corrections), 20 NCF steps on the card: its updates replayed
             on the CPU from the same parameters and the card's gradients
             within NCF_STEP_PARAM_ATOL (L-BFGS: its last update, from the
             card's state before it), and the fit against the CPU's
             within NCF_STEP_*_ATOL in every step's loss and every
             parameter (rmsprop, adadelta and lbfgs, whose trajectories
             amplify the card's other order of summation, in the loss
             within AMPLIFIED_LOSS_ATOL); a LAMB checkpoint read back
             bitwise (bytes included); (c) the
             BERT-Base classifier on token ids (32 x 128, dropout 0.1,
             use_flash=True): a step with remat against one without from
             the same weights and step seed within phase 8's limits (fp32,
             TF32 off, and bf16); a bf16 remat fit launching the flash
             forward 24 times a step and each backward kernel 12; peak
             memory and ms a step with remat off and on at batches 32, 64
             and 128; fit(steps_per_loop=16) ms a step and samples/s at
             the same batches (bench.py's bert_scan_step_ms and its
             sweep); a LAMB fit; (d) BERTNER (9 tags, 32 x 128) and
             BERTSQuAD (12 x 384, AdamWeightDecay) with ragged masks: one
             batch's loss and gradients at full width with 2 blocks on the
             card against the CPU (ZOO_GRAD_RTOL of each leaf's largest;
             SQuAD SQUAD_GRAD_RTOL),
             then a 5-step fit at full depth (SQuAD with remat off and
             on: peak memory, ms a step); (e) a profile_steps=(2, 5) fit
             writes a trace holding exactly steps 2-4, its kernels inside
             those steps' ranges on the card. It writes under
             build/phase14/ and removes it.

15. Cluster Serving's scheduling and delivery (ROADMAP A7): (a) the
             native broker built from the port's own zbroker.cpp
             (backend="native", asserted), its lanes, XCLAIM, XSHED and
             XPENDING DETAIL; (b) NCF at MovieLens-1M width (engine batch
             256, max 1024, warm-up on) answering a burst of 512 (384
             batch-lane and 128 interactive records, interleaved) and 50
             single requests, on the Python and the native broker in turns
             (records/s per lane, the engine's p50 and p99 per lane,
             single-request p50), every result bitwise the predict at the
             rung its batch rode; (c) BERT-Base bf16 (use_flash=True): a
             fresh engine without warm-up whose first batch lands on rung
             12, which no model of the process ran, then
             ClusterServing(warmup=True) over rungs 8-32: seconds from
             start() until every rung is ready, the ms of 4 requests one
             after another on each, a burst of 192 whose bucket grows
             only onto ready rungs, 12 flash launches a batch, every
             result bitwise predict at its rung; (d) 64 records with
             deadline_ms=1 behind 256 held ones end as typed expired
             results, the rest as results, none pending; (e) an
             SLOMonitor forced to burn sets XSHED on the batch lane (a
             batch enqueue raises ShedError, interactive is served), and
             clearing the burn clears it; (f) 32 entries a consumer read
             and never acked are reclaimed under a 200 ms lease, each
             result written once (time to recovery); (g) measure_decode's
             Seq2Seq, paged: 24 batch-lane generate records of 32 tokens
             with 32 interactive predicts interleaved (max wait 20 ms),
             tokens bitwise greedy generate, preemptions above 0 and at
             most 4 a step, one gather launch a paged step, one cost
             entry a record; then self-drafted (spec_k 4), still bitwise;
             (h) the HTTP frontend over (b)'s last engine: POST /predict
             bitwise, 429 on a shed lane, 504 on a lapsed deadline, GET
             /metrics' Prometheus text counting the records served,
             /healthz, /slo and /query answering 200. Phases 5, 7, 9(f)
             and 11 keep the Python broker and a pinned bucket without
             warm-up, as before.

16. the rest of Cluster Serving (ROADMAP A7b): (a) bench.py's
             measure_int8_predict NCF half (MovieLens-1M width, 4096 rows,
             calibration on 256, min_elems 1024): fp32, weight-only and
             int8 predict ms (CUDA events), resident bytes, argmax
             agreement >= 0.97 and nrmse < 0.1 against fp32 (JAX's
             limits), each int8 layer's output bitwise the same layer on
             the CPU fed the same input, B1 launched in every mode; (b)
             phase 6's BERT-Base classifier at 32 x 512, fp32 (TF32 off)
             and bf16: float, weight-only and int8 predict ms, resident
             bytes, agreement and nrmse at (a)'s limits, 26 int8 products
             a forward by the profiler's kernel names (the attention
             projections stay float), 12 flash launches a predict; (f)
             20-step fits of phase 8's BERT-Base bf16 (32 x 128) and phase
             10's NCF (batch 8000) under the step profiler: zoo_step_flops
             at least the hand count of the step's products and within
             P16_FLOPS_MARGIN above it (C18), NCF's equal to the same
             step counted on the CPU, 0 < zoo_mfu
             <= 1, zoo_hbm_bytes, the phase medians, and NCF's ms a step
             with and without the sampled fences in turns; (c) (a)'s int8
             model served through ClusterServing on the native broker,
             every result bitwise its predict; (e) a lone record's GET
             /trace spans (dequeue, preprocess, device, postprocess) in
             order, none negative, their sum within its end-to-end
             latency; the flight recorder's dump holding spans and a
             snapshot; /healthz's backend naming the card; (d) a replica
             started from a config.yaml (python -m
             analytics_zoo_tpu_torch.serving.start, on the card) and one in
             this process on one native broker, heartbeat 0.25 s, stale
             after 1 s, lease 300 ms: /healthz lists 2, a burst of 512
             (the first half while the in-process replica is stopped, so
             each replica takes a share) whose ?scope=fleet count equals
             the replicas' own (512); a second burst that the subprocess
             alone takes, frozen while it holds leased entries (XPENDING
             DETAIL) and SIGKILLed, then the in-process replica started
             again: every record answered, none pending, the survivor's
             lease reclaims above 0, /healthz 1 live and 1 stale, the
             seconds from the kill to the last answer. It writes under
             build/phase16/ and removes it.

17. ResNet-50 (ROADMAP A15), through ImageClassifier's keras entry
             points, NHWC inputs, weights from a numpy seed: (a) bench.py's
             measure_resnet50_train window (resnet-50, 2 classes, 224 px,
             mixed_bfloat16, Adam, batch 32 from default_rng(3) on the card
             once, 2 warm-up steps, 10 timed on the host clock between two
             syncs): ms a step, samples/s; the same in fp32 under TF32 (the
             context's default) and with TF32 off; a 4-step fit under the
             step profiler: zoo_step_flops at least the hand count of the
             convolutions' products over the taps inside their inputs and
             the Dense's, and within P17_FLOPS_MARGIN above it (C18), and
             0 < zoo_mfu <= 1; (b) one step on 4 rows from the same
             weights against the same step in float64 on the CPU (TF32
             off; basis dev/diagnose_resnet50_step.py): in float64 on the
             card the loss, every gradient of its leaf's largest, the
             running means and variances and the eval logits at 1e-5,
             5e-6 (of the leaf's largest), 1e-5 and 1e-5; in fp32 the loss, the train and eval logits
             (before the softmax), the head's gradient and the running
             statistics at P17_FP32_*, the whole gradient and the worst
             leaf within P17_FP32_OVER_CPU of the CPU fp32 step's own
             distances; in bf16 the loss, the train logits, the head's
             gradient and the stem convolution's output at P17_BF16_*;
             save and load bitwise, batch_stats included;
             (c) measure_int8_predict's ResNet-50 half (1000 classes, 32 x
             224, calibration x[:8], min_elems 1024): fp32 (TF32 off),
             bf16 and int8 predict ms (CUDA events), resident bytes,
             agreement and nrmse against fp32 at JAX's limits on the
             probabilities and on the logits (the random model's softmax
             is one-hot), the int8
             products of a forward by the profiler's kernel names (54),
             and an int8 3x3 stride-2 and 1x1 convolution each bitwise the
             same layer on the CPU; (d) a profiled bf16 training step: the
             top device operations, the shares of cuDNN's convolution
             kernels, cuBLAS's GEMMs and the batch norms' kernels, the
             kernels a step, device time against wall time, and the copies
             of 4-D activations (at most the input's cast). No kernel of queue B runs on this path
             (cuDNN's convolutions and cuBLAS's products; JAX runs
             ResNet-50 outside Pallas). It writes under build/phase17/ and
             removes it.

18. image classification from images to answers (ROADMAP A15's
             remainder, A11's image part, A16's load_checkpoint), 224 px,
             1000 classes, batch 32: (a) mobilenet, inception-v1 and
             mobilenet-v2 (weights from a numpy seed): eval logits on the
             card in fp32 (TF32 off) and bf16 against the same forward in
             float64 on the CPU (4 rows) at P18_FP32_RTOL and
             P18_BF16_RTOL (basis dev/estimate_image_limits.py), predict
             ms; (b) ImageClassifier(pretrained=twin.state_dict()) for
             resnet-50, mobilenet-v2, squeezenet, densenet-121, alexnet
             and vgg-16 against its torchvision-layout twin on the card (8
             rows, fp32, TF32 off): probabilities within 1e-4 (JAX's),
             logits within 1e-4 of their largest, top-1 equal; the keras
             graph's forward ms beside the twin's; (c) 64 uint8 images of
             375 x 500 and 500 x 375 -> ImageSet.from_arrays -> the
             torchvision preset -> the imported ResNet-50's
             predict_image_set -> LabelOutput(top_k=5), held against the
             twin, the host's preprocessing ms an image beside predict's;
             (d) that ResNet-50 in ClusterServing on the native broker
             (batch 32 pinned): 64 tensor records, every answer bitwise
             the predict at batch 32, records/s and a lone request's p50,
             then a PNG record by enqueue_image (answered where the host
             has PIL, the typed error naming PIL where not) and a tensor
             record after it; (e) int8 mobilenet-v2 calibrated on 8
             batches: 53 products (36 int8 GEMMs by kernel name, 17
             depthwise), agreement and nrmse of the logits at JAX's
             limits, a depthwise layer at stride 1 and 2 and a 1x1 layer
             bitwise their CPU selves, predict ms fp32 / bf16 / int8; (f)
             ResNet-50 fit for 2 steps at batch 8 with a checkpoint every
             step, then InferenceModel.load_checkpoint into a fresh
             classifier: predict bitwise the fitted estimator's. It
             writes under build/phase18/ and removes it.

19. text from words to answers (ROADMAP A16's rest, A8, A11's text
             part): (a) 1000 seeded texts of 50-500 tokens through
             TextSet (tokenize, normalize, word2idx of the 5000 most
             frequent words, shape_sequence(500), generate_sample) on the
             host, ms per 1000 texts, four shards bitwise one; (b)
             TextClassifier (20 classes, 500 x 200-d, 256-wide encoder;
             the 20 Newsgroups app's widths) for cnn, lstm and gru, fp32
             (TF32 off) and mixed_bfloat16: a fit step's ms and samples/s
             at batch 128 (2 warm-up, 5 timed; the recurrent ones 1),
             predict ms (CUDA events), kernel launches a step (profiler;
             the recurrent ones' in fp32),
             one step on 8 rows against float64 on the CPU (loss, logits,
             the head's gradient at P19_*_LIMITS, basis
             dev/estimate_text_limits.py), the recurrent outputs fp32;
             (c) the cnn classifier imported from its torch twin within
             1e-6 of it, top-1 equal, then 128 id records served on the
             native broker bitwise the predict at batch 128; (d) KNRM
             (WikiQA's 10 x 40 ids, 300-d, 21 kernels, batch 200): fit and
             predict ms, NDCG@3 and MAP over 16 queries equal to the
             CPU's, a step against float64; (e) a frozen
             WordEmbedding.from_glove of a 300-d file the phase writes:
             after 2 steps bitwise the file, no parameter, no optimizer
             state; (f) load_hf_bert of a HuggingFace-layout BERT-Base
             dict (numpy seed 0) into a bf16 BERTClassifier(2) after one
             fine-tuning step: the encoder bitwise the dict, the head
             unchanged, the step 0; predict of 32 x 512 within phase 6's
             limit of the same weights through convert, 12 flash
             forwards; 2 more steps at 32 x 128 with 12 launches of each
             flash kernel a step; (g) LSTMForecaster and Seq2SeqForecaster at bench.py's
             TCN batch in fp32 and mixed_bfloat16: ms a step, predict
             against float64, fp32 recurrent outputs; (h) NeuralCF through
             Estimator.from_keras, 20 steps of 8000 with 2 lookups and 4
             scatter-adds a step, bitwise the compile/fit path. It writes
             under build/phase19/ and removes it.

20. Zouwu's AutoTS (ROADMAP A11's Zouwu and AutoML half), TF32 off: a
             seeded series of NAB nyc_taxi's shape (10 320 half-hourly
             rows from 2014-07-01, daily and weekly cycles; 8256 / 1032 /
             1032 in time); (a) AutoTSTrainer with GridRandomRecipe() at
             its defaults (VanillaLSTM and TCN, look_back 24) but 1 epoch
             (a cut, P20_GRID_EPOCHS):
             each trial's config, history, status and seconds, the best
             trial, the pipeline's predict ms, evaluate (mse, smape), an
             incremental fit, save -> TSPipeline.load bitwise, each
             trial's fit step ms and launches (profiler); (b) the saved
             pipeline on the CPU within 1e-5 of the card's forecasts
             (relative to the largest); (c) BayesRecipe(num_samples=3,
             epochs=1), each config the CPU's BayesSearcher's; (d)
             PopulationSearchEngine over 16 TCNs (30, 30, 30), kernel 3,
             batch 64, 1 epoch (a cut) beside LocalSearchEngine over
             the first 4 of its configs serially for 1 epoch (a cut):
             seconds, ms a
             member-epoch, the speedup (no timing asserted), every
             member's first step within 1e-6 of a plain AdamWeightDecay
             step, the best member within 1e-5 of itself trained alone
             (both under cudnn.deterministic; the default population
             printed against them); (e)
             TCNGridRandomRecipe(num_rand_samples=2, epochs=1), 4 trials
             (a cut from 4 draws), n_parallel=4 against 1 under
             cudnn.deterministic: seconds, the histories within 1e-6
             relative, bitwise or not, and n_parallel=4 with cuDNN's
             defaults printed against them; (f) MTNet at
             MTNetGridRandomRecipe's widest (4 x 8 steps, 32 filters,
             GRUs (16, 32), AR 4), batch 64, fp32 and mixed_bfloat16: ms a
             step (2 warm-up, 5 timed), launches, predict ms, a step on 8
             rows against float64 on the CPU at P20_MTNET_*_LIMITS (basis
             dev/estimate_zouwu_limits.py); (g) TCMFForecaster(rank=64,
             svd=True) on a seeded panel of DeepGLO's electricity width
             (370 x 25 968): fit seconds, ms and launches a factorization
             step, the device's busy share, mse, predict(24) ms,
             fit_incremental of 24 columns, save/load bitwise, F, X and
             the mse against the same 300 steps in float64 on the card
             within P20_TCMF_FACTOR times the CPU's own distance,
             use_local=True
             on the first 256 columns with max_TCN_epoch=1 (a cut); (h)
             AEDetector (roll 24, hidden (16, 8)) on the series: fit ms,
             scores within 1e-5 of the CPU's from the same weights, equal
             anomaly indexes and ThresholdDetector indexes,
             DBScanDetector refused naming scikit-learn where absent.
             Every trial of (a) and (c)-(e) must end done (or stopped),
             never in error. It writes under build/phase20/ and removes
             it.
21. object detection (ROADMAP A10, A11's first part), TF32 off:
             SSD300-VGG training at batch 32 x 300 px in fp32 and bf16
             against float64 on the CPU, ObjectDetector's predict, the
             fixture overfit, the runtime hooks, int8 recurrent cells and
             the new layers, Arrow and encrypted records (phase_detection)
22. the autotuner and Friesian (ROADMAP A9's first part, A11's second
             part, C24), TF32 off: (a) tune_attention at BERT serving's
             shape (32 x 512, 12 heads, d 64) in bf16 and fp32 with the
             einsum chain's time beside, then BERT-Base at use_flash=None
             under ZOO_AUTOTUNE=sync: 12 flash launches a forward where
             the verdict took the kernel, none where it took the chain,
             the output within BERT_ATOL / BERT_BF16_ATOL of the
             use_flash=True model; (b) bench.py's measure_flash_attention
             (causal bf16 4 x 2048 x 8 x 64, 20 chained calls): blockwise,
             the kernel, the auto_flash_attention route,
             flash_vs_blockwise_speedup and flash_kernel_raw_speedup; (c)
             the lookup's (NCF's tables, batch 8000), the bag's (8000 x 8,
             d 20, mean), the gather's and the paged attention's (decode's
             shape) verdicts, each against its plain version, read back by
             a fresh tuner, then one public call each: one launch,
             whatever the verdict; (d) in ZOO_AUTOTUNE=on a BERT predict
             at 16 x 512 queues its shape and takes the chain,
             warm_up(block=True) drains the queue, the verdict is on disk
             and the next predict follows it; the zoo_autotune_* values;
             (e) decode through DecodeScheduler(paged="auto") with every
             step shape's verdict built first by tune_paged: the route
             each step took, gathers equal to paged steps, tokens bitwise
             greedy generate; (f) bench.py's measure_recsys_pipeline
             (40 000 rows, 8 shards, 600 users, 300 items): the Friesian
             chain legacy and vectorized (their positive rows equal; their
             negatives come from other shards by design), the faster one's
             streaming feed into an NCF fit on the card
             (recsys_pipeline_samples_per_sec, friesian_transform_speedup,
             B1 and B1b launches a step), and its first 5 steps against the
             CPU within P22_FIT_ATOL; (g) the chain at MovieLens-1M's shape
             (250 052 rows, a quarter of its ratings, 6040 users, 3706
             items; synthetic) under DRAM
             and NATIVE_4, the tables bitwise equal, NCF at ML-1M width one
             epoch of batch 8000 from the NATIVE_4 feed within the tier's
             window bound (samples/s with and without the transforms);
             (h) TorchEstimator.predict of 80 000 rows at pipeline windows
             1, 2 and 4, bitwise (ms each). A kernel's verdict against its
             plain version that the kernel lost is printed as a queue-B
             finding.
C20. cuDNN's noise (ROADMAP C20): init_orca_context now takes cuDNN's
             deterministic algorithms; the TCN step (phase 13, fp32, TF32
             off), the ResNet-50 bf16 step (phase 17) and the SSD300-VGG
             bf16 step (phase 21) timed at their windows with
             cudnn.deterministic on and off in turns (on, off, off, on),
             the ratio printed (over 1.5x named as such); two serial AutoTS
             TCN searches under init_orca_context held bitwise (c20_cost)
23. the strategies across ranks (ROADMAP A9's second part, first half),
             TF32 off, through parallel/launch.py: a group of 2 and a group
             of 4 ranks share the card over gloo (NCCL refuses two ranks
             on one card), each rank adopting the launcher's group through
             init_orca_context(cluster_mode="multihost"), and a one-rank
             NCCL group made by the context itself (beside the group of
             4). Every rank of a group
             runs every part: (a) the collectives against the same data
             movement on one rank (all_gather, all_to_all, ring_shift
             bitwise; all_reduce and reduce_scatter within 1 ulp a
             summand, bitwise at 2 ranks; on the card gloo carries all
             but ring_shift directly, dev/gloo_cuda_probe.py), the gloo
             staging table, and on
             the NCCL group an NCF fit bitwise the fit before the group;
             (b) BERT-Base fine-tuning (BertConfig's defaults, 2 classes,
             32 x 128, Adam(2e-5), dropout 0, 2 steps, fp32 and bf16)
             under "dp", "fsdp" and "dp,tp2" (bert_tp_rules) over 2 ranks
             and "dp2,tp2" over 4, held to the one-rank fit on the same
             global batches (loss 1e-5 fp32 / 1e-2 bf16, every parameter
             1e-5 in fp32), the bytes a rank holds (no sharded leaf
             whole), 12 launches of B3-B5 a step on 12 / tp heads, ms a
             step of the last four and the collectives' share; (c) NCF at
             MovieLens-1M width (batch 8000, Adam(1e-3), 20 steps) under
             "dp" and "tp2" (NeuralCF.tp_param_rules) over 2 and "dp2,tp2"
             over 4: the loss of every step within 1e-5 of the one-rank
             fit, every parameter within 1e-5, or, where a ReLU input
             took the other side of 0 from the one-rank fit's (a rank's
             GEMMs see other shapes), all but 0.2% of the elements within
             1e-5 and all within 5e-4, the first flipped inputs within
             1e-5 of 0 (P23_NCF_FLIP_*), B1 and B1b on the tables' 10-wide
             column blocks; (d)
             ring attention (b 2, s 8192, h 12, d 64, "sp2" / "sp4", fp32
             and bf16, causal and not) on each rank's sequence block: the
             output and dq, dk, dv against the one-rank flash kernel over
             the whole sequence within phase 3's limits (bf16 with p - 1
             more ulps of the largest element for the block partials'
             roundings, no share limit), fp32 also against the float64
             softmax, B3 launches p or causal rank + 1, ms forward and
             backward; the plain ring on the card too, held alike (no
             launch); (e) Ulysses at the same shape, held alike, one B3
             launch a forward on 12 / p heads; (f) MoE at Switch-Base-8's
             FFN widths (d_model 768, d_ff 3072, 8 experts, top-1,
             capacity factor 1.25, 8 x 512 tokens) under "ep2" / "ep4":
             output, aux loss and every gradient within 1e-5 of one rank's
             (of each one's largest element), the tokens a rank's experts
             took, and a "dp2,ep2" training step with ep_param_rules
             within 1e-5 of the one-rank step (phase_parallel)
24. pipelines and sharded serving (ROADMAP A9's third part), ranks
             sharing the card over gloo: the pipelined MLP and the LM at
             BERT-Base's block widths (phase_pipeline_serving)
25. the readers, autograd, keras2, nnframes, the GAN and the model
             importers (ROADMAP A11's third part, A13), TF32 off: (a) 80
             000 ratings in MovieLens-1M's id ranges written as TFRecords
             (8 files), read back and fit by NCF (measure_ncf's batch,
             10 steps), every loss bitwise the fit from the arrays, 2 B1
             and 4 B1b launches a step; (b) the ratings through an
             in-process stub of Elasticsearch's REST API (write_df, then
             read_df by scroll), frames and dtypes equal, NCF predict of
             the read rows bitwise, 2 B1 launches; (c) image parquet
             (MNIST-shaped ndarrays and PNGs) read back bitwise, a
             LeNet-5-sized fit from read_as_dataset; (d) a keras2 model
             with a Lambda and the Node sugar, a CustomLoss of mean
             absolute error against loss="mae" step by step; (e)
             NNClassifier fit and transform (prediction = argmax of
             predict), NNImageReader; (f) an MLP GAN at MNIST width,
             minimax and lsgan, step 0 against plain autograd; (g) a
             BERT-Base-wide nn.TransformerEncoder served through
             Net.load_torch and InferenceModel.load_torch: 12 B3
             launches a forward at use_flash=None after the shape's
             verdict, within P25_ENCODER_ATOL of torch's own run; ResNet-
             50's twin bitwise itself; (h) the twin written as ONNX and
             as IR v10 by the phase's own writers, served by
             Net.load_onnx and InferenceModel.load_openvino within
             P25_IMPORT_RTOL of the module (phase_readers_importers)
  26. zoolint for the port, on the card's host (no JAX there): the CLI
      over analytics_zoo_tpu_torch with dev/zoolint-torch-baseline.json
      must exit 0, over tests/fixtures/zoolint_torch without a baseline
      must exit 1 with every rule family tripped (and, in --format
      github, print one ::error line a finding), and the analyser must
      load no JAX and nothing of the JAX package; the counts and seconds
      are printed (phase_zoolint)
  27. the examples: every script of examples_torch/ (one per JAX example,
      tests/test_examples.py's order) on the card with its default
      device; distributed_training and multihost_launch start their
      ranks as subprocesses (the ranks share the card over gloo), started
      first and run beside the others, which run in this process through
      runpy with the launch counts zeroed just before each and read just
      after; each must exit
      0 (its own asserts hold), and recommendation_ncf and wide_and_deep
      must launch B1 and B1b (phase_examples)

The autotuner: the run keeps its verdicts in a file of its own
(build/chip_smoke_autotune/, ZOO_AUTOTUNE_CACHE), empty at the start and
removed at the end, and runs with ZOO_AUTOTUNE=off but where a phase sets
the mode: 9(f) and 15(g) build the serving engine's step verdicts first
(tune_paged at every step shape, persisted) and serve under "on", so
paged="auto" takes the paged step or the host gather as each verdict
says (the gathers must equal the paged steps, and no shape may miss);
9(f) then serves one more burst with the engine's scheduler at
paged="force", so the engine's paged route (B6 inside) runs on every run
whatever the verdicts picked; phase 22 sets each part's mode. A kernel
candidate that raises while measured on the card raises
(autotune.AutotuneFault) and is never saved as a verdict.

Phase 3d holds the paged kernels against their plain versions: the
gather bitwise (fp32 and int8; the decode slice's shapes, the serving
engine's 17-page table, a wide pool of 4096 positions at d 128; lengths 0,
a page boundary, mid-page and full; dead pages poisoned; table entries
out of range; an out_len trim), the decode attention within PAGED_RTOL /
PAGED_ATOL (JAX's limit for its kernel) of its plain version computed in
float64 (JAX's float32 one is timed, and its distance from the float64
one recorded) with empty rows exactly zero and dead pages invisible (the
slice, JAX's test shape, a wide pool of 4096 positions and a long one of
32 768 at d 128, batch 8), and where the plan splits the rows (wide,
long) the combine within the same limit of its plain version on the
split kernel's partials. It first checks, under torch.inference_mode(),
that a public gather is one launch and a public attention one launch
unsplit and two split (launch counts and the profiler). Each case is
timed as the public call (events), replayed from a CUDA graph (device
time; the split kernel and the combine apart from the profiler), beside
its plain version, its bound, and for information the two-call route
pool[table] + scaled_dot_product_attention (not a yardstick: it computes
more). The decode path (phase 9) must launch the gather and the
attention; phase 3d's public calls the attention and its combine.

Phase 3e holds the bag kernel and the scatter-add kernel (the backward
of the lookup and the bag) against their plain versions bitwise: the
bag at the history column's shape (b 8000, bag 8, d 20) with its lengths
and without (as the keras layer calls it), with lengths 0, partial and
full and ids out of range before and past the length, with table rows
one element past 16 bytes, and a wide case (b 4096, bag 64, d 128, V
100 000), sum and mean, fp32 and bf16, timed as the lookup is (phase 3
checks first that one public bag under inference mode is one launch);
the scatter for each combine of the lookup at NCF's tables (ids
out of range dropped), for the bag, for the bag as the training path
feeds it (no lengths: pad id 0 takes about 28 000 of 64 000 updates, a
run the scatter sums in two levels), and with every id one row (8000 and
64 000 updates), each launched twice for the same bits; with
F.embedding_bag and index_add_ as the one-call yardsticks.

Launch counts are set to 0 right before each path (phases 4-5, the NCF
path; phases 6-7, the BERT serving path; phase 8(b), the fine-tuning
path; phase 9, the decode path; phase 10(b)-(d), the NCF training path;
phase 11, the checkpoint paths; phase 12 from (a)'s warm-up step, the
zoo paths; phase 13, which launches none; phase 14, before each mode's
NCF fits, the optimizers, the remat fit, each task fit and the profiled
fit; phase 15, before each broker turn, after the BERT warm-up, and
before the deadline, admission, lease and each decode path; phase 16,
before each int8 model's predicts, each fit, the served int8 model and
the fleet; phase 17, before its training window, which launches none;
phase 18, before its paths, which launch none; phase 19, before each
of (b)-(h): (b)-(e) and (g) launch none, (f) B3-B5, (h) B1 and B1b;
phase 20, before each of (a)-(h), which launch none; phase 21, before
each of (a)-(f), which launch none; phase 22, before each of (a)-(h):
(a) and (b) B3 (their measurements too), (c) B1, B2, B6 and B7 (the
same), (d) B3 where the drained verdict took the kernel, (e) B6 where a
verdict took the paged step, (f) and (g) B1 and B1b, (h) B1; phase 23,
in each rank before each part: (b) B3-B5, (c) B1 and B1b, (d) and (e)
B3-B5, summed over the ranks) and read right after it: every kernel of
the path must have launched there.
Phases 13's to 20's seconds, phase 26's, phase 27's (and each
example's) and the whole run's are printed before the kernels line. The
second-to-last line is the kernels JSON, the last
``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
NCF = dict(user_count=6040, item_count=3706, class_num=5, user_embed=20,
           item_embed=20, hidden_layers=(40, 20, 10), include_mf=True,
           mf_embed=20)
BATCH = 8000
RAGGED = 37
SEED = 0
SLICE_ATOL = 1e-5   # fp32 GEMMs sum in another order on cuBLAS than on CPU
N_BURST = 512
N_SINGLE = 100
SERVE_BATCH = 256
# BERT-Base, Uncased (google-research/bert uncased_L-12_H-768_A-12): the
# defaults of BertConfig; 2-class head, full-length inputs, no mask
BERT_VOCAB = 30522
BERT_BATCH = 32
BERT_LEN = 512
BERT_CLASSES = 2
BERT_CPU_ROWS = 2
BERT_BURST = 128
BERT_SINGLE = 20
# fp32: cuBLAS and the CPU sum in other orders (CPU estimate at 2-4 blocks:
# 2e-7 between flash and the einsum chain on logits of ~0.3)
BERT_ATOL = 1e-4
# bf16: the kernel keeps fp32 scores where the einsum chain rounds scores
# and probabilities to bf16 (CPU estimate at 2-4 blocks: 1e-3 to 2e-3)
BERT_BF16_ATOL = 5e-2
# kernel vs plain, which rounds at the same points over the same key tiles:
# fp32 sums in another order
FLASH_ATOL = 1e-5
# bf16: |kernel - plain| <= atol + FLASH_BF16_ULPS bf16 ulps of the plain
# value everywhere (a rounding flip is one ulp; atol covers the fp32 sums
# near zero), and at most FLASH_BF16_SHARE of the elements differ at all.
# The forward kernel's scores come from the tensor cores, whose fp32 sums
# of the exact bf16 products round in another order than the plain
# version's fp32 matmul, and its exp is ex2.approx where the plain version
# takes torch.exp: either can round a p = exp(s - m) to its other bf16
# neighbour, which moves every output of the row by up to 2^-8 |v| / l
# (bf16_flip_scale), for a small output many of its own ulps. So the
# forward is also allowed FLASH_BF16_FLIPS such flips per element. Basis
# (dev/flash_bf16_limit.py --seeds 4, H100): at phase 3's bf16 shapes
# over 4 seeds and on the q, k, v of a bf16 BERT-Base predict's 12 layers
# the kernel's largest excess over 2 ulps + atol is 0.94 of one flip
# (share at most 0.24%); the p_unrounded control's is 2.58 flips (share
# 0.39), and the output_truncated control differs on half the elements.
# Two flips leave room on both sides and pass two flips that coincide.
# The two controls (p left unrounded; the output truncated) must fail it.
FLASH_BF16_ULPS = 2
FLASH_BF16_ATOL = 1e-5
FLASH_BF16_SHARE = 1e-2
FLASH_BF16_FLIPS = 2
LSE_ATOL = 1e-5
# BERT fine-tuning: bench.py's batch of 32 x 128 tokens, 10 timed steps
TRAIN_BATCH = 32
TRAIN_LEN = 128
TRAIN_STEPS = 10
# backward kernels vs plain, which rounds at the same points from the same
# lse: fp32 sums in another order, |kernel - plain| <= BWD_ATOL x the
# largest |plain| of that gradient; bf16 within FLASH_BF16_ULPS ulps of
# the plain value + BWD_BF16_ATOL x the largest |plain| + BWD_BF16_FLIPS
# rounding flips (bwd_flip_scale), with at most BWD_BF16_SHARE of the
# elements differing. The bf16 kernels sum S and dP on the tensor cores,
# whose fp32 sums of the exact products round in another order than the
# plain version's matmuls, and take exp as ex2.approx where the plain
# version takes torch.exp: either can round a ds (before dS.K, dS^T.Q) or
# a p (before P^T.dO) to its other bf16 neighbour, which moves a gradient
# by up to one ulp of that ds or p times |k|, |q| or |dO|. Basis
# (dev/flash_bwd_bf16_limit.py --seeds 4, H100): over phase 3c's bf16
# shapes for 4 seeds and the q, k, v, dO of the 12 layers of one bf16
# BERT-Base fine-tuning step, the kernels exceed 2 ulps + atol on at most
# 3 dv elements a case (up to 1.30x that limit, on the step's own
# activations), by at most 0.23 of one flip; the share is at most 0.56%.
# One flip leaves them 4x room. The three faulty controls (ds left
# unrounded before dS.K or dS^T.Q, p before P^T.dO) must fail the limit:
# they differ on about 40% of the elements.
BWD_ATOL = 2e-5
BWD_BF16_ATOL = 1e-3
BWD_BF16_SHARE = 2e-2
BWD_BF16_FLIPS = 1
# phase 3c: (name, sq, sk, causal, packed, with_glse, d) at b 32, h 12
BWD_SHAPES = [("bert_train", TRAIN_LEN, TRAIN_LEN, False, True, False, 64),
              ("bert_serving", BERT_LEN, BERT_LEN, False, True, False, 64),
              ("causal", BERT_LEN, BERT_LEN, True, False, False, 64),
              ("ragged", 500, 500, False, False, False, 64),
              ("causal_cross", 128, BERT_LEN, True, False, False, 64),
              ("no_key_rows", 96, 40, True, False, False, 64),
              ("bert_train_glse", TRAIN_LEN, TRAIN_LEN, False, True, True,
               64),
              ("head_dim_128", BERT_LEN, BERT_LEN, False, False, False, 128),
              ("head_dim_40", 500, 500, True, False, True, 40)]
# one training step, flash kernels vs the einsum chain under autograd,
# BERT-Base at 32 x 128, dropout off: the loss within TRAIN_LOSS_ATOL and
# every gradient within TRAIN_GRAD_RTOL of its largest element (fp32, TF32
# off) or TRAIN_BF16_GRAD_RTOL (bf16, each against its own chain), from
# the CPU estimate at 2 and 4 blocks (dev/estimate_bert_train_limits.py)
# (fp32: loss equal, gradients within 2.4e-6; bf16: loss within 7.1e-4,
# gradients within 0.028, growing with depth)
TRAIN_LOSS_ATOL = 1e-5
TRAIN_BF16_LOSS_ATOL = 1e-2
TRAIN_GRAD_RTOL = 1e-4
TRAIN_BF16_GRAD_RTOL = 0.25
# decode: bench.py's measure_decode configuration
DECODE = dict(input_dim=8, output_dim=8, hidden_size=64, rnn_type="gru",
              encoder_seq_len=8, decoder_seq_len=4)
DECODE_BATCH = 8
DECODE_STEPS = 32
DECODE_STREAMS = 4
DECODE_SPEC_K = 4
PAGE_SIZE = 8
GEN_BURST = 32
GEN_SINGLE = 10
# raw generation feeds each output back for 32 steps; cuBLAS and the CPU
# sum the GRU's products in other orders
DECODE_RAW_ATOL = 1e-4
# paged decode attention vs its plain version: the limit JAX holds its
# Pallas kernel to (tests/test_paged_attention.py), online vs two-pass
# softmax in fp32
PAGED_RTOL = 2e-5
PAGED_ATOL = 2e-6
# NCF training: bench.py's measure_ncf (bench.py:25-29, 65-82), uncut:
# 400 000 rows of 1-based ids from numpy default_rng(0), label (u + i) % 5,
# batch 8000 (50 steps an epoch), Adam(1e-3), fp32
NCF_TRAIN_ROWS = 400_000
NCF_LR = 1e-3
NCF_STEPS = NCF_TRAIN_ROWS // BATCH
# the item-history column: the Friesian pipeline's add_hist_seq(max_len=8)
# and mask_pad(seq_len=8) (bench.py:1618, 1643-1650): pad id 0
HIST_LEN = 8
# the bag kernel's wide case: (batch, bag, dim, vocab)
WIDE_BAG = (4096, 64, 128, 100_000)
# the lookup's wide case: (batch, tables, vocab, dim)
WIDE_LOOKUP = (65_536, 8, 100_000, 64)
# calls of the lookups captured in one CUDA graph for their device time
REPLAYED = 20
# phase 10(a): one Adam step on the card against the same step on the CPU,
# from the same weights and batch: the loss within NCF_STEP_LOSS_ATOL and
# every parameter within NCF_STEP_PARAM_ATOL. The CPU estimate of a step
# whose sums run in another order (the batch reversed,
# dev/estimate_ncf_train_limits.py): loss 1.2e-7 apart, parameters 1.2e-7
# (NCF) and 4.5e-7 (with the history column)
NCF_STEP_LOSS_ATOL = 1e-5
NCF_STEP_PARAM_ATOL = 1e-5
# phase 11: checkpoints. (a) fits CKPT_EPOCHS epochs of CKPT_EPOCH_STEPS
# steps with a snapshot every CKPT_EVERY steps; CKPT_FAULT fails a step
# past the third snapshot
CKPT_EPOCH_STEPS = 12
CKPT_EPOCHS = 2
CKPT_EVERY = 5
CKPT_FAULT = "wedge@step:18"
CKPT_RESUMED_FROM = 15
# where phase 11 writes (inside the checkout, removed after)
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "phase11")
# the checkpoints the JAX package wrote (dev/make_jax_checkpoints.py)
JAX_CKPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "data", "jax_checkpoints")
# (c): the card against JAX's CPU predictions, fp32 sums in other orders
# (the NCF parity tests' limit)
CKPT_JAX_ATOL = 1e-5
# (e): write and read once each (3 times, the median kept, until phase 25
# joined the run)
CKPT_IO_REPS = 1
# phase 12: the keras training surface and the zoo models. (a) is bench.py's
# measure_widedeep_train (WND_DIMS, batch 1024, Adam, sparse CE, 2
# classes; its data from numpy seed 4), its one batch tiled for the fit's
# WND_STEPS steps as bench.py steps one batch
WND_DIMS = dict(wide_base=(16, 100), wide_cross=(1000,), indicator=(9, 6),
                embed_in=(16, 1000), embed_out=(8, 64), n_continuous=2)
WND_BATCH = 1024
WND_STEPS = 50
WND_SUMMARY_EVERY = 10
# each model's step time as bench.py's _measure_step_time takes it: the
# batch on the card once, STEP_WARMUP steps, then STEP_WINDOW steps on the
# host clock between two syncs (the window as long as NCF's fit, phase 10)
STEP_WARMUP = 2
STEP_WINDOW = 50
# one Adam step card against CPU (loss, every parameter) and predict: the
# NCF step's limit (phase 10(a))
WND_ATOL = 1e-5
# (b) SessionRecommender at MovieLens-1M's item width, bench.py's
# RECSYS_SEQ session length, with an 8-item history; (c) AnomalyDetector's
# default layers over windows of AD_WINDOW; (d) bench.py's measure_decode
# Seq2Seq (DECODE); (e) a regularized Sequential
SR = dict(item_count=3706, item_embed=20, rnn_hidden_layers=(40, 20),
          session_length=8, include_history=True, mlp_hidden_layers=(40, 20),
          history_length=8)
ZOO_BATCH = 1024
ZOO_FIT_STEPS = 4
SR_TOPK = 5
SR_ROWS_RECOMMENDED = 256
AD_WINDOW = 24
AD_ANOMALIES = (100, 1700, 3300)
S2S_BATCH = 256
REG_WIDTHS = (256, 128, 10)
# (b)-(e) card against CPU: the CPU tests' limits
# (tests/test_torch_{zoo_models,recurrent_train,keras_surface}.py): the
# loss within rtol ZOO_LOSS_RTOL; after one Adam step every parameter
# within ZOO_PARAM_ATOL in all but ZOO_PARAM_SHARE of each leaf and
# within 2 lr everywhere; predictions within ZOO_PRED_ATOL
ZOO_LOSS_RTOL = 1e-5
ZOO_PARAM_ATOL = 1e-5
ZOO_PARAM_SHARE = 1e-2
ZOO_PRED_ATOL = 1e-5
ZOO_LR = 1e-3
# every model of phase 12: one batch's gradients on the card against the
# CPU's from the same weights, each leaf within ZOO_GRAD_RTOL of its
# largest |gradient| (Adam's first step shows only each gradient's sign).
# Measured on the H100: 1.46e-6 at worst (SessionRecommender's second
# GRU, back-propagated through 8 steps of batch 1024, sums in cuBLAS's
# order), 5.3e-7 or less in every other model; a gradient scaled or with
# elements flipped is off by its whole size
ZOO_GRAD_RTOL = 5e-6
# where phase 12 writes (inside the checkout, removed after)
ZOO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "phase12")

# phase 13: Zouwu's TCN, bench.py's measure_tcn (batch 256, 96 steps back,
# 8 features, channels (32, 32, 32), kernel 7, dropout 0.2, Adam, mse),
# timed as its _measure_step_time times it
TCN = dict(future_seq_len=1, num_channels=(32, 32, 32), kernel_size=7)
TCN_BATCH, TCN_LOOKBACK, TCN_FEATURES = 256, 96, 8
TCN_WARMUP, TCN_TIMED = 3, 20
# (c): one Adam step on the card against the CPU at dropout 0, from the
# same weights and batch, fp32 with TF32 off. The CPU estimate of a step
# whose sums run in another order (the batch reversed,
# dev/estimate_tcn_train_limits.py): loss 9.5e-7 apart (of 15.3),
# parameters 2.4e-7; the NCF limits hold it with a tenfold margin
TCN_STEP_LOSS_ATOL = 1e-5
TCN_STEP_PARAM_ATOL = 1e-5
# (d): the streaming fit: windows with the CPU tests' linear target, in
# 16 shards under DISK_4 (a window of 4 shards, 2560 rows)
TCN_STREAM_ROWS, TCN_STREAM_SHARDS = 10_240, 16
TCN_STREAM_TIER = "DISK_4"
#: 13(d)'s feed depth: not the default of 1, so that C33's gauge reads
#: this feed's own setting
TCN_STREAM_PREFETCH = 3
TCN_STREAM_EPOCHS = 2
# (e): the CPU tests' small forecasters (tests/test_torch_zouwu.py)
FC_ROWS, FC_LOOKBACK, FC_FEATURES, FC_BATCH, FC_EPOCHS = 96, 16, 3, 16, 2
FC_LR = 1e-2
TCN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "phase13")
# phase 14: the estimator's loop modes at bench.py's measure_ncf
# (STEPS_PER_LOOP = 10 for its "staged" number, cache="device" for its
# "cached" one), timed NCF_LOOP_ROUNDS epochs each in turns; the eight
# optimizers on NCF, each at its JAX wrapper's defaults, OPT_STEPS steps:
# their updates on the card against the same updates on the CPU (the same
# parameters, the card's own gradients) within NCF_STEP_PARAM_ATOL, and
# the whole fit on the card against the fit on the CPU within phase 10's
# limits (NCF_STEP_*_ATOL) for the optimizers whose trajectories do not
# amplify rounding. RMSprop (eps inside the root, lr 1e-2), Adadelta and
# L-BFGS (its curvature pairs) turn the card's other order of summation
# in the GEMMs into differences that grow step by step on this near-flat
# loss (measured on the H100 after 20 steps: 0.050, 1.8e-4 and 0.18 in a
# Dense bias, losses within 1.1e-4, 1.3e-6, 6e-7; reversing each batch's
# rows on the CPU moves L-BFGS by 0.16 too, dev/estimate_optimizer_limits
# .py), while the updates of each agree given the same gradients: their
# fits are held to finite losses within AMPLIFIED_LOSS_ATOL (9x the worst
# measured) and reported. L-BFGS's recursion amplifies within the replay
# too (its 20 updates replayed from the same start: 4.1e-5 on the H100),
# so its replay is held at the last update, taken on the CPU from the
# card's own parameters, memories and gradient before it
NCF_LOOP = 10
NCF_LOOP_ROUNDS = 2
OPT_STEPS = 20
AMPLIFYING = ("rmsprop", "adadelta", "lbfgs")
AMPLIFIED_LOSS_ATOL = 1e-3
OPTIMIZER_ARGS = [("rmsprop", "RMSprop", {}), ("adagrad", "Adagrad", {}),
                  ("adadelta", "Adadelta", {}), ("adamax", "Adamax", {}),
                  ("nadam", "Nadam", {}), ("lars", "LARS", {}),
                  ("lamb", "LAMB", {}), ("lbfgs", "LBFGS", {})]
BERT_SCAN_STEPS = 16
BERT_SWEEP = (32, 64, 128)
# steps timed a batch size and remat setting (5 until slice 26; the peak
# comes in the first)
MEM_STEPS = 3
# CoNLL-2003's BIO tags (O and B-/I- of PER, ORG, LOC, MISC) at 32 x 128;
# SQuAD at google-research/bert run_squad.py's BERT-Base setting, 12 x 384
NER_ENTITIES = 9
NER_BATCH, NER_LEN = 32, 128
SQUAD_BATCH, SQUAD_LEN = 12, 384
TASK_STEPS = 5                  # 10 until slice 26
TASK_CPU_BLOCKS = 2
# one batch's gradients on the card against the CPU, each leaf within its
# task's limit of its largest |gradient| on the CPU: NER at ZOO_GRAD_RTOL
# (measured on the H100: 7.3e-7); SQuAD at SQUAD_GRAD_RTOL: its loss is a
# softmax over the 384 positions, whose gradient sums to zero over them,
# so the gradients of the last block sum near-cancelling terms over 4608
# positions (measured 7.4e-6 at block_1.output.bias, the other leaves
# within 1.8e-6); the qa bias and the last norm's bias, zero in exact
# arithmetic, are held against the model's largest gradient
SQUAD_GRAD_RTOL = 2e-5
PROFILE_STEPS = (2, 5)
PROFILE_LEAD = 2
PHASE14_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase14")
# phase 15: Cluster Serving's scheduling and delivery (ROADMAP A7)
P15_NCF_BATCH = 256             # measure_serving's engine batch
P15_NCF_MAX_BATCH = 1024
P15_LANE_ROUNDS = 128           # 3 batch + 1 interactive records a round
P15_SINGLE = 50
P15_TURNS = 2                   # python, native, python, native
P15_BERT_RUNGS = (8, 32)        # ladder 8, 16, 32
P15_BERT_BURST = 192
P15_COLD_RUNG = 12              # a rung no model of this process has run
P15_BERT_SINGLES = 4
P15_DEADLINE_HELD = 256
P15_DEADLINE_RECORDS = 64
P15_LEASE_RECORDS = 32
P15_LEASE_MS = 200
# generate records the default page pool holds at once (27 at batch 8 and
# the 128-position seq ladder): a record the pool bounces back waits in
# the assembly bucket under the batch lane's max-wait of 0, which makes
# every later read dispatch at once, so no interactive record would wait
# for a decode step to yield to
P15_GEN_RECORDS = 24
P15_GEN_PREDICTS = 32
P15_DRAFT_RECORDS = 16
P15_INTERACTIVE_WAIT_MS = 20    # ZOO_SERVING_MAX_WAIT_MS for interactive
# phase 16: the rest of Cluster Serving (ROADMAP A7b)
P16_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "phase16")
P16_NCF_ROWS = 4096             # bench.py measure_int8_predict's NCF half
P16_CALIB = 256
P16_MIN_ELEMS = 1024
P16_REPS = 10                   # 20 until slice 26
P16_BERT_CALIB = 8              # rows of the 32 x 512 batch
# JAX's int8 limits (tests/test_inference_net.py test_int8_predictions_
# match_fp32): argmax agreement with the float model, nrmse
P16_AGREE = 0.97
P16_NRMSE = 0.1
# the int8 products of a BERT forward: each block's intermediate and
# output, the pooler, the head (26 for BERT-Base); the attention
# projections stay float
# cuBLASLt's int8 GEMM kernels by name (H100, torch 2.11: CUTLASS
# ..._i16832gemm_s8_... and ..._i161616gemm_s8_..., cuBLAS
# sm90_xmma_gemm_i8i32_...)
P16_INT8_KERNEL = r"(?i)(imma|igemm|gemm_s8|gemm_i8|i8i32|s8s8|int8gemm)"
P16_BURST = 512
P16_LEASE_MS = 300
P16_FIT_STEPS = 20
# zoo_step_flops over the hand count of a step's products (ROADMAP C18):
# the rest is the elementwise work and Adam's update. NCF on the CPU at
# batch 8000 (tests/test_torch_profiling.py): 141 353 686 over 132 600 000,
# 1.066; BERT-Base by the per-token count (gelu 71 flops an intermediate
# element, the norms, the scores' softmax, Adam's 13 a parameter) about
# 1.01
P16_FLOPS_MARGIN = {"ncf": 0.08, "bert_bf16": 0.03}
P16_FENCE_ROUNDS = 4
# phase 17: ResNet-50 (ROADMAP A15); bench.py's measure_resnet50_train and
# the ResNet-50 half of measure_int8_predict
P17_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "phase17")
P17_IMAGE = 224
P17_BATCH = 32
P17_CLASSES = 2
P17_WARMUP = 2
P17_TIMED = 10
P17_FIT_STEPS = 4               # a fit under the step profiler
# zoo_step_flops over the hand count of the products (ROADMAP C18): the
# norms (6 flops an element forward, 7 backward), the relus, the residual
# adds, the bf16 casts and Adam's 13 a parameter, about 1% of the products
# (tests/test_torch_profiling.py holds resnet-lite's whole count to JAX's)
P17_FLOPS_MARGIN = 0.03
P17_CHECK_ROWS = 4              # the card-against-CPU step
P17_NORMS = 53                  # ResNet-50's batch norms
# Phase 17(b)'s limits (dev/diagnose_resnet50_step.py on an H100 80GB
# HBM3 at 700 W, 224 px, 4 rows, each route against the same step in
# float64 on the CPU). A random ResNet-50's training step amplifies a
# relative change of its input about 1e5-fold in its gradient even in
# float64 (1e-7 of the input moves the gradient 0.0101 of its norm), so
# fp32's rounding alone leaves the CPU's and the card's gradients 0.0232
# and 0.0231 of the norm from float64, whatever cuDNN's algorithm
# (deterministic and benchmarked choices read the same). The card's path
# is held to 1e-5 and 5e-6 in float64, where the same amplification
# leaves about 1e-11; the fp32 step against float64 at P17_FP32_OVER_CPU
# times the CPU fp32 step's own distance, and on what the step does not
# amplify (loss, logits, the head's gradient: the Dense and the last norm)
# at fixed limits; bf16 against float64 on what its rounding does not
# scramble. Readings in the comments are that run's.
P17_LOSS_ATOL = 1e-5            # float64, card against CPU
P17_GRAD_RTOL = 5e-6            # of each leaf's largest |gradient|
P17_STATS_ATOL = 1e-5           # the running mean and var
P17_PREDICT_RTOL = 1e-5         # eval logits, of their norm (fp32: 1.77e-6)
P17_FP32_OVER_CPU = 1.5         # whole gradient 0.0231 / 0.0232, worst
#                                 leaf 0.139 / 0.164 (card / CPU)
P17_FP32_LOSS_ATOL = 5e-5       # 1.57e-5 (CPU 5.19e-6)
P17_FP32_LOGITS_RTOL = 2e-4     # 5.41e-5 (CPU 3.54e-5)
P17_FP32_HEAD_RTOL = 2e-4       # 2.69e-5 (CPU 2.43e-5)
P17_FP32_STATS_ATOL = 5e-5
P17_FP32_STATS_RTOL = 1e-4
P17_BF16_LOSS_RTOL = 0.3        # 0.0703 of a loss of 0.914
P17_BF16_LOGITS_RTOL = 0.6      # 0.289
P17_BF16_HEAD_RTOL = 0.3        # 0.0643 (0.113 at 16 rows)
P17_BF16_STEM_RTOL = 0.01       # the first convolution's output, 2.87e-3
P17_INT8_CLASSES = 1000         # measure_int8_predict's ResNet-50 half
P17_CALIB = 8
P17_MIN_ELEMS = 1024
P17_REPS = 10
# the products JAX's int8 plan takes in a ResNet-50 forward: every one of
# its 53 convolutions (padding an int or a pair) and the Dense
P17_INT8_PRODUCTS = 54
P17_PROFILE_STEPS = 3
# phase 18: image classification from images to answers (ROADMAP A15's
# remainder, A11's image part, A16's load_checkpoint): 224 px, batch 32
P18_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "phase18")
P18_IMAGE = 224
P18_BATCH = 32
P18_CLASSES = 1000
P18_ROWS = 4                    # (a): the card against the CPU's float64
P18_ARCHS = ("mobilenet", "inception-v1", "mobilenet-v2")
P18_REPS = 10
# (a)'s limits on the eval logits (the Dense's output before the softmax),
# each as the norm of the difference over float64's norm; basis: python3
# dev/estimate_image_limits.py (on the CPU, 224 px, 4 rows, fp32 and bf16
# against float64), its readings in the comments, the limits about 4x
# (bf16) and 7x to 90x (fp32) past them
P18_FP32_RTOL = {"mobilenet": 1e-5,        # CPU: 1.11e-7
                 "inception-v1": 1e-5,     # CPU: 3.06e-7
                 "mobilenet-v2": 1e-5}     # CPU: 1.50e-6
P18_BF16_RTOL = {"mobilenet": 0.02,        # CPU: 4.57e-3
                 "inception-v1": 0.02,     # CPU: 4.68e-3
                 "mobilenet-v2": 0.1}      # CPU: 0.0265
# (b): torchvision-layout twins at 224 (JAX's limit on the probabilities,
# tests/test_migration_image.py, and the same of the logits' largest)
P18_TWINS = ("resnet-50", "mobilenet-v2", "squeezenet", "densenet-121",
             "alexnet", "vgg-16")
P18_TWIN_ROWS = 8
P18_TWIN_ATOL = 1e-4
P18_TWIN_LOGITS_RTOL = 1e-4
P18_TWIN_TIMED = ("resnet-50", "mobilenet-v2")
# (c): dogs-vs-cats-like images (375 x 500 and 500 x 375) through the
# torchvision preset
P18_IMAGES = 64
P18_TOP_K = 5
# (d): the imported ResNet-50 served on the native broker
P18_BURST = 64                  # 128 until slice 26: still two batches
P18_SINGLE = 20
# (e): int8 mobilenet-v2, calibrated on 8 batches; JAX's plan takes every
# Conv (52, the 17 depthwise included) and the Dense
P18_CALIB_BATCHES = 8
P18_CALIB_ROWS = 4
P18_INT8_PRODUCTS = 53
P18_DEPTHWISE = 17
# (f): a 2-step ResNet-50 fit at batch 8 with a checkpoint every step
P18_FIT_ROWS = 16
P18_FIT_BATCH = 8

# phase 19: text from words to answers (ROADMAP A16's rest, A8 and A11's
# text part). The TextClassifier of the reference's text-classification
# app on 20 Newsgroups: the constructor's defaults (20 classes, 500
# tokens, GloVe's 200-d, a 256-wide encoder), the app's max_words_num
# 5000 and batch 128
P19_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "phase19")
P19_TC = dict(class_num=20, token_length=200, sequence_length=500,
              encoder_output_dim=256)
P19_VOCAB = 5000
P19_BATCH = 128
P19_TEXTS = 1000                # (a): texts through the pipeline
P19_WORDS = 20_000              # the seeded word list
P19_TEXT_TOKENS = (50, 500)     # a text's length, uniform
P19_ENCODERS = ("cnn", "lstm", "gru")
P19_WARMUP = 2
P19_TIMED = {"cnn": 5, "lstm": 1, "gru": 1}   # the 500-step loops: fewer
P19_PREDICT_REPS = {"cnn": 20, "lstm": 3, "gru": 3}
P19_CHECK_ROWS = 8              # (b), (d): a step against float64
# (b)'s and (d)'s limits on one training step against the same step in
# float64 on the CPU (dropout off), as (loss, logits, head gradient): the
# loss's absolute difference, the logits' (the last Dense's output before
# its activation) and the head gradient's distance over float64's norm.
# Basis: python3 dev/estimate_text_limits.py (the same step on the CPU,
# 8 rows; its readings in the comments); fp32 (TF32 off) 10x to 50x past
# them, bf16 about 4x. A float64 loss passes through the loss's float32
# cast, so fp32's loss reads 0 on the CPU
P19_FP32_LIMITS = {
    "cnn": (1e-5, 5e-6, 5e-6),       # 0, 4.40e-7, 3.83e-7
    "lstm": (1e-5, 5e-6, 5e-6),      # 0, 1.43e-7, 1.37e-7
    "gru": (1e-5, 5e-6, 5e-6),       # 0, 2.12e-7, 1.43e-7
    # 0, 8.88e-8, 1.65e-7: random 300-d vectors put no cosine within
    # exact_sigma of 1 but the exact matches (1 within rounding), where
    # the exact kernel's slope is nearly 0, so it amplifies nothing here
    "knrm": (1e-5, 5e-6, 1e-5)}
P19_BF16_LIMITS = {
    "cnn": (5e-3, 0.015, 0.02),      # 9.26e-4, 2.93e-3, 3.85e-3
    "lstm": (5e-3, 0.02, 0.025),     # 1.65e-4, 4.54e-3, 5.96e-3
    "gru": (5e-3, 0.025, 0.025)}     # 5.10e-5, 5.79e-3, 5.10e-3
P19_TWIN_ATOL = 1e-6            # (c): the imported cnn against its twin
# KNRM of the reference's QA-ranker app on WikiQA: text1/text2 lengths 10
# and 40, GloVe 840B's 300-d, 21 kernels, sigma 0.1, exact sigma 0.001
# (knrm.py's defaults), batch 200; the vocabulary is this repo's choice
P19_KNRM = dict(text1_length=10, text2_length=40, vocab_size=30_000,
                embed_dim=300, kernel_num=21, sigma=0.1, exact_sigma=0.001)
P19_KNRM_BATCH = 200
P19_KNRM_HEAD_SCALE = 0.02       # the seeded head's kernel, scaled
P19_QUERIES = 16                # (d): ranking metrics over 16 queries
P19_CANDIDATES = 8
P19_GLOVE_DIM = 300             # (e)
# (f): BERT-Base, Uncased in HuggingFace's layout through load_hf_bert
P19_BERT_PREDICT = (32, 512)
P19_BERT_TRAIN = (32, 128)
P19_BERT_STEPS = 2
# (g): the forecasters at bench.py's TCN batch (256 x 96 x 8); predict
# against float64, as the norm of the difference over float64's norm
P19_FC_TIMED = 5
# (the CPU's readings, dev/estimate_text_limits.py: fp32 1.63e-7 and
# 1.89e-7, bf16 5.55e-3 and 5.98e-3 for the LSTM and the Seq2Seq)
P19_FC_RTOL = {"float32": 5e-6, "mixed_bfloat16": 0.025}
P19_NCF_STEPS = 20              # (h)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


def same_bits(a, b) -> bool:
    """Bitwise equality, every NaN counting as one value."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view)[~na], b.view(view)[~nb])


def max_abs_err(a, b) -> float:
    import torch
    ok = ~(torch.isnan(a) | torch.isnan(b))
    if not bool(ok.any()):
        return 0.0
    return float((a.float() - b.float()).abs()[ok].max())


def bf16_reading(got, want, atol: float = FLASH_BF16_ATOL, flip=None,
                 flips: int = FLASH_BF16_FLIPS):
    """(largest |got - want| over its bf16 limit, atol + FLASH_BF16_ULPS
    ulps of want (+ ``flips`` x ``flip``, where given), and the share of
    elements that differ)."""
    g, w = got.float(), want.float()
    limit = atol + FLASH_BF16_ULPS * bf16_ulp(w)
    if flip is not None:
        limit = limit + flips * flip
    ratio = (g - w).abs() / limit
    return float(ratio.max()), float((got != want).float().mean())


def bf16_ulp(x):
    """One bf16 ulp of fp32 ``x``, 0 where x is 0: |x| in [2^(e-1), 2^e)
    has 7 stored bits below."""
    import torch
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x == 0, 0.0, ulp)


def bf16_flip_scale(q, k, v, causal, lse):
    """What one bf16 rounding flip of one p moves each output by, at
    most, as [b, sq, h, d]: 2^-8 (p < 1 has a bf16 ulp of at most 2^-8)
    times max_j |v_j| of the column over the row's sum l, with
    1 / l = exp(m - lse) for the row's largest score m."""
    import math
    import torch
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    rows = []
    for i in range(b):   # one batch row at a time bounds the memory
        s = torch.einsum("qhd,khd->hqk", q[i].float(), k[i].float()) * scale
        if causal:
            qp = torch.arange(sq, device=q.device)[:, None]
            kp = torch.arange(sk, device=q.device)[None, :]
            s = torch.where(kp > qp + (sk - sq), -1e30, s)
        rows.append(s.amax(-1))
    inv_l = torch.exp(torch.stack(rows) - lse.reshape(b, h, sq))
    vmax = v.float().abs().amax(1)                      # [b, h, d]
    return 2.0 ** -8 * inv_l.permute(0, 2, 1)[..., None] * vmax[:, None]


def bf16_within(reading, share: float = FLASH_BF16_SHARE) -> bool:
    return reading[0] <= 1.0 and reading[1] <= share


def truncate_to_bf16(x):
    """fp32 ``x`` rounded toward zero to bf16 (a wrong rounding mode)."""
    import torch
    return (x.view(torch.int32) & -65536).view(torch.float32).to(
        torch.bfloat16)


def bf16_controls(fa, q, k, v, causal, want, flip):
    """Readings of two faulty versions of the bf16 kernel against the
    plain version; each must fail the bf16 limit."""
    import torch
    controls = {
        "p_unrounded": fa._flash_fwd_ref(q.float(), k.float(), v.float(),
                                         causal).to(torch.bfloat16),
        # v stays bf16, so p still rounds; the fp32 output is truncated
        "output_truncated": truncate_to_bf16(
            fa._flash_fwd_ref(q.float(), k.float(), v, causal))}
    return {name: bf16_reading(c, want, flip=flip)
            for name, c in controls.items()}


def lookup_bound(tables, ids, combine):
    """Least time for one fused lookup: bytes it must move (ids read,
    each distinct valid row gathered once, output written) over the
    memory rate, or its fp32 flops over the fp32 rate."""
    import torch
    item = tables[0].element_size()
    batch, n = ids.shape
    moved = ids.numel() * ids.element_size()
    for t, tab in enumerate(tables):
        col = ids[:, t].long()
        vocab = tab.shape[0]
        col = col[(col >= -vocab) & (col < vocab)] % vocab
        moved += torch.unique(col).numel() * tab.shape[1] * item
    d_out = sum(t.shape[1] for t in tables) if combine == "concat" \
        else tables[0].shape[1]
    moved += batch * d_out * item
    flops = 0 if combine == "concat" else \
        batch * d_out * (n - 1 + (combine == "mean"))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def library_call(tables, ids, combine):
    """One-call PyTorch yardstick (timed only, never used by the port)."""
    import torch
    rows = [t.index_select(0, ids[:, i]) for i, t in enumerate(tables)]
    if combine == "concat":
        return torch.cat(rows, dim=1)
    acc = rows[0]
    for r in rows[1:]:
        acc = acc * r if combine == "mul" else acc + r
    return acc / len(rows) if combine == "mean" else acc


def attention_bound(b, sq, sk, h, d, causal, dtype, with_lse):
    """Least time for one attention forward: the q/k/v/o (and lse) bytes
    over the memory rate, or 4*d flops per visible (query, key) pair over
    the rate of the dtype (fp32 CUDA cores, bf16 tensor cores)."""
    import torch
    item = torch.empty((), dtype=dtype).element_size()
    moved = (2 * b * sq + 2 * b * sk) * h * d * item
    moved += 4 * b * h * sq if with_lse else 0
    flops = 4 * b * h * visible_pairs(sq, sk, causal) * d
    return roofline(moved, flops, dtype)


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs that are not masked; bottom-right causal: row i
    sees keys <= i + sk - sq."""
    if not causal:
        return sq * sk
    return sum(min(max(i + sk - sq + 1, 0), sk) for i in range(sq))


def roofline(moved: int, flops: int, dtype):
    """(least ms, "bytes" or "operations"): the bytes over the memory
    rate or the flops over the dtype's rate (fp32 CUDA cores, bf16 tensor
    cores), whichever is larger."""
    import torch
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def attention_bwd_bound(kernel, b, sq, sk, h, d, causal, dtype, with_glse):
    """Least time for one backward kernel: q, k, v, dO, lse, delta (and
    glse) read once and its gradients written once, or its flops per
    visible pair (dq: q.k, dO.v, ds.k = 6d; dk/dv: q.k, dO.v, p.dO, ds.q
    = 8d)."""
    import torch
    item = torch.empty((), dtype=dtype).element_size()
    moved = (2 * b * sq + 2 * b * sk) * h * d * item
    moved += (3 if with_glse else 2) * 4 * b * h * sq
    pairs = visible_pairs(sq, sk, causal) * b * h
    if kernel == "dq":
        moved += b * sq * h * d * item
        flops = 6 * d * pairs
    else:
        moved += 2 * b * sk * h * d * item
        flops = 8 * d * pairs
    return roofline(moved, flops, dtype)


def sdpa_call(q, k, v, causal):
    """One-call PyTorch yardstick (timed only, never used by the port):
    scaled_dot_product_attention with the same bottom-right causal mask."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not causal:
        return F.scaled_dot_product_attention(qt, kt, vt)
    if sq == sk:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=causal_lower_right(sq, sk))


def phase_flash(torch, fa):
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    b, h = BERT_BATCH, 12
    # (name, sq, sk, causal, packed, with_lse, d)
    shapes = [("bert_base", BERT_LEN, BERT_LEN, False, True, False, 64),
              ("causal", BERT_LEN, BERT_LEN, True, False, False, 64),
              ("ragged", 500, 500, False, False, False, 64),
              ("causal_cross", 128, BERT_LEN, True, False, False, 64),
              ("bert_base_lse", BERT_LEN, BERT_LEN, False, True, True, 64),
              ("bert_train", TRAIN_LEN, TRAIN_LEN, False, True, True, 64),
              ("head_dim_128", BERT_LEN, BERT_LEN, False, False, False,
               128)]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, sq, sk, causal, packed, with_lse, d in shapes:
            if packed:
                # q, k, v as the packed projection hands them over
                qkv = torch.randn(b, sq, 3, h, d, generator=gen).to(dev,
                                                                    dtype)
                q, k, v = qkv.unbind(2)
            else:
                q = torch.randn(b, sq, h, d, generator=gen).to(dev, dtype)
                k, v = (torch.randn(b, sk, h, d, generator=gen).to(dev, dtype)
                        for _ in range(2))
            if with_lse:
                got, lse = fa.flash_attention_with_lse(q, k, v, causal)
            else:
                got = fa.flash_attention(q, k, v, causal)
            want, want_lse = fa._flash_fwd_ref(q, k, v, causal, True)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            reading = controls = None
            if dtype == torch.float32:
                ok = err <= FLASH_ATOL
                limit = f"atol {FLASH_ATOL}"
            else:
                flip = bf16_flip_scale(q, k, v, causal, want_lse)
                reading = bf16_reading(got, want, flip=flip)
                ok = bf16_within(reading)
                limit = (f"{reading[0]:.3g} of the limit, share "
                         f"{reading[1]:.3g}")
                if name == "bert_base":
                    controls = bf16_controls(fa, q, k, v, causal, want, flip)
                    log(f"  flash bf16 controls (limit, share): {controls}")
            if not (ok and bool(torch.isfinite(got).all())):
                raise AssertionError(f"kernel != plain: flash {name} {dtype}"
                                     f" max_abs_err={err} ({limit})")
            for cname, creading in (controls or {}).items():
                if bf16_within(creading):
                    raise AssertionError(f"bf16 limit passes the faulty "
                                         f"control {cname}: {creading}")
            lse_err = None
            if with_lse:
                lse_err = max_abs_err(lse, want_lse)
                if lse_err > LSE_ATOL:
                    raise AssertionError(f"kernel lse != plain: {name} "
                                         f"{dtype} {lse_err}")
            bound, bound_by = attention_bound(b, sq, sk, h, d, causal, dtype,
                                              with_lse)
            if with_lse:
                kernel = lambda: fa.flash_attention_with_lse(q, k, v, causal)
                plain = lambda: fa._flash_fwd_ref(q, k, v, causal, True)
            else:
                kernel = lambda: fa.flash_attention(q, k, v, causal)
                plain = lambda: fa._flash_fwd_ref(q, k, v, causal)
            rec = dict(case=name, dtype=str(dtype), b=b, sq=sq, sk=sk, h=h,
                       d=d, causal=causal, lse=with_lse, max_abs_err=err,
                       bf16_reading=reading, bf16_controls=controls,
                       lse_err=lse_err,
                       ms=cuda_ms(kernel, iters=20),
                       plain_ms=cuda_ms(plain, iters=20),
                       library_ms=cuda_ms(lambda: sdpa_call(q, k, v, causal),
                                          iters=20),
                       bound_ms=bound, bound_by=bound_by)
            results.append(rec)
            log(f"  flash {name:14s} {str(dtype):15s} sq{sq} sk{sk} "
                f"max_abs_err {err:.3g} ({limit})  kernel "
                f"{rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
                f"library {rec['library_ms']:.4f} ms  bound "
                f"{bound:.4f} ms ({bound_by})")
            del q, k, v, got, want, want_lse
    return results


def graphed_ms(fn, iters: int = 20, per_graph: int = 1) -> float:
    """Mean device time of ``fn`` captured ``per_graph`` times in a CUDA
    graph and replayed back to back, so that host-side cost (the autograd
    engine's) does not enter. A graph's own launch costs about 5 us on the
    host, so a call shorter than that needs ``per_graph`` > 1 to read its
    device time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(graph.replay, iters) / per_graph


def sdpa_bwd_ms(q, k, v, do, causal) -> float:
    """One-call PyTorch yardstick for the whole attention backward (timed
    only, never used by the port): scaled_dot_product_attention's forward
    plus backward, less its forward, on leaves that require grad, each
    timed from a CUDA graph."""
    import torch
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    dot = do.transpose(1, 2)
    fwd = lambda: sdpa_call(*leaves, causal)
    both = lambda: torch.autograd.grad(fwd(), leaves, dot)
    return graphed_ms(both) - graphed_ms(fwd)


def bwd_flip_scale(fa, q, k, v, do, lse, delta, causal, glse=None):
    """What one bf16 rounding flip of one ds (dq, dk) or one p (dv) moves
    each backward output by, at most: (dq, dk, dv) bounds in the
    gradients' shapes, fp32. A ds_ij rounded to its other bf16 neighbour
    moves dq_i by ulp(ds_ij) |k_j| and dk_j by ulp(ds_ij) |q_i|; a p_ij
    moves dv_j by ulp(p_ij) |dO_i|. Each bound is the largest ulp among
    the sum's terms times the largest |k|, |q| or |dO| of the column."""
    import torch
    b, sq, h, d = q.shape
    flips = ([], [], [])
    for i in range(b):   # one batch row at a time bounds the memory
        rows = slice(i * h, (i + 1) * h)
        p, ds, *_ = fa._p_ds(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                             lse[rows], do[i:i + 1], delta[rows], causal,
                             None if glse is None else glse[rows])
        u_ds, u_p = bf16_ulp(ds[0]), bf16_ulp(p[0])     # [h, sq, sk]
        col_max = [t[i].float().abs().amax(0)[:, None]  # [h, 1, d]
                   for t in (k, q, do)]
        flips[0].append(u_ds.amax(2)[..., None] * col_max[0])
        flips[1].append(u_ds.amax(1)[..., None] * col_max[1])
        flips[2].append(u_p.amax(1)[..., None] * col_max[2])
    return tuple(torch.stack(f).permute(0, 2, 1, 3) for f in flips)


def bwd_reading(got, want, dtype, flip=None):
    """fp32: (largest |got - want| over BWD_ATOL x the largest |want|,
    0); bf16: bf16_reading with BWD_BF16_ATOL x the largest |want| and
    BWD_BF16_FLIPS x ``flip`` (bwd_flip_scale). Within the limit when
    bwd_within."""
    import torch
    top = float(want.float().abs().max())
    if dtype == torch.float32:
        err = float((got.float() - want.float()).abs().max())
        return err / (BWD_ATOL * max(top, 1e-30)), 0.0
    return bf16_reading(got, want, BWD_BF16_ATOL * top, flip,
                        BWD_BF16_FLIPS)


def bwd_within(reading) -> bool:
    return bf16_within(reading, BWD_BF16_SHARE)


def bwd_bf16_controls(fa, args, want, flips):
    """Readings of three faulty versions of the bf16 backward kernels
    against the plain version; each must fail the bf16 limit: ds left
    unrounded before dS.K and before dS^T.Q (q, k, v widened, dO kept in
    bf16 so p still rounds), and p left unrounded before P^T.dO (dO
    widened, q kept in bf16 so ds still rounds)."""
    q, k, v, do, *rest = args
    dtype = q.dtype
    wide_qkv = (q.float(), k.float(), v.float(), do, *rest)
    wide_do = (q, k, v, do.float(), *rest)
    return {
        "dq_ds_unrounded": bwd_reading(
            fa._flash_bwd_dq_ref(*wide_qkv).to(dtype), want[0], dtype,
            flips[0]),
        "dk_ds_unrounded": bwd_reading(
            fa._flash_bwd_dkv_ref(*wide_qkv)[0].to(dtype), want[1], dtype,
            flips[1]),
        "dv_p_unrounded": bwd_reading(
            fa._flash_bwd_dkv_ref(*wide_do)[1].to(dtype), want[2], dtype,
            flips[2])}


def phase_flash_bwd(torch, fa):
    """Phase 3c: the dq and dk/dv kernels against their plain versions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    b, h = TRAIN_BATCH, 12
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, sq, sk, causal, packed, with_glse, d in BWD_SHAPES:
            randn = lambda *shape: torch.randn(*shape, generator=gen).to(
                dev, dtype)
            if packed:
                # q, k, v as the packed projection hands them over, and a
                # strided cotangent
                q, k, v = randn(b, sq, 3, h, d).unbind(2)
                do = randn(b, h, sq, d).transpose(1, 2)
            else:
                q, k, v = randn(b, sq, h, d), randn(b, sk, h, d), \
                    randn(b, sk, h, d)
                do = randn(b, sq, h, d)
            glse = torch.randn(b * h, sq, generator=gen).to(dev) \
                if with_glse else None
            o, lse = fa.flash_attention_with_lse(q, k, v, causal)
            delta = fa._row_delta(o, do)
            args = (q, k, v, do, lse, delta, causal, glse)
            got = (fa._flash_bwd_dq_cuda(*args),
                   *fa._flash_bwd_dkv_cuda(*args))
            again = (fa._flash_bwd_dq_cuda(*args),
                     *fa._flash_bwd_dkv_cuda(*args))
            torch.cuda.synchronize()
            want = (fa._flash_bwd_dq_ref(*args), *fa._flash_bwd_dkv_ref(*args))
            flips = bwd_flip_scale(fa, *args) if dtype == torch.bfloat16 \
                else (None,) * 3
            rec = dict(case=name, dtype=str(dtype), b=b, sq=sq, sk=sk, h=h,
                       d=d, causal=causal, glse=with_glse)
            for grad, g1, g2, w, flip in zip(("dq", "dk", "dv"), got, again,
                                             want, flips):
                if not torch.equal(g1, g2):
                    raise AssertionError(f"flash backward {name} {dtype} "
                                         f"{grad}: two launches differ")
                reading = bwd_reading(g1, w, dtype, flip)
                err = max_abs_err(g1, w)
                if not (bwd_within(reading)
                        and bool(torch.isfinite(g1).all())):
                    raise AssertionError(
                        f"kernel != plain: flash backward {name} {dtype} "
                        f"{grad} max_abs_err={err} reading={reading}")
                rec[f"{grad}_max_abs_err"] = err
                rec[f"{grad}_reading"] = reading
            if name == "no_key_rows" and bool(got[0][:, :sq - sk].any()):
                raise AssertionError("rows that see no key got dq != 0")
            if dtype == torch.bfloat16 and name == "bert_train":
                controls = bwd_bf16_controls(fa, args, want, flips)
                log(f"  flash backward bf16 controls (limit, share): "
                    f"{controls}")
                for cname, creading in controls.items():
                    if bwd_within(creading):
                        raise AssertionError(f"bf16 backward limit passes "
                                             f"the faulty control {cname}: "
                                             f"{creading}")
                rec["bf16_controls"] = controls
            for kernel, launch, plain in (
                    ("dq", lambda: fa._flash_bwd_dq_cuda(*args),
                     lambda: fa._flash_bwd_dq_ref(*args)),
                    ("dkv", lambda: fa._flash_bwd_dkv_cuda(*args),
                     lambda: fa._flash_bwd_dkv_ref(*args))):
                bound, bound_by = attention_bwd_bound(
                    kernel, b, sq, sk, h, d, causal, dtype, with_glse)
                rec[f"{kernel}_ms"] = cuda_ms(launch, iters=20)
                rec[f"{kernel}_plain_ms"] = cuda_ms(plain, iters=20)
                rec[f"{kernel}_bound_ms"] = bound
                rec[f"{kernel}_bound_by"] = bound_by
            # SDPA has no answer of ours for rows that see no key
            rec["library_ms"] = None if name == "no_key_rows" else \
                sdpa_bwd_ms(q, k, v, do, causal)
            results.append(rec)
            log(f"  flash bwd {name:15s} {str(dtype):15s} sq{sq} sk{sk} "
                f"max_abs_err dq {rec['dq_max_abs_err']:.3g} dk "
                f"{rec['dk_max_abs_err']:.3g} dv {rec['dv_max_abs_err']:.3g}"
                f"  dq {rec['dq_ms']:.4f} ms (plain {rec['dq_plain_ms']:.4f}"
                f", bound {rec['dq_bound_ms']:.4f} {rec['dq_bound_by']})  "
                f"dk/dv {rec['dkv_ms']:.4f} ms (plain "
                f"{rec['dkv_plain_ms']:.4f}, bound {rec['dkv_bound_ms']:.4f}"
                f" {rec['dkv_bound_by']})  library bwd "
                f"{fmt_ms(rec['library_ms'])} ms")
            del q, k, v, do, o, lse, delta, got, again, want, flips
    return results


def offset_table(torch, table):
    """A contiguous copy of ``table`` whose rows start one element past a
    16-byte boundary (a view into a buffer one element longer), so the
    kernels take their narrowest loads."""
    flat = torch.empty(table.numel() + 1, dtype=table.dtype,
                       device=table.device)
    view = flat[1:].view(table.shape)
    view.copy_(table)
    return view


def keep_cupti() -> None:
    """Keep the profiler's CUPTI attached between traces (kineto's
    TEARDOWN_CUPTI=0) from a process's first trace on: torn down after
    each trace, it can leave the kernels that the process first launches
    between two traces out of every later trace (the paged kernels' card
    tests after the lookups' in one process). Set here, it does not cover
    every order (the lookups' tests after the paged kernels' still lose
    their kernels); exported before the process starts, it does."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")


def one_launch(torch, kernel: str, symbol: str, fn,
               tries: int = 3, then=None) -> dict:
    """``fn``, a public call, run under torch.inference_mode(): exactly one
    launch of ``kernel`` counted (launch_counts, all others 0), and in the
    profiler exactly one launch call (no copy or fill either) and one
    device activity, the kernel named ``symbol``. With ``then`` = (a second
    kernel, its symbol), exactly one launch of each: two launch calls and
    two device activities, one of each name. A trace whose device
    activity the profiler did not deliver is taken again, up to ``tries``
    traces."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.ops import _build
    keep_cupti()
    for attempt in range(1, tries + 1):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            counts = {k: v for k, v in _build.launch_counts().items() if v}
        events = prof.events()
        device = [e.name for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = [e.name for e in events if e.name.startswith(
            ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
             "cuMemcpy", "cuMemset", "cudaGraphLaunch"))]
        rec = dict(counts=counts, device=device, launch_calls=calls,
                   traces=attempt)
        if device:
            break
    want = {kernel: 1}
    symbols = [symbol]
    if then is not None:
        want[then[0]] = 1
        symbols.append(then[1])
    named = all(any(sym in d for sym in symbols) for d in device) \
        and all(any(sym in d for d in device) for sym in symbols)
    if counts != want or len(calls) != len(symbols) \
            or len(device) != len(symbols) or not named:
        raise AssertionError(f"one public {kernel} call under inference "
                             f"mode: {rec}")
    return rec


def single_launches(torch, eb) -> dict:
    """Phase 3's first check, before any kernel is timed or captured in a
    graph: a public lookup (NCF's tables, int32 ids on the card) and a
    public bag (the history column's shape, no lengths) under
    torch.inference_mode() launch one kernel each and nothing else."""
    import numpy as np
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    users, items = NCF["user_count"] + 1, NCF["item_count"] + 1
    tables = [torch.randn(users, NCF["user_embed"], generator=gen).to(dev),
              torch.randn(items, NCF["item_embed"], generator=gen).to(dev)]
    ids = torch.stack([torch.randint(0, users, (BATCH,), generator=gen),
                       torch.randint(0, items, (BATCH,), generator=gen)],
                      1).to(dev, torch.int32)
    _, _, hist = ncf_train_data(np)
    hist_ids = torch.from_numpy(hist[:BATCH]).to(dev)
    recs = {"fused_embedding_lookup": one_launch(
        torch, "fused_embedding_lookup", "fused_concat_kernel",
        lambda: eb.fused_embedding_lookup(tables, ids)),
        "embedding_bag": one_launch(
            torch, "embedding_bag", "bag_kernel",
            lambda: eb.embedding_bag(tables[1], hist_ids, mode="mean"))}
    for name, rec in recs.items():
        log(f"  one public {name} under inference_mode: {rec}")
    return recs


def paged_single_launches(torch, pa) -> dict:
    """Phase 3d's first check, before any kernel is timed or captured in a
    graph: under torch.inference_mode(), with the table and lengths on
    the card, a public gather on the decode slice's pool is one launch, a
    public attention there one (one block reaches the slice's rows in one
    round: the plan does not split them) and one over rows of 64 page
    slots two (split and combine)."""
    from analytics_zoo_tpu_torch.inference.decode_scheduler import (
        default_pool_pages,
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    n_pages = default_pool_pages(DECODE_BATCH, DECODE_STEPS, spec_k=0,
                                 page_size=PAGE_SIZE)
    width = -(-(DECODE_STEPS + 1) // PAGE_SIZE)
    d = DECODE["output_dim"]
    n_sm = pa._sm_count(torch.cuda.current_device())
    pool, _, table, lengths = paged_case(torch, gen, dev, torch.float32,
                                         n_pages, PAGE_SIZE, d, DECODE_BATCH,
                                         width)
    q = torch.randn(DECODE_BATCH, d, generator=gen).to(dev)
    long_width = 64
    lpool, _, ltable, llengths = paged_case(
        torch, gen, dev, torch.float32, DECODE_BATCH * long_width, PAGE_SIZE,
        d, DECODE_BATCH, long_width)
    recs = {"paged_gather": one_launch(
        torch, "paged_gather", "paged_gather_kernel",
        lambda: pa.paged_gather(pool, table, lengths)),
        "paged_attention_one_split": one_launch(
            torch, "paged_attention", "paged_attention_kernel",
            lambda: pa.paged_attention(q, pool, pool, table, lengths)),
        "paged_attention_split": one_launch(
            torch, "paged_attention", "paged_attention_kernel",
            lambda: pa.paged_attention(q, lpool, lpool, ltable, llengths),
            then=("paged_attention_combine",
                  "paged_attention_combine_kernel"))}
    splits = {"paged_attention_one_split": pa._attention_plan(
        DECODE_BATCH, width, PAGE_SIZE, d, False, n_sm)[0],
        "paged_attention_split": pa._attention_plan(
            DECODE_BATCH, long_width, PAGE_SIZE, d, False, n_sm)[0]}
    if splits["paged_attention_split"] < 2 \
            or splits["paged_attention_one_split"] != 1:
        raise AssertionError(f"the split plan at the checks' shapes: "
                             f"{splits}")
    for name, rec in recs.items():
        rec["splits"] = splits.get(name)
        log(f"  one public {name} under inference_mode: {rec}")
    return recs


def binding_floor(torch, eb) -> dict:
    """The binding's own cost: an empty kernel launched through the
    lookups' library, by the same ctypes path and device check, timed as
    the kernels are (CUDA events over back-to-back calls; CUDA-graph
    replay), with the stream read as the wrappers read it
    (``_build.raw_stream``) and through the public
    ``torch.cuda.current_stream`` for comparison."""
    from analytics_zoo_tpu_torch.ops import _build
    lib = eb._lib()
    index = torch.cuda.current_device()

    def launch(stream_of):
        def call():
            eb._check_launch(lib, lib.zoo_empty_launch(index,
                                                       stream_of(index)),
                             "empty")
        return call

    raw = launch(_build.raw_stream)
    public = launch(lambda i: torch.cuda.current_stream(i).cuda_stream)
    rec = dict(ms=cuda_ms(raw, iters=1000),
               device_ms=graphed_ms(raw, per_graph=REPLAYED),
               public_stream_ms=cuda_ms(public, iters=1000))
    log(f"  binding floor (empty kernel through ctypes): "
        f"{rec['ms']:.4f} ms a call, replayed {rec['device_ms']:.4f} ms; "
        f"with torch.cuda.current_stream {rec['public_stream_ms']:.4f} ms")
    return rec


def phase_kernels(torch, eb):
    """Phase 3, the lookup: each case bitwise against the plain version;
    the public call's time (``ms``), the launcher's alone
    (``launch_ms``), the public call replayed from a CUDA graph
    (``device_ms``), the plain version's and the library yardstick's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def tables_of(shapes, dtype):
        return [torch.randn(v, d, generator=gen).to(dev, dtype)
                for v, d in shapes]

    def ids_of(shapes, batch, oob=False):
        # oob: ids over [-2V, 2V), so some are out of range either side
        return torch.stack([torch.randint(-2 * v if oob else 0,
                                          2 * v if oob else v, (batch,),
                                          generator=gen)
                            for v, _ in shapes], 1).to(dev, torch.int32)

    ncf_shapes = [(NCF["user_count"] + 1, NCF["user_embed"]),
                  (NCF["item_count"] + 1, NCF["item_embed"])]
    mixed = [(1000, 8), (2000, 16), (3000, 4)]
    wide_batch, n_wide, wide_vocab, wide_dim = WIDE_LOOKUP
    wide = [(wide_vocab, wide_dim)] * n_wide
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (BATCH, RAGGED):
            for combine in ("concat", "sum", "mean", "mul"):
                cases.append((f"ncf_{combine}", ncf_shapes, combine, dtype,
                              batch, False))
            cases.append(("mixed_concat", mixed, "concat", dtype, batch,
                          False))
        # ids outside [-V, V) give NaN rows, negative ones wrap
        cases.append(("out_of_range_mul", ncf_shapes, "mul", dtype, BATCH,
                      True))
        cases.append(("out_of_range_concat", ncf_shapes, "concat", dtype,
                      BATCH, True))
        # the user table's rows start one element past 16 bytes
        for combine in ("concat", "sum"):
            cases.append((f"misaligned_{combine}", ncf_shapes, combine,
                          dtype, BATCH, False))
        for combine in ("concat", "sum"):
            cases.append((f"wide_{combine}", wide, combine, dtype,
                          wide_batch, False))
    results = []
    for name, shapes, combine, dtype, batch, oob in cases:
        tables = tables_of(shapes, dtype)
        if name.startswith("misaligned"):
            tables[0] = offset_table(torch, tables[0])
        ids = ids_of(shapes, batch, oob)
        got = eb.fused_embedding_lookup(tables, ids, combine)
        want = eb._fused_ref(tables, ids, combine)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"kernel != plain: {name} {dtype} b{batch}"
                                 f" max_abs_err={max_abs_err(got, want)}")
        bound, bound_by = lookup_bound(tables, ids, combine)
        public = lambda: eb.fused_embedding_lookup(tables, ids, combine)
        rec = dict(case=name, combine=combine, dtype=str(dtype),
                   batch=batch, max_abs_err=max_abs_err(got, want),
                   ms=cuda_ms(public),
                   launch_ms=cuda_ms(lambda: eb._fused_cuda(
                       tables, ids, combine)),
                   device_ms=graphed_ms(public, per_graph=REPLAYED),
                   plain_ms=cuda_ms(lambda: eb._fused_ref(
                       tables, ids, combine)),
                   # index_select faults on ids out of range: no yardstick
                   library_ms=None if oob else cuda_ms(
                       lambda: library_call(tables, ids, combine)),
                   bound_ms=bound, bound_by=bound_by)
        results.append(rec)
        log(f"  {name:20s} {str(dtype):15s} b{batch:<5d} bitwise ok  "
            f"public {rec['ms']:.4f} ms  launcher {rec['launch_ms']:.4f} ms"
            f"  device {rec['device_ms']:.4f} ms  plain "
            f"{rec['plain_ms']:.4f} ms  library {fmt_ms(rec['library_ms'])}"
            f" ms  bound {rec['bound_ms']:.5f} ms ({bound_by})")
        del tables, ids, got, want
    return results


def seeded_weights(module, seed: int):
    """The model's parameters drawn from a numpy seed: weights (dense
    kernels, RNN gates) glorot-uniform, tables and biases U(-0.05,
    0.05)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    state = {}
    for key, val in module.state_dict().items():
        shape = tuple(val.shape)
        lim = np.sqrt(6.0 / sum(shape)) if key.endswith(".weight") else 0.05
        state[key] = torch.from_numpy(
            rng.uniform(-lim, lim, shape).astype(np.float32))
    module.load_state_dict(state)


def bert_inputs(rng, n):
    """int32 input_ids over the whole vocab and token_type_ids that switch
    from segment A to B at a random position; no mask."""
    import numpy as np
    ids = rng.randint(0, BERT_VOCAB, (n, BERT_LEN)).astype(np.int32)
    cut = rng.randint(1, BERT_LEN, (n, 1))
    seg = (np.arange(BERT_LEN)[None] >= cut).astype(np.int32)
    return ids, seg


def bert_classifier(state, **config):
    """The 2-class BERT-Base classifier holding ``state`` (None: weights
    drawn from the numpy seed)."""
    from analytics_zoo_tpu_torch.text import BertConfig, init_bert_weights
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    module = _ClassifierModule(BertConfig(**config), BERT_CLASSES)
    if state is None:
        return init_bert_weights(module, SEED)
    module.load_state_dict(state)
    return module


def grad_reading(got, want):
    """(largest relative gradient difference, the parameter it is in),
    over dicts of gradients by parameter name. Each gradient is held
    against its own largest element, but for the attention key biases: a
    key bias shifts every score of a query alike, which softmax ignores,
    so its gradient is zero but for rounding and is held against the
    largest gradient element of the whole model."""
    scale = max(float(g.float().abs().max()) for g in want.values())
    rel = {}
    for name, g in want.items():
        top = scale if name.endswith("attention.key.bias") else \
            float(g.float().abs().max())
        rel[name] = float((got[name].float() - g.float()).abs().max()
                          / max(top, 1e-30))
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def timed_predict(im, x, reps: int):
    """(output, mean host ms per predict of the whole batch)."""
    y = im.predict(x, batch_size=BERT_BATCH)           # warm up
    t0 = time.perf_counter()
    for _ in range(reps):
        im.predict(x, batch_size=BERT_BATCH)
    return y, (time.perf_counter() - t0) / reps * 1e3


def phase_bert(torch, np, InferenceModel, fa, kind):
    """Phase 6. Returns (the fp32 InferenceModel, its predict of the
    batch, the inputs, the report)."""
    x = bert_inputs(np.random.RandomState(SEED), BERT_BATCH)
    base = bert_classifier(None, use_flash=True)
    state = base.state_dict()
    sample = tuple(a[:BERT_CPU_ROWS] for a in x)
    rep = {}

    im = InferenceModel(device="cuda").load_torch(base, sample)
    before = fa.launches.value
    y, rep["predict_ms"] = timed_predict(im, x, reps=5)
    rep["launches_per_predict"] = (fa.launches.value - before) / 6
    if y.shape != (BERT_BATCH, BERT_CLASSES) or not np.isfinite(y).all():
        raise AssertionError(f"bad BERT predict output {y.shape}")
    y_chain = InferenceModel(device="cuda").load_torch(
        bert_classifier(state, use_flash=False), sample).predict(
        x, batch_size=BERT_BATCH)
    rep["max_abs_diff_einsum"] = float(np.abs(y - y_chain).max())
    y_cpu = InferenceModel(device="cpu").load_torch(base, sample).predict(
        sample)
    rep["max_abs_diff_cpu"] = float(np.abs(y[:BERT_CPU_ROWS] - y_cpu).max())
    for what in ("einsum", "cpu"):
        if rep[f"max_abs_diff_{what}"] > BERT_ATOL:
            raise AssertionError(f"BERT fp32 predict vs {what}: "
                                 f"{rep[f'max_abs_diff_{what}']}")
    log(f"BERT-Base classifier fp32 predict {BERT_BATCH}x{BERT_LEN} on "
        f"{kind}: {rep['predict_ms']:.3f} ms/call (host clock), "
        f"{rep['launches_per_predict']:.0f} flash launches per predict; "
        f"max |flash - einsum chain| = {rep['max_abs_diff_einsum']:.3g}, "
        f"max |cuda - cpu| ({BERT_CPU_ROWS} rows) = "
        f"{rep['max_abs_diff_cpu']:.3g} (atol {BERT_ATOL})")

    bf16 = dict(dtype=torch.bfloat16)
    y16, rep["bf16_predict_ms"] = timed_predict(
        InferenceModel(device="cuda").load_torch(
            bert_classifier(state, use_flash=True, **bf16), sample), x,
        reps=5)
    y16_chain = InferenceModel(device="cuda").load_torch(
        bert_classifier(state, use_flash=False, **bf16), sample).predict(
        x, batch_size=BERT_BATCH)
    rep["bf16_max_abs_diff_einsum"] = float(np.abs(y16 - y16_chain).max())
    rep["bf16_max_abs_diff_fp32"] = float(np.abs(y16 - y).max())
    if not np.isfinite(y16).all() or \
            rep["bf16_max_abs_diff_einsum"] > BERT_BF16_ATOL:
        raise AssertionError(f"BERT bf16 flash vs einsum chain: "
                             f"{rep['bf16_max_abs_diff_einsum']}")
    log(f"BERT-Base classifier bf16 predict: {rep['bf16_predict_ms']:.3f} "
        f"ms/call; max |flash - einsum chain| = "
        f"{rep['bf16_max_abs_diff_einsum']:.3g} (atol {BERT_BF16_ATOL}), "
        f"max |bf16 - fp32| = {rep['bf16_max_abs_diff_fp32']:.3g}")
    return im, y, x, rep


def phase_bert_serving(np, im, y, x, fa, serving_api, kind):
    """Phase 7: burst and single requests; every answer equals predict."""
    Broker, ClusterServing, InputQueue, OutputQueue = serving_api
    ids, seg = x
    before = fa.launches.value
    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port, batch_size=BERT_BATCH,
                           max_batch_size=BERT_BATCH,
                           warmup=False) as serving:
        iq = InputQueue(port=broker.port)
        oq = OutputQueue(port=broker.port)
        t0 = time.perf_counter()
        uris = iq.enqueue_batch(
            (f"b{i}", {"input_ids": ids[i % BERT_BATCH],
                       "token_type_ids": seg[i % BERT_BATCH]})
            for i in range(BERT_BURST))
        got = oq.query_many(uris, timeout=300, poll_interval=0.002)
        burst_s = time.perf_counter() - t0
        lat = []
        for i in range(BERT_SINGLE):
            t1 = time.perf_counter()
            uri = iq.enqueue(f"s{i}", input_ids=ids[i % BERT_BATCH],
                             token_type_ids=seg[i % BERT_BATCH])
            got[uri] = oq.query(uri, timeout=60, poll_interval=0.0005)
            lat.append(time.perf_counter() - t1)
        metrics = serving.metrics()
        iq.close()
        oq.close()
    rows = {f"b{i}": i % BERT_BATCH for i in range(BERT_BURST)}
    rows.update({f"s{i}": i % BERT_BATCH for i in range(BERT_SINGLE)})
    worst = 0.0
    for uri, i in rows.items():
        if got.get(uri) is None:
            raise AssertionError(f"no BERT result for {uri}")
        worst = max(worst, float(np.abs(got[uri] - y[i]).max()))
    if worst > BERT_ATOL:
        raise AssertionError(f"served BERT result differs from predict: "
                             f"{worst}")
    served = fa.launches.value - before
    if served <= 0:
        raise AssertionError("BERT serving did not launch flash attention")
    rep = dict(records_per_s=BERT_BURST / burst_s,
               p50_ms=float(np.percentile(lat, 50)) * 1e3,
               max_abs_diff=worst, launches=served, metrics=metrics)
    log(f"BERT serving on {kind}: {BERT_BURST} records in {burst_s:.3f} s "
        f"= {rep['records_per_s']:.2f} records/s (batch {BERT_BATCH}); "
        f"single-request p50 {rep['p50_ms']:.3f} ms over {BERT_SINGLE}; "
        f"max |served - predict| = {worst:.3g}; flash launches while "
        f"serving: {served}; {metrics}")
    return rep


def train_inputs(rng, n):
    """int32 token ids over the whole vocab and 2-class labels; ids
    alone, as bench.py's classifier takes them."""
    ids = rng.randint(0, BERT_VOCAB, (n, TRAIN_LEN)).astype("int32")
    return ids, rng.randint(0, BERT_CLASSES, n).astype("int32")


def step_grads(torch, module, ids, labels):
    """One training step's loss and gradients by parameter name."""
    from analytics_zoo_tpu_torch.learn import losses
    dev = next(module.parameters()).device
    logits = module(torch.from_numpy(ids).to(dev), train=True)
    loss = losses.get("sparse_categorical_crossentropy_logits")(
        torch.from_numpy(labels).to(dev), logits).mean()
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def phase_bert_train_grads(torch, np, state):
    """Phase 8(a): one step with the flash kernels against the einsum
    chain under autograd, dropout off."""
    ids, labels = train_inputs(np.random.RandomState(SEED), TRAIN_BATCH)
    rep = {}
    for label, dtype, loss_atol, rtol in (
            ("fp32", None, TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL),
            ("bf16", torch.bfloat16, TRAIN_BF16_LOSS_ATOL,
             TRAIN_BF16_GRAD_RTOL)):
        cfg = dict(hidden_drop=0.0, attn_drop=0.0, dtype=dtype)
        lf, gf = step_grads(torch, bert_classifier(
            state, use_flash=True, **cfg).cuda(), ids, labels)
        lc, gc = step_grads(torch, bert_classifier(
            state, use_flash=False, **cfg).cuda(), ids, labels)
        rel, worst = grad_reading(gf, gc)
        rep[label] = dict(loss_flash=lf, loss_chain=lc,
                          loss_diff=abs(lf - lc), max_rel_grad_diff=rel,
                          worst_param=worst)
        log(f"BERT-Base train step {TRAIN_BATCH}x{TRAIN_LEN} {label}: loss "
            f"flash {lf:.6f} vs einsum chain {lc:.6f} (atol {loss_atol}); "
            f"largest gradient difference {rel:.3g} of its scale in "
            f"{worst} (limit {rtol})")
        if not (np.isfinite(lf) and abs(lf - lc) <= loss_atol
                and rel <= rtol):
            raise AssertionError(f"BERT {label} train step, flash vs einsum "
                                 f"chain: {rep[label]}")
        del gf, gc
    return rep


def phase_bert_fit(torch, np, state, Estimator, kind):
    """Phase 8(b): Estimator.from_torch(...).fit, evaluate and predict,
    fp32 and bf16, dropout 0.1; each precision's report holds the
    launches of each kernel in its timed fit."""
    from analytics_zoo_tpu_torch.ops import _build
    ids, labels = train_inputs(np.random.RandomState(SEED + 1),
                               TRAIN_BATCH * TRAIN_STEPS)
    rep = {}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        est = Estimator.from_torch(
            model=bert_classifier(state, use_flash=True, dtype=dtype),
            loss="sparse_categorical_crossentropy_logits", optimizer="adam",
            seed=SEED)
        batch = (ids[:TRAIN_BATCH], labels[:TRAIN_BATCH])
        est.fit(batch, epochs=1, batch_size=TRAIN_BATCH)     # warm up
        torch.cuda.synchronize()
        before = _build.launch_counts()
        t0 = time.perf_counter()
        # the fit's last loss read-back waits for the device
        hist = est.fit((ids, labels), epochs=1, batch_size=TRAIN_BATCH)
        fit_s = time.perf_counter() - t0
        launches = {n: c - before.get(n, 0)
                    for n, c in _build.launch_counts().items()}
        losses = est.step_losses[-TRAIN_STEPS:]
        ev = est.evaluate(batch, batch_size=TRAIN_BATCH)
        pred = est.predict(batch[0], batch_size=TRAIN_BATCH)
        rep[label] = dict(
            step_ms=fit_s / TRAIN_STEPS * 1e3,
            samples_per_s=TRAIN_STEPS * TRAIN_BATCH / fit_s,
            losses=losses, epoch_loss=hist["loss"][0],
            eval_loss=ev["loss"], launches=launches,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"BERT-Base fine-tuning {label} on {kind}: {TRAIN_STEPS} steps "
            f"of {TRAIN_BATCH}x{TRAIN_LEN} at {rep[label]['step_ms']:.3f} "
            f"ms/step (host clock), {rep[label]['samples_per_s']:.2f} "
            f"samples/s; losses {[round(x, 4) for x in losses]}; evaluate "
            f"loss {ev['loss']:.4f}; launches {launches}")
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"BERT {label} fit losses: {losses}")
        if not (np.isfinite(ev["loss"]) and pred.shape == (TRAIN_BATCH,
                                                           BERT_CLASSES)
                and np.isfinite(pred).all()):
            raise AssertionError(f"BERT {label} evaluate/predict: {ev}, "
                                 f"{pred.shape}")
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            if launches.get(name) != 12 * TRAIN_STEPS:
                raise AssertionError(f"BERT {label} fit: {name} launched "
                                     f"{launches.get(name)} times in "
                                     f"{TRAIN_STEPS} steps, not 12 a step")
        del est
    return rep


def gather_bound(pool, table, lengths, out_len):
    """Least time for one paged gather: the live rows (and, for int8,
    their pages' scales) read once, the output written, the table and
    lengths read, over the memory rate; int8 does one multiply per live
    element."""
    import torch
    ps, d = pool.shape[1], pool.shape[2]
    live = lengths.long().clamp(0, out_len)
    moved = int(live.sum()) * d * pool.element_size()
    moved += table.shape[0] * out_len * d * 4 + table.numel() * 4 \
        + lengths.numel() * 4
    flops = 0
    if pool.dtype == torch.int8:
        moved += int(((live + ps - 1) // ps).sum()) * 4
        flops = int(live.sum()) * d
    return roofline(moved, flops, torch.float32)


def paged_attention_bound(q, pool, lengths, width):
    """Least time for one paged decode attention: the live K and V rows
    read once, q read and the output written, over the memory rate, or
    4 * sum(len) * d flops (q.k and w.v) over the fp32 rate."""
    import torch
    ps, d = pool.shape[1], pool.shape[2]
    live = int(lengths.long().clamp(0, width * ps).sum())
    moved = 2 * live * d * pool.element_size() + 2 * q.numel() * 4 \
        + lengths.numel() * 4 + q.shape[0] * width * 4
    return roofline(moved, 4 * live * d, torch.float32)


def paged_case(torch, gen, dev, dtype, n_pages, ps, d, batch, width):
    """A pool of ``dtype`` with per-page scales, a table with entries out
    of range, lengths with 0, a page boundary, mid-page and full."""
    if dtype == torch.int8:
        pool = torch.randint(-127, 128, (n_pages, ps, d), generator=gen,
                             dtype=torch.int32).to(torch.int8)
        scales = torch.rand(n_pages, generator=gen) * 0.045 + 0.005
    else:
        pool = torch.randn(n_pages, ps, d, generator=gen)
        scales = torch.ones(n_pages)
    table = torch.randint(0, n_pages, (batch, width), generator=gen,
                          dtype=torch.int32)
    table[0, 0], table[-1, -1] = -1, n_pages + 5      # clamped
    cap = width * ps
    lengths = torch.randint(0, cap + 1, (batch,), generator=gen,
                            dtype=torch.int32)
    for i, n in enumerate((0, ps, min(ps + ps // 2, cap), cap)):
        if i < batch:
            lengths[i] = n
    return (pool.to(dev), scales.to(dev), table.to(dev), lengths.to(dev))


def dead_pages(table, lengths, ps, n_pages):
    """Pages that no live position of any row reads."""
    live = set()
    for row, n in zip(table.tolist(), lengths.tolist()):
        for p in range(-(-max(n, 0) // ps)):
            live.add(min(max(row[p], 0), n_pages - 1))
    return [p for p in range(n_pages) if p not in live]


def poisoned(torch, pool, dead):
    out = pool.clone()
    if dead:
        out[dead] = 127 if pool.dtype == torch.int8 else float("nan")
    return out


def paged_close(got, want) -> bool:
    return bool(((got - want).abs()
                 <= PAGED_ATOL + PAGED_RTOL * want.abs()).all())


def paged_share(got, want) -> float:
    """The largest share of the PAGED_RTOL / PAGED_ATOL limit that ``got``
    takes from ``want`` (over 1 fails ``paged_close``)."""
    err = (got.double() - want.double()).abs()
    return float((err / (PAGED_ATOL + PAGED_RTOL
                         * want.double().abs())).max())


def two_call_ms(torch, q, kp, vp, table, lengths):
    """For information, not a yardstick (it computes more than the
    kernel: it reads every slot of the table and softmaxes over the dead
    positions' mask): ``pool[table]`` for K and V, then
    ``scaled_dot_product_attention`` with the length mask, each made
    ahead. Event ms of the calls; float32 pools only (int8 would add the
    dequant calls); None for int8."""
    import torch.nn.functional as F
    if kp.dtype != torch.float32:
        return None
    b, d = q.shape
    n_pages, ps, _ = kp.shape
    idx = table.long().clamp(0, n_pages - 1)
    n = idx.shape[1] * ps
    mask = (torch.arange(n, device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, None, None, :]

    def call():
        k = kp[idx].view(b, 1, n, d)
        v = vp[idx].view(b, 1, n, d)
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask)
    return cuda_ms(call)


def kernel_device_ms(torch, fn, symbols, calls: int = 20,
                     tries: int = 3) -> dict:
    """Device ms a launch of each kernel named by (a substring of) one of
    ``symbols`` while ``fn`` runs ``calls`` times, from the profiler's
    kernel records (the mean of those delivered; a record of the call
    made before the trace may arrive in it): the time of a launch that
    follows another in the same call, which events around the call cannot
    part. A trace without a record of each kernel is taken again, up to
    ``tries`` traces."""
    from torch.profiler import ProfilerActivity, profile
    keep_cupti()
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out = {sym: [e.time_range.elapsed_us() for e in device
                     if sym in e.name] for sym in symbols}
        if all(out.values()):
            return {sym: sum(t) / len(t) / 1e3 for sym, t in out.items()}
    raise AssertionError(f"no kernel records of {symbols} in {tries} "
                         f"traces: {[e.name for e in device]}")


def combine_reading(torch, pa, q, kp, vp, table, lengths, kw,
                    splits: int) -> dict:
    """The combine, the attention's second launch where the plan splits
    the rows: its output held to its plain version (``_combine_splits_ref``
    of the partials that the split kernel kept in ``work``) within
    PAGED_RTOL / PAGED_ATOL; the device time a call of the split kernel
    and of the combine from the profiler's trace of the public call; the
    plain version's time; its bound, the partials read and the output
    written over the memory rate."""
    b, d = q.shape
    work = torch.empty((b, splits, d + 2), device=q.device)
    quantized = kp.dtype == torch.int8
    got = pa._attention_cuda(q, kp, vp, table, lengths,
                             kw["k_scales"] if quantized else None,
                             kw["v_scales"] if quantized else None,
                             1.0 / math.sqrt(d), splits=splits, work=work)
    want = pa._combine_splits_ref(work)
    torch.cuda.synchronize()
    if not paged_close(got, want):
        raise AssertionError(f"paged combine != plain: max_abs_err "
                             f"{max_abs_err(got, want)}")
    bound, bound_by = roofline(work.numel() * 4 + got.numel() * 4,
                               3 * work.numel(), torch.float32)
    split_sym, combine_sym = ("paged_attention_kernel",
                              "paged_attention_combine_kernel")
    device = kernel_device_ms(torch, lambda: pa.paged_attention(
        q, kp, vp, table, lengths, **kw), (split_sym, combine_sym))
    return dict(combine_max_abs_err=max_abs_err(got, want),
                combine_limit_share=paged_share(got, want),
                combine_device_ms=device[combine_sym],
                split_device_ms=device[split_sym],
                combine_plain_ms=cuda_ms(lambda: pa._combine_splits_ref(
                    work)),
                combine_bound_ms=bound, combine_bound_by=bound_by)


def phase_paged(torch, pa):
    """Phase 3d: the paged gather (bitwise) and the paged decode attention
    (within PAGED_RTOL / PAGED_ATOL) against their plain versions (the
    attention's in float64; its float32 one, JAX's, is timed). Returns
    the gather's and the attention's cases and the launches of one public
    attention call a case (``public_calls``)."""
    from analytics_zoo_tpu_torch.inference import generation
    from analytics_zoo_tpu_torch.inference.decode_scheduler import (
        default_pool_pages,
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    slice_pages = default_pool_pages(DECODE_BATCH, DECODE_STEPS, spec_k=0,
                                     page_size=PAGE_SIZE)
    rungs = generation.seq_ladder(DECODE_STEPS + 1,
                                  min_rung=PAGE_SIZE).rungs
    serve_pages = default_pool_pages(
        DECODE_BATCH, generation.DEFAULT_SEQ_RUNGS[1], DECODE_SPEC_K,
        PAGE_SIZE)
    serve_width = -(-(generation.DEFAULT_SEQ_RUNGS[1] + DECODE_SPEC_K + 1)
                    // PAGE_SIZE)
    # (name, n_pages, page_size, dim, batch, width, out_len trim)
    gather_shapes = [(f"slice_w{-(-r // PAGE_SIZE)}", slice_pages,
                      PAGE_SIZE, DECODE["output_dim"], DECODE_BATCH,
                      -(-r // PAGE_SIZE), 0) for r in rungs]
    gather_shapes += [("serving", serve_pages, PAGE_SIZE,
                       DECODE["output_dim"], DECODE_BATCH, serve_width, 3),
                      ("wide", 32 * 256, 16, 128, 32, 256, 0)]
    attn_shapes = [("slice", slice_pages, PAGE_SIZE, DECODE["output_dim"],
                    DECODE_BATCH, -(-rungs[-1] // PAGE_SIZE)),
                   ("jax_tests", 7, 4, 8, 4, 2),
                   ("wide", 32 * 256, 16, 128, 32, 256),
                   ("long", 8 * 2048, 16, 128, 8, 2048)]
    gathers, attns = [], []
    public_calls = {"paged_attention": 0, "paged_attention_combine": 0}
    n_sm = pa._sm_count(torch.cuda.current_device())
    for dtype in (torch.float32, torch.int8):
        for name, n_pages, ps, d, batch, width, trim in gather_shapes:
            pool, scales, table, lengths = paged_case(
                torch, gen, dev, dtype, n_pages, ps, d, batch, width)
            out_len = width * ps - trim
            got = pa.paged_gather(pool, table, lengths, scales, out_len)
            want = pa.paged_gather_ref(pool, table, lengths, scales, out_len)
            dead = dead_pages(table, lengths, ps, n_pages)
            again = pa.paged_gather(poisoned(torch, pool, dead), table,
                                    lengths, scales, out_len)
            torch.cuda.synchronize()
            if not (same_bits(got, want) and same_bits(again, want)):
                raise AssertionError(
                    f"paged gather != plain: {name} {dtype} max_abs_err="
                    f"{max_abs_err(got, want)}, poisoned "
                    f"{max_abs_err(again, want)}")
            bound, bound_by = gather_bound(pool, table, lengths, out_len)
            idx = table.long().clamp(0, n_pages - 1)
            rec = dict(case=name, dtype=str(dtype), n_pages=n_pages, ps=ps,
                       d=d, batch=batch, width=width, out_len=out_len,
                       dead_pages=len(dead), max_abs_err=0.0,
                       ms=cuda_ms(lambda: pa.paged_gather(
                           pool, table, lengths, scales, out_len)),
                       plain_ms=cuda_ms(lambda: pa.paged_gather_ref(
                           pool, table, lengths, scales, out_len)),
                       take_ms=cuda_ms(lambda: pool[idx]),
                       device_ms=graphed_ms(lambda: pa.paged_gather(
                           pool, table, lengths, scales, out_len),
                           per_graph=REPLAYED),
                       take_device_ms=graphed_ms(lambda: pool[idx],
                                                 per_graph=REPLAYED),
                       library_ms=None, bound_ms=bound, bound_by=bound_by)
            gathers.append(rec)
            log(f"  paged gather {name:9s} {str(dtype):13s} b{batch} "
                f"w{width} ps{ps} d{d} out_len {out_len}: bitwise ok "
                f"({len(dead)} dead pages poisoned)  kernel "
                f"{rec['ms']:.4f} ms (replayed {rec['device_ms']:.5f})  "
                f"plain {rec['plain_ms']:.4f} ms  pool[table] "
                f"{rec['take_ms']:.4f} ms (replayed "
                f"{rec['take_device_ms']:.5f})  bound {bound:.6f} ms "
                f"({bound_by})")
            del pool, table, got, want, again
        for name, n_pages, ps, d, batch, width in attn_shapes:
            kp, ks, table, lengths = paged_case(
                torch, gen, dev, dtype, n_pages, ps, d, batch, width)
            vp, vs, _, _ = paged_case(torch, gen, dev, dtype, n_pages, ps,
                                      d, batch, width)
            q = torch.randn(batch, d, generator=gen).to(dev)
            kw = dict(k_scales=ks, v_scales=vs)
            got = pa.paged_attention(q, kp, vp, table, lengths, **kw)
            want = pa.paged_attention_ref(q, kp, vp, table, lengths,
                                          dtype=torch.float64, **kw)
            ref32 = pa.paged_attention_ref(q, kp, vp, table, lengths, **kw)
            dead = dead_pages(table, lengths, ps, n_pages)
            again = pa.paged_attention(q, poisoned(torch, kp, dead),
                                       poisoned(torch, vp, dead), table,
                                       lengths, **kw)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            empty = bool(got[lengths == 0].eq(0).all())
            if not (paged_close(got, want) and same_bits(again, got)
                    and empty and bool(torch.isfinite(got).all())):
                raise AssertionError(
                    f"paged attention != plain: {name} {dtype} max_abs_err="
                    f"{err}, poisoned differs {not same_bits(again, got)}, "
                    f"empty rows zero {empty}")
            bound, bound_by = paged_attention_bound(q, kp, lengths, width)
            splits = pa._attention_plan(batch, width, ps, d,
                                        dtype == torch.int8, n_sm)[0]
            before = (pa.attention_launches.value,
                      pa.attention_combine_launches.value)
            pa.paged_attention(q, kp, vp, table, lengths, **kw)
            launched = (pa.attention_launches.value - before[0],
                        pa.attention_combine_launches.value - before[1])
            public_calls["paged_attention"] += launched[0]
            public_calls["paged_attention_combine"] += launched[1]
            per_call = sum(launched)
            if per_call != 1 + (splits > 1):
                raise AssertionError(f"paged attention {name}: {per_call} "
                                     f"launches a call with {splits} splits")
            rec = dict(case=name, dtype=str(dtype), n_pages=n_pages, ps=ps,
                       d=d, batch=batch, width=width, dead_pages=len(dead),
                       max_abs_err=err, splits=splits,
                       launches_per_call=per_call,
                       limit_share=paged_share(got, want),
                       ref32_max_abs_err=max_abs_err(ref32, want),
                       ref32_limit_share=paged_share(ref32, want),
                       ms=cuda_ms(lambda: pa.paged_attention(
                           q, kp, vp, table, lengths, **kw)),
                       device_ms=graphed_ms(lambda: pa.paged_attention(
                           q, kp, vp, table, lengths, **kw),
                           per_graph=REPLAYED),
                       plain_ms=cuda_ms(lambda: pa.paged_attention_ref(
                           q, kp, vp, table, lengths, **kw)),
                       two_call_ms=two_call_ms(torch, q, kp, vp, table,
                                               lengths),
                       library_ms=None, bound_ms=bound, bound_by=bound_by)
            if splits > 1:
                rec.update(combine_reading(torch, pa, q, kp, vp, table,
                                           lengths, kw, splits))
            attns.append(rec)
            log(f"  paged attention {name:9s} {str(dtype):13s} b{batch} "
                f"w{width} ps{ps} d{d}: max_abs_err {err:.3g} from the "
                f"float64 plain, {rec['limit_share']:.3f} of the limit "
                f"(rtol {PAGED_RTOL}, atol {PAGED_ATOL}; the float32 "
                f"plain {rec['ref32_max_abs_err']:.3g}, "
                f"{rec['ref32_limit_share']:.3f}), empty rows zero, "
                f"{len(dead)} dead pages invisible, {splits} splits, "
                f"{per_call} launches  kernel {rec['ms']:.4f} ms (replayed "
                f"{rec['device_ms']:.5f})  plain {rec['plain_ms']:.4f} ms  "
                f"two calls (not a yardstick) {fmt_ms(rec['two_call_ms'])}"
                f"  bound {bound:.6f} ms ({bound_by})"
                + (f"; combine max_abs_err "
                   f"{rec['combine_max_abs_err']:.3g} from plain ("
                   f"{rec['combine_limit_share']:.3f} of the limit), device "
                   f"{rec['combine_device_ms']:.5f} ms a call (split "
                   f"kernel {rec['split_device_ms']:.5f}; profiler), "
                   f"plain {rec['combine_plain_ms']:.4f}, bound "
                   f"{rec['combine_bound_ms']:.6f}" if splits > 1 else ""))
            del kp, vp, table, got, want, again, ref32
    for name in public_calls:
        if public_calls[name] <= 0:
            raise AssertionError(f"phase 3d's public attention calls "
                                 f"launched no {name}: {public_calls}")
    return gathers, attns, public_calls


def counted(torch, fn):
    """(fn's result, the kernel launches it made, its host seconds after
    a device sync)."""
    from analytics_zoo_tpu_torch.ops import _build
    before = _build.launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, {n: c - before.get(n, 0)
                 for n, c in _build.launch_counts().items()}, dt


def phase_decode(torch, np, pa, kind):
    """Phase 9 (a)-(e). Returns (the InferenceModel, its greedy
    generation, the inputs, the report)."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.common.compile_ahead import BucketLadder
    from analytics_zoo_tpu_torch.inference import (InferenceModel,
                                                   decode_scheduler,
                                                   generation)
    from analytics_zoo_tpu_torch.models import Seq2Seq
    b, steps = DECODE_BATCH, DECODE_STEPS
    m = Seq2Seq(**DECODE)
    seeded_weights(m.model.module, SEED)
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((b, 8, DECODE["input_dim"])).astype(np.float32)
    start = np.zeros((b, DECODE["output_dim"]), np.float32)
    n_pool = decode_scheduler.default_pool_pages(b, steps, spec_k=0,
                                                 page_size=PAGE_SIZE)
    rep = {}

    # (a) greedy generate, raw over the rungs vs exact and vs the CPU
    im = InferenceModel(device="cuda").load_zoo(m)
    im.set_ladder(BucketLadder(b, b))
    t0 = time.perf_counter()
    im.warm_decode(steps + 1, paged_pool=(n_pool, PAGE_SIZE))
    rep["warm_decode_s"] = time.perf_counter() - t0
    step = im.decode_step_fn()
    step_times = []

    def timed_step(e, d):
        t1 = time.perf_counter()
        out = step(e, d)
        step_times.append(time.perf_counter() - t1)
        return out

    ladder = generation.seq_ladder(steps + 1)
    generation.decode_loop(timed_step, enc, start, steps, ladder=ladder,
                           mode="greedy")                 # untimed
    step_times.clear()
    greedy, _, dt = counted(torch, lambda: generation.decode_loop(
        timed_step, enc, start, steps, ladder=ladder, mode="greedy"))
    if not np.array_equal(greedy, im.generate(enc, start, steps)):
        raise AssertionError("generate differs from its own decode loop")
    # C32: the cache publishes its live rung; after generate's loop the
    # start token and `steps` positions sit on seq_ladder(steps + 1)
    final_rung = generation.seq_ladder(steps + 1).rung_for(steps + 1)
    rep["kv_cache_rung"] = telemetry.snapshot().get("zoo_kv_cache_rung")
    if rep["kv_cache_rung"] != final_rung:
        raise AssertionError(f"decode (a): zoo_kv_cache_rung reads "
                             f"{rep['kv_cache_rung']}, the cache's final "
                             f"rung is {final_rung}")
    raw = im.generate(enc, start, steps, mode="raw", ladder=ladder)
    raw_exact = generation.decode_loop(step, enc, start, steps, ladder=None,
                                       mode="raw")
    raw_cpu = InferenceModel(device="cpu").load_zoo(m).generate(
        enc, start, steps, mode="raw")
    rep["a"] = dict(tokens_per_s=b * steps / dt,
                    p99_step_ms=float(np.percentile(step_times, 99)) * 1e3,
                    p50_step_ms=float(np.percentile(step_times, 50)) * 1e3,
                    raw_max_abs_diff_cpu=float(np.abs(raw - raw_cpu).max()),
                    greedy_one_hot=bool((greedy.sum(-1) == 1).all()))
    if not np.array_equal(raw, raw_exact):
        raise AssertionError("raw generate over the rungs differs from the "
                             "exact-length loop")
    if not (np.isfinite(raw).all() and rep["a"]["greedy_one_hot"]
            and rep["a"]["raw_max_abs_diff_cpu"] <= DECODE_RAW_ATOL):
        raise AssertionError(f"decode (a): {rep['a']}")
    log(f"decode (a) greedy generate {b} x {steps} on {kind}: "
        f"{rep['a']['tokens_per_s']:.1f} tokens/s, step p50 "
        f"{rep['a']['p50_step_ms']:.3f} / p99 {rep['a']['p99_step_ms']:.3f} "
        f"ms (host clock); raw over the rungs bitwise exact-length, max "
        f"|cuda - cpu| {rep['a']['raw_max_abs_diff_cpu']:.3g} (atol "
        f"{DECODE_RAW_ATOL}); warm_decode {rep['warm_decode_s']:.2f} s; "
        f"zoo_kv_cache_rung {rep['kv_cache_rung']} after generate")

    # (b) streams through one scheduler, interleaved vs one at a time
    def run_streams(interleaved):
        sched = decode_scheduler.DecodeScheduler(
            step, max_batch=b, max_seq=steps, spec_k=0,
            batch_ladder=BucketLadder(b, b))
        seqs = []
        for i in range(DECODE_STREAMS):
            seqs.append(sched.admit(enc[i], start[i], steps, mode="greedy"))
            if not interleaved:
                sched.drain()
        sched.drain()
        return seqs

    run_streams(True)                                      # untimed
    serial, _, dt_serial = counted(torch, lambda: run_streams(False))
    inter, _, dt_conc = counted(torch, lambda: run_streams(True))
    for i in range(DECODE_STREAMS):
        if not (np.array_equal(serial[i].result, greedy[i])
                and np.array_equal(inter[i].result, greedy[i])):
            raise AssertionError(f"decode (b) stream {i} differs from (a)")
    rep["b"] = dict(concurrent_tokens_per_s=DECODE_STREAMS * steps / dt_conc,
                    single_stream_tokens_per_s=DECODE_STREAMS * steps
                    / dt_serial, concurrent_speedup=dt_serial / dt_conc)
    log(f"decode (b) {DECODE_STREAMS} streams: interleaved "
        f"{rep['b']['concurrent_tokens_per_s']:.1f} tokens/s, one at a time "
        f"{rep['b']['single_stream_tokens_per_s']:.1f}, speedup "
        f"{rep['b']['concurrent_speedup']:.3f}; bitwise (a)")

    # (c) self-drafted speculative decoding
    p0, a0 = decode_scheduler.spec_totals()
    spec, _, dt_spec = counted(torch, lambda: im.generate(
        enc, start, steps, draft=im, spec_k=DECODE_SPEC_K))
    p1, a1 = decode_scheduler.spec_totals()
    proposed, accepted = p1 - p0, a1 - a0
    if not np.array_equal(spec, greedy) or proposed <= 0:
        raise AssertionError(f"decode (c): speculative differs from (a) or "
                             f"proposed nothing ({proposed})")
    rep["c"] = dict(accept_ratio=accepted / proposed, proposed=proposed,
                    tokens_per_s=b * steps / dt_spec)
    log(f"decode (c) speculative (spec_k {DECODE_SPEC_K}, self-drafted): "
        f"bitwise (a), accept ratio {rep['c']['accept_ratio']:.3f} of "
        f"{proposed}, {rep['c']['tokens_per_s']:.1f} tokens/s")

    # (d) paged force vs off, fp32 and int8; (e) attention on the live pool
    paged_fn = im.paged_decode_step_fn()

    def run_paged(paged, probe=False):
        sched = decode_scheduler.DecodeScheduler(
            step, max_batch=b, max_seq=steps, spec_k=0,
            batch_ladder=BucketLadder(b, b), paged_step_fn=paged_fn,
            paged=paged)
        seqs = [sched.admit(enc[i], start[i], steps, mode="greedy")
                for i in range(DECODE_STREAMS)]
        att = None
        if probe:
            for _ in range(steps // 2):
                sched.step()
            pool, scales, table, lengths = sched.live_state()
            pool_t = torch.from_numpy(pool).cuda()
            q = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
                (len(lengths), DECODE["output_dim"])).astype(
                    np.float32)).cuda()
            kw = dict(k_scales=scales, v_scales=scales)
            got = pa.paged_attention(q, pool_t, pool_t, table, lengths, **kw)
            want = pa.paged_attention_ref(q, pool_t, pool_t, table, lengths,
                                          dtype=torch.float64, **kw)
            torch.cuda.synchronize()
            att = dict(max_abs_err=max_abs_err(got, want),
                       close=paged_close(got, want), lengths=lengths.tolist(),
                       width=int(table.shape[1]))
        sched.drain()
        return sched, seqs, att

    rep["d"] = {}
    prev_kv = os.environ.get("ZOO_KV_DTYPE")
    for kv in ("float32", "int8"):
        os.environ["ZOO_KV_DTYPE"] = kv
        try:
            run_paged("force")                               # untimed
            (sched, pseqs, _), launches, dt_paged = counted(
                torch, lambda: run_paged("force"))
            _, oseqs, _ = run_paged("off")
            _, _, att = run_paged("force", probe=True)
        finally:
            os.environ.pop("ZOO_KV_DTYPE")
            if prev_kv is not None:
                os.environ["ZOO_KV_DTYPE"] = prev_kv
        for i in range(DECODE_STREAMS):
            if not (np.array_equal(pseqs[i].result, greedy[i])
                    and np.array_equal(oseqs[i].result, greedy[i])):
                raise AssertionError(f"decode (d) {kv} stream {i}: paged or "
                                     f"off differs from (a)")
        if not att["close"]:
            raise AssertionError(f"decode (e) {kv}: paged attention on the "
                                 f"live pool != plain: {att}")
        alloc = sched.allocator
        top = generation.seq_ladder(steps + 1, min_rung=PAGE_SIZE).rung_for(
            steps + 1)
        tune = sched.tune_paged(batch_rung=b, seq_rung=top,
                                enc_shape=enc[0].shape)
        rep["d"][kv] = dict(
            tokens_per_s=DECODE_STREAMS * steps / dt_paged,
            paged_steps=sched.paged_steps, launches=launches,
            kv_bytes_per_seq=alloc.pages_for(1 + steps) * alloc.page_nbytes,
            tune_paged=tune, live_attention=att)
        log(f"decode (d) paged {kv}: force bitwise off and (a), "
            f"{rep['d'][kv]['tokens_per_s']:.1f} tokens/s, "
            f"{sched.paged_steps} paged steps, gather launches "
            f"{launches.get('paged_gather')}; tune_paged speedup "
            f"{tune['speedup']:.3f} (paged {tune['best_ms']:.3f} ms vs "
            f"gather {tune['reference_ms']:.3f} ms); KV bytes per sequence "
            f"{rep['d'][kv]['kv_bytes_per_seq']}; (e) live-pool attention "
            f"max_abs_err {att['max_abs_err']:.3g}")
    return im, greedy, (enc, start), rep


def phase_decode_serving(np, im, greedy, inputs, serving_api, kind):
    """Phase 9 (f): generate records through the broker and
    ClusterServing; every answer equals greedy generate of its row."""
    from analytics_zoo_tpu_torch.ops import autotune
    from analytics_zoo_tpu_torch.ops import paged_attention as pa
    Broker, ClusterServing, InputQueue, OutputQueue = serving_api
    enc, start = inputs
    gen = {"max_new_tokens": DECODE_STEPS}
    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port, batch_size=DECODE_BATCH,
                           max_batch_size=DECODE_BATCH,
                           warmup=False) as serving, autotune_mode("on"):
        # the engine's scheduler takes paged="auto": its verdicts first
        verdicts = build_step_verdicts(serving._ensure_scheduler(),
                                       enc[0].shape, DECODE["output_dim"],
                                       DECODE_STEPS)
        gathers0 = pa.gather_launches.value
        iq = InputQueue(port=broker.port)
        oq = OutputQueue(port=broker.port)
        t0 = time.perf_counter()
        uris = iq.enqueue_batch(
            ((f"g{i}", {"x": enc[i % DECODE_BATCH],
                        "start": start[i % DECODE_BATCH]})
             for i in range(GEN_BURST)), generate=gen)
        got = oq.query_many(uris, timeout=300, poll_interval=0.002)
        burst_s = time.perf_counter() - t0
        lat = []
        for i in range(GEN_SINGLE):
            t1 = time.perf_counter()
            uri = iq.enqueue(f"s{i}", generate=gen,
                             x=enc[i % DECODE_BATCH],
                             start=start[i % DECODE_BATCH])
            got[uri] = oq.query(uri, timeout=60, poll_interval=0.0005)
            lat.append(time.perf_counter() - t1)
        metrics = serving.metrics()
        sched = serving._decode_sched
        gather_steps = sched.paged_fallbacks
        gathers = pa.gather_launches.value - gathers0
        # the engine's paged route runs on every run, whatever the verdicts
        # picked: one more burst with its scheduler at paged="force"
        sched._paged = "force"
        paged0, gathers0 = sched.paged_steps, pa.gather_launches.value
        got.update(oq.query_many(iq.enqueue_batch(
            ((f"f{i}", {"x": enc[i], "start": start[i]})
             for i in range(DECODE_BATCH)), generate=gen),
            timeout=300, poll_interval=0.002))
        forced = dict(paged_steps=sched.paged_steps - paged0,
                      gather_launches=pa.gather_launches.value - gathers0)
        sched._paged = "auto"
        iq.close()
        oq.close()
    rows = {f"g{i}": i % DECODE_BATCH for i in range(GEN_BURST)}
    rows.update({f"s{i}": i % DECODE_BATCH for i in range(GEN_SINGLE)})
    rows.update({f"f{i}": i for i in range(DECODE_BATCH)})
    for uri, i in rows.items():
        if got.get(uri) is None or not np.array_equal(got[uri], greedy[i]):
            raise AssertionError(f"served generation {uri} differs from "
                                 f"greedy generate of row {i}")
    if autotune.pending_count():
        raise AssertionError(f"decode (f): a step shape had no verdict: "
                             f"{autotune.pending_count()} queued")
    rep = dict(records_per_s=GEN_BURST / burst_s,
               tokens_per_s=GEN_BURST * DECODE_STEPS / burst_s,
               single_p50_ms=float(np.percentile(lat, 50)) * 1e3,
               metrics=metrics, step_verdicts=verdicts,
               gather_steps=gather_steps, gather_launches=gathers,
               forced=forced)
    log(f"decode (f) serving on {kind}: {GEN_BURST} generate records of "
        f"{DECODE_STEPS} tokens in {burst_s:.3f} s = "
        f"{rep['records_per_s']:.2f} records/s, {rep['tokens_per_s']:.1f} "
        f"tokens/s (engine batch {DECODE_BATCH}); single-request p50 "
        f"{rep['single_p50_ms']:.3f} ms over {GEN_SINGLE}; every answer "
        f"bitwise greedy generate; paged='auto' by the step verdicts "
        f"{verdicts}: {metrics['paged_steps']} paged steps, {gather_steps} "
        f"host-gather steps; then {DECODE_BATCH} records at paged='force': "
        f"{forced['paged_steps']} paged steps, {forced['gather_launches']} "
        f"gathers; {metrics}")
    return rep


def bag_bound(table, ids, lengths, mean):
    """Least time for one bag: the live slots' ids and the lengths read,
    each distinct live row gathered once, the output written; or its fp32
    flops (one add per live slot and column, a divide per output for
    mean)."""
    import torch
    item = table.element_size()
    batch, bag = ids.shape
    dim = table.shape[1]
    live = torch.arange(bag, device=ids.device)[None, :] < lengths[:, None]
    n_live = int(live.sum())
    distinct = torch.unique(ids[live]).numel()
    moved = n_live * 4 + batch * 4 + (distinct + batch) * dim * item
    flops = n_live * dim + (batch * dim if mean else 0)
    return roofline(moved, flops, torch.float32)


def bag_library_call(torch, table, ids, lengths, mode):
    """One-call PyTorch yardstick (timed only, never used by the port):
    ``F.embedding_bag`` on the bag's own inputs. Without lengths (every
    slot live) that is the ``[batch, bag]`` id matrix as it is; with
    lengths, the live slots flattened and offsets from the lengths, both
    made before the timed call."""
    import torch.nn.functional as F
    if lengths is None:
        return lambda: F.embedding_bag(ids, table, mode=mode)
    bag = ids.shape[1]
    live = torch.arange(bag, device=ids.device)[None, :] < lengths[:, None]
    flat = ids[live].long()
    counts = torch.clamp(lengths.long(), 0, bag)
    offsets = torch.cumsum(counts, 0) - counts
    return lambda: F.embedding_bag(flat, table, offsets, mode=mode)


def scatter_bound(torch, keys, vocab, g_rows, dim, item, extra_reads=0,
                  extra_flops=0):
    """Least time for one scatter launch: the sorted keys (4 bytes) and
    the permutation (8) of every position read, ``g_rows`` gradient rows
    read, ``extra_reads`` bytes (the other tables' rows, the lengths),
    each touched row written once; or one fp32 add per kept position and
    column plus ``extra_flops``."""
    kept = keys[keys < vocab]
    moved = keys.numel() * 12 + extra_reads + (
        g_rows + int(torch.unique(kept).numel())) * dim * item
    return roofline(moved, kept.numel() * dim + extra_flops, torch.float32)


def ncf_train_data(np):
    """bench.py's NCF training rows (build_ncf) and, drawn on from the
    same generator, an item history per row: a length in [1, HIST_LEN],
    item ids in [1, items], pad id 0 after the length."""
    users, items = NCF["user_count"], NCF["item_count"]
    rng = np.random.default_rng(SEED)
    u = rng.integers(1, users + 1, NCF_TRAIN_ROWS)
    i = rng.integers(1, items + 1, NCF_TRAIN_ROWS)
    x = np.stack([u, i], 1).astype(np.float32)
    y = ((u + i) % NCF["class_num"]).astype(np.int32)
    lengths = rng.integers(1, HIST_LEN + 1, NCF_TRAIN_ROWS)
    ids = rng.integers(1, items + 1, (NCF_TRAIN_ROWS, HIST_LEN))
    hist = np.where(np.arange(HIST_LEN)[None, :] < lengths[:, None], ids,
                    0).astype(np.int32)
    return x, y, hist


def hist_graph():
    """Configuration 2: NeuralCF at MovieLens-1M width with a pooled
    item-history column, ``Embedding(items + 1, 20, pooling="mean")`` over
    HIST_LEN ids, concatenated with the MLP tower's embeddings; built from
    the port's keras layers as the JAX package's layers build it."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as zl
    users, items = NCF["user_count"], NCF["item_count"]
    ui = Input(shape=(2,))
    hist = Input(shape=(HIST_LEN,))
    mlp = zl.FusedEmbeddings(
        [("mlp_user_embed", users + 1, NCF["user_embed"]),
         ("mlp_item_embed", items + 1, NCF["item_embed"])],
        combine="concat", init="uniform", name="mlp_embed_bag")(ui)
    pooled = zl.Embedding(items + 1, NCF["item_embed"], init="uniform",
                          pooling="mean", name="hist_embed")(hist)
    linear = zl.merge([mlp, pooled], mode="concat")
    for units in NCF["hidden_layers"]:
        linear = zl.Dense(units, activation="relu")(linear)
    mf = zl.FusedEmbeddings(
        [("mf_user_embed", users + 1, NCF["mf_embed"]),
         ("mf_item_embed", items + 1, NCF["mf_embed"])],
        combine="mul", init="uniform", name="mf_embed_bag")(ui)
    out = zl.Dense(NCF["class_num"], activation="softmax")(
        zl.merge([linear, mf], mode="concat"))
    return Model(input=[ui, hist], output=out)


def train_model(config: str):
    """A fresh KerasNet of ``config`` ("ncf" or "hist") with weights drawn
    from the numpy seed."""
    from analytics_zoo_tpu_torch.models import NeuralCF
    net = NeuralCF(**NCF).model if config == "ncf" else hist_graph()
    seeded_weights(net.module, SEED)
    return net


def train_inputs_of(config, x, hist, lo, hi):
    return x[lo:hi] if config == "ncf" else [x[lo:hi], hist[lo:hi]]


def phase_bag(torch, eb):
    """Phase 3e: the bag kernel and the scatter kernel against their plain
    versions, bitwise; two scatter launches bit for bit. The bag's times
    as the lookup's (phase 3): public call, launcher, CUDA-graph replay.
    Returns (bag cases, scatter cases)."""
    import numpy as np
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    vocab = NCF["item_count"] + 1
    dim = NCF["item_embed"]
    _, _, hist = ncf_train_data(np)
    slice_ids = torch.from_numpy(hist[:BATCH]).to(dev)
    slice_len = (slice_ids > 0).sum(1).to(torch.int32)
    bags = []
    # (name, batch, bag, dim, vocab, ids, lengths); "draw": drawn here.
    # slice_no_lengths is the history column as the keras layer calls it
    # (no lengths: pad id 0 counted); misaligned's table rows start one
    # element past 16 bytes
    specs = [("slice", BATCH, HIST_LEN, dim, vocab, slice_ids, slice_len),
             ("slice_no_lengths", BATCH, HIST_LEN, dim, vocab, slice_ids,
              None),
             ("ragged_out_of_range", BATCH, HIST_LEN, dim, vocab, "draw",
              "draw"),
             ("misaligned", BATCH, HIST_LEN, dim, vocab, "draw", "draw"),
             ("wide", *WIDE_BAG, "draw", "draw")]
    for name, batch, bag, d, v, ids, lengths in specs:
        if isinstance(ids, str):
            # ids past either end of the table, before and after the
            # length; lengths 0 (empty bags), partial and full
            ids = torch.randint(-10, v + 10, (batch, bag), generator=gen)
            lengths = torch.randint(0, bag + 1, (batch,), generator=gen)
            lengths[:3] = torch.tensor([0, bag, 1])
            ids, lengths = ids.to(dev, torch.int32), lengths.to(dev,
                                                                torch.int32)
        table32 = torch.randn(v, d, generator=gen).to(dev)
        full = torch.full((batch,), bag, dtype=torch.int32, device=dev)
        live = full if lengths is None else lengths
        cids = torch.clamp(ids, 0, v - 1)
        for dtype in (torch.float32, torch.bfloat16):
            table = table32.to(dtype)
            if name == "misaligned":
                table = offset_table(torch, table)
            for mode in ("sum", "mean"):
                mean = mode == "mean"
                got = eb.embedding_bag(table, ids, lengths, mode)
                want = eb._bag_ref(table, cids, live, mean)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    raise AssertionError(
                        f"bag kernel != plain: {name} {mode} {dtype} "
                        f"max_abs_err={max_abs_err(got, want)}")
                bound, bound_by = bag_bound(table, cids, live, mean)
                public = lambda: eb.embedding_bag(table, ids, lengths, mode)
                rec = dict(case=name, mode=mode, dtype=str(dtype),
                           batch=batch, bag=bag, dim=d, vocab=v,
                           max_abs_err=max_abs_err(got, want),
                           ms=cuda_ms(public),
                           launch_ms=cuda_ms(lambda: eb._bag_cuda(
                               table, ids, lengths, mean)),
                           device_ms=graphed_ms(public,
                                                per_graph=REPLAYED),
                           plain_ms=cuda_ms(lambda: eb._bag_ref(
                               table, cids, live, mean), iters=20),
                           library_ms=cuda_ms(bag_library_call(
                               torch, table, cids, lengths, mode)),
                           bound_ms=bound, bound_by=bound_by)
                if lengths is None:
                    # the same sums through the offsets form, its flat ids
                    # and offsets made before the timed call
                    rec["library_offsets_ms"] = cuda_ms(bag_library_call(
                        torch, table, cids, live, mode))
                bags.append(rec)
                log(f"  bag {name:20s} {mode:4s} {str(dtype):15s} bitwise ok"
                    f"  public {rec['ms']:.4f} ms  launcher "
                    f"{rec['launch_ms']:.4f} ms  device "
                    f"{rec['device_ms']:.4f} ms  plain "
                    f"{rec['plain_ms']:.4f} ms  library "
                    f"{rec['library_ms']:.4f} ms  bound "
                    f"{rec['bound_ms']:.5f} ms ({bound_by})")
    return bags, phase_scatter(torch, eb, dev, gen, slice_ids, slice_len)


def _check_scatter(name, got, want, again):
    for a, b, c in zip(got, want, again):
        if not same_bits(a, b):
            raise AssertionError(f"scatter kernel != plain: {name} "
                                 f"max_abs_err={max_abs_err(a, b)}")
        if not same_bits(a, c):
            raise AssertionError(f"two scatter launches differ: {name}")


def phase_scatter(torch, eb, dev, gen, slice_ids, slice_len):
    """Phase 3e, the backward: the scatter kernel for each combine of the
    fused lookup at NCF's tables and batch, and for the bag at the history
    column's shape (sum, mean), fp32 and bf16, plus a batch whose ids are
    all one row; against the plain backward and a second launch."""
    shapes = [(NCF["user_count"] + 1, NCF["user_embed"]),
              (NCF["item_count"] + 1, NCF["item_embed"])]
    recs = []

    def timed(name, dtype, launch, plain, library, bound, err, slow=False):
        rec = dict(case=name, dtype=str(dtype), max_abs_err=err,
                   ms=cuda_ms(launch),
                   plain_ms=cuda_ms(plain, iters=1 if slow else 3,
                                    warmup=0 if slow else 1),
                   library_ms=cuda_ms(library), bound_ms=bound[0],
                   bound_by=bound[1])
        recs.append(rec)
        log(f"  scatter {name:28s} {str(dtype):15s} bitwise, 2 launches "
            f"equal  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f}"
            f" ms  index_add_ {rec['library_ms']:.4f} ms  bound "
            f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")

    for dtype in (torch.float32, torch.bfloat16):
        tables = [torch.randn(v, d, generator=gen).to(dev, dtype)
                  for v, d in shapes]
        cases = [(c, False, False) for c in ("concat", "sum", "mean", "mul")]
        cases += [("mul", True, False), ("concat", True, False),
                  ("concat", False, True)]
        for combine, oob, same in cases:
            ids = torch.stack([torch.randint(
                -2 * v if oob else 1, 2 * v if oob else v, (BATCH,),
                generator=gen) for v, _ in shapes], 1).to(dev, torch.int32)
            if same:
                ids[:] = 7
            name = f"ncf_{combine}" + ("_out_of_range" if oob else "") + (
                "_one_row" if same else "")
            d_out = sum(d for _, d in shapes) if combine == "concat" \
                else shapes[0][1]
            g = torch.randn(BATCH, d_out, generator=gen).to(dev, dtype)
            got = eb._fused_bwd_cuda(tables, ids, g, combine)
            want = eb._fused_bwd_ref(tables, ids, g, combine)
            again = eb._fused_bwd_cuda(tables, ids, g, combine)
            torch.cuda.synchronize()
            _check_scatter(f"{name} {dtype}", got, want, again)
            # timed: the item table's launch alone, keys sorted beforehand
            i = 1
            keys, args, cc, sc = eb._fused_scatter_plan(tables, ids, g,
                                                        combine, i)
            skeys, perm = torch.sort(keys, stable=True)
            out = torch.zeros_like(tables[i])
            upd = eb._fused_updates(tables, ids, g, combine, i)
            kept = keys < shapes[i][0]
            rows, kept_upd = keys[kept].long(), upd[kept]
            other = 0 if combine != "mul" else int(torch.unique(
                ids[:, 0]).numel()) * shapes[0][1] * g.element_size()
            bound = scatter_bound(torch, keys, shapes[i][0], BATCH,
                                  shapes[i][1], g.element_size(), other,
                                  int(kept.sum()) * shapes[i][1] * (
                                      combine in ("mul", "mean")))
            timed(name, dtype,
                  lambda: eb._scatter_launch(out, skeys, perm, g, args, cc,
                                             sc),
                  lambda: eb._scatter_ref(shapes[i][0], keys, upd),
                  lambda: out.index_add_(0, rows, kept_upd), bound,
                  max(max_abs_err(a, b) for a, b in zip(got, want)),
                  slow=same)
        vocab, dim = shapes[1]
        table = torch.randn(vocab, dim, generator=gen).to(dev, dtype)
        # bag_pad_row: the history column as the training path feeds it,
        # no lengths, so pad id 0 takes about 28 000 of the 64 000 updates;
        # bag_one_row: all 64 000 updates into one row
        full = torch.full_like(slice_len, HIST_LEN)
        for name, ids, lengths in (
                ("bag_slice", slice_ids, slice_len),
                ("bag_pad_row", slice_ids, full),
                ("bag_one_row", torch.full_like(slice_ids, 5), full)):
            for mode in ("sum",) if name == "bag_one_row" else ("sum",
                                                                  "mean"):
                mean = mode == "mean"
                cids = ids.to(torch.int32)
                g = torch.randn(BATCH, dim, generator=gen).to(dev, dtype)
                got = eb._bag_bwd_cuda(vocab, dtype, cids, lengths, g, mean)
                want = eb._bag_bwd_ref(vocab, dtype, cids, lengths, g, mean)
                again = eb._bag_bwd_cuda(vocab, dtype, cids, lengths, g,
                                         mean)
                torch.cuda.synchronize()
                _check_scatter(f"{name} {mode} {dtype}", [got],
                               [want], [again])
                gc = g.contiguous()
                keys, args, cc, sc = eb._bag_scatter_plan(vocab, cids,
                                                          lengths, gc, mean)
                skeys, perm = torch.sort(keys, stable=True)
                out = torch.zeros_like(table)
                upd = eb._bag_updates(gc, lengths, dtype, mean)
                kept = keys < vocab
                rows = keys[kept].long()
                kept_upd = upd.repeat_interleave(HIST_LEN, 0)[kept]
                bound = scatter_bound(torch, keys, vocab, BATCH, dim,
                                      g.element_size(), BATCH * 4,
                                      int(kept.sum()) * dim * mean)
                timed(f"{name}_{mode}", dtype,
                      lambda: eb._scatter_launch(out, skeys, perm, gc, args,
                                                 cc, sc),
                      lambda: eb._scatter_ref(vocab, keys, upd,
                                              bag=HIST_LEN),
                      lambda: out.index_add_(0, rows, kept_upd), bound,
                      max_abs_err(got, want), slow=True)
    return recs


def step_reading(np, before, cpu, card):
    """(largest |card - cpu| over every parameter after one step, the
    names of the tables the card's step left unmoved)."""
    worst = max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu)
    unmoved = [k for k in card if k.endswith(".embedding")
               and np.array_equal(card[k], before[k])]
    return worst, unmoved


def phase_train_step(np, config, x, y, hist):
    """Phase 10(a): one step through compile/fit on the card and on the
    CPU, same weights, same batch; the loss, every parameter, and every
    table moved on the card."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    nets = {}
    for dev in ("cpu", "cuda"):
        net = train_model(config)
        net.compile(optimizer=Adam(NCF_LR),
                    loss="sparse_categorical_crossentropy", device=dev)
        nets[dev] = net
    before = nets["cpu"].get_weights()
    losses = {}
    for dev, net in nets.items():
        net.fit(train_inputs_of(config, x, hist, 0, BATCH), y[:BATCH],
                batch_size=BATCH, nb_epoch=1, shuffle=False)
        losses[dev] = net.estimator.step_losses[-1]
    worst, unmoved = step_reading(np, before, nets["cpu"].get_weights(),
                                  nets["cuda"].get_weights())
    loss_diff = abs(losses["cuda"] - losses["cpu"])
    log(f"NCF training step ({config}) on the card vs the CPU: loss "
        f"{losses['cuda']:.7f} vs {losses['cpu']:.7f} (|diff| "
        f"{loss_diff:.3g}, atol {NCF_STEP_LOSS_ATOL}); parameters within "
        f"{worst:.3g} (atol {NCF_STEP_PARAM_ATOL}); tables unmoved on the "
        f"card: {unmoved}")
    if loss_diff > NCF_STEP_LOSS_ATOL or worst > NCF_STEP_PARAM_ATOL:
        raise AssertionError(f"{config} step: card vs CPU loss {loss_diff}, "
                             f"parameters {worst}")
    if unmoved:
        raise AssertionError(f"{config} step left tables unmoved: {unmoved}")
    return dict(loss_cuda=losses["cuda"], loss_cpu=losses["cpu"],
                max_param_diff=worst)


def phase_fit(torch, np, config, x, y, hist, kind):
    """Phase 10(b)-(d): ``compile`` then ``fit`` one epoch (NCF_STEPS steps
    of BATCH) on the card after a warm-up step, then ``evaluate`` and
    ``predict``; the launches of each kernel per step."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    net = train_model(config)
    net.compile(optimizer=Adam(NCF_LR),
                loss="sparse_categorical_crossentropy")
    net.fit(train_inputs_of(config, x, hist, 0, BATCH), y[:BATCH],
            batch_size=BATCH, nb_epoch=1)            # warm up
    torch.cuda.synchronize()
    hist_out, launches, fit_s = counted(torch, lambda: net.fit(
        train_inputs_of(config, x, hist, 0, NCF_TRAIN_ROWS), y,
        batch_size=BATCH, nb_epoch=1))
    losses = net.estimator.step_losses[-NCF_STEPS:]
    n_eval = 5 * BATCH
    ev = net.evaluate(train_inputs_of(config, x, hist, 0, n_eval),
                      y[:n_eval], batch_size=BATCH)
    pred = net.predict(train_inputs_of(config, x, hist, 0, BATCH),
                       batch_size=BATCH)
    per_step = {k: v / NCF_STEPS for k, v in launches.items() if v}
    rep = dict(step_ms=fit_s / NCF_STEPS * 1e3,
               samples_per_s=NCF_TRAIN_ROWS / fit_s,
               first_loss=losses[0], last_loss=losses[-1],
               epoch_loss=hist_out["loss"][0], eval_loss=ev["loss"],
               launches=launches, launches_per_step=per_step,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"NCF training ({config}) on {kind}: {NCF_STEPS} steps of {BATCH} "
        f"at {rep['step_ms']:.3f} ms/step (host clock), "
        f"{rep['samples_per_s']:.1f} samples/s; loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; evaluate loss {ev['loss']:.5f}; kernel "
        f"launches per step {per_step}")
    if len(losses) != NCF_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{config} fit losses: {losses}")
    if not (np.isfinite(ev["loss"]) and pred.shape == (BATCH, NCF[
            "class_num"]) and np.isfinite(pred).all()):
        raise AssertionError(f"{config} evaluate/predict: {ev}, "
                             f"{pred.shape}")
    want = {"fused_embedding_lookup": 2,
            "embedding_scatter_add": 4 if config == "ncf" else 5,
            "embedding_bag": 0 if config == "ncf" else 1}
    for name, n in want.items():
        if launches.get(name, 0) != n * NCF_STEPS:
            raise AssertionError(f"{config} fit: {name} launched "
                                 f"{launches.get(name, 0)} times in "
                                 f"{NCF_STEPS} steps, not {n} a step")
    return rep


def dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def io_times(torch, write, read, path: str) -> dict:
    """Median host ms of ``write(path)`` and ``read(path)`` (each ended by
    a device sync) over CKPT_IO_REPS, and the MB written."""
    import shutil
    w, r = [], []
    for _ in range(CKPT_IO_REPS):
        shutil.rmtree(path, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write(path)
        torch.cuda.synchronize()
        w.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        read(path)
        torch.cuda.synchronize()
        r.append((time.perf_counter() - t0) * 1e3)
    mb = dir_mb(path)
    w_ms, r_ms = sorted(w)[len(w) // 2], sorted(r)[len(r) // 2]
    return dict(mb=mb, write_ms=w_ms, read_ms=r_ms,
                write_mb_per_s=mb / (w_ms / 1e3),
                read_mb_per_s=mb / (r_ms / 1e3), write_all_ms=w,
                read_all_ms=r)


def same_state(torch, a, b) -> bool:
    """Two estimators hold bitwise the same parameters, optimizer state
    and step."""
    if a._py_step != b._py_step or a._epoch != b._epoch:
        return False
    pa, pb = a.model.state_dict(), b.model.state_dict()
    if any(not torch.equal(pa[k], pb[k]) for k in pa):
        return False
    sa, sb = a._opt_state, b._opt_state
    return sa["count"] == sb["count"] and all(
        torch.equal(x, y) for k in sa if k != "count"
        for x, y in zip(sa[k], sb[k]))


def ckpt_resume(torch, np, root, x, y, card):
    """Phase 11(a): a plain and a faulted, auto-resumed fit end bitwise
    alike. Returns (report, the plain run's NeuralCF)."""
    from analytics_zoo_tpu_torch.common import resilience
    from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.learn.trigger import SeveralIteration
    from analytics_zoo_tpu_torch.models import NeuralCF
    rows = CKPT_EPOCH_STEPS * BATCH
    runs = {}
    for label in ("plain", "faulted"):
        ncf = NeuralCF(**NCF)
        seeded_weights(ncf.model.module, SEED)
        ncf.compile(optimizer=Adam(NCF_LR),
                    loss="sparse_categorical_crossentropy")
        mdir = os.path.join(root, label)
        ncf.set_checkpoint(mdir)
        if label == "faulted":
            os.environ["ZOO_FAULT_PLAN"] = CKPT_FAULT
        resilience.reset_for_tests()
        try:
            t0 = time.perf_counter()
            hist = ncf.fit(x[:rows], y[:rows], batch_size=BATCH,
                           nb_epoch=CKPT_EPOCHS,
                           checkpoint_trigger=SeveralIteration(CKPT_EVERY),
                           auto_resume=label == "faulted")
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            inj = resilience.get_injector()
            arrivals = inj.counts().get("step", 0) if inj else None
        finally:
            os.environ.pop("ZOO_FAULT_PLAN", None)
            resilience.reset_for_tests()
        runs[label] = dict(ncf=ncf, hist=hist, fit_s=fit_s,
                           arrivals=arrivals,
                           versions=sorted(ckpt._list_versions(mdir)))
    a, b = (runs[k]["ncf"].model.estimator for k in ("plain", "faulted"))
    total = CKPT_EPOCHS * CKPT_EPOCH_STEPS
    rep = dict(steps=a._py_step, versions=runs["plain"]["versions"],
               faulted_versions=runs["faulted"]["versions"],
               faulted_step_arrivals=runs["faulted"]["arrivals"],
               plain_fit_s=runs["plain"]["fit_s"],
               faulted_fit_s=runs["faulted"]["fit_s"],
               bitwise=same_state(torch, a, b),
               same_losses=a.step_losses == b.step_losses,
               same_history=runs["plain"]["hist"] == runs["faulted"]["hist"])
    # the fault struck at step 18, and the resume from ckpt-15 ran the
    # last 9 steps once more: 18 + 9 arrivals
    want_arrivals = int(CKPT_FAULT.split(":")[1]) + total - \
        CKPT_RESUMED_FROM
    log(f"checkpoints (a) NCF fit {total} steps with a snapshot every "
        f"{CKPT_EVERY} on {card}: versions {rep['versions']}; faulted run "
        f"({CKPT_FAULT}, auto_resume) {rep['faulted_step_arrivals']} step "
        f"arrivals (want {want_arrivals}), bitwise equal state "
        f"{rep['bitwise']}, step losses {rep['same_losses']}, history "
        f"{rep['same_history']}; fit {rep['plain_fit_s']:.3f} s plain, "
        f"{rep['faulted_fit_s']:.3f} s faulted (host clock)")
    if not (rep["bitwise"] and rep["same_losses"] and rep["same_history"]
            and a._py_step == total
            and rep["faulted_step_arrivals"] == want_arrivals
            and rep["versions"] == list(range(CKPT_EVERY, total + 1,
                                              CKPT_EVERY))):
        raise AssertionError(f"phase 11(a): {rep}")
    return rep, runs["plain"]["ncf"]


def ckpt_serve(np, ncf, root, x, serving_api, card):
    """Phase 11(b): save_model, InferenceModel.load, predict bitwise equal
    to the live model, a burst through ClusterServing."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb
    Broker, ClusterServing, InputQueue, OutputQueue = serving_api
    path = os.path.join(root, "ncf_model")
    ncf.save_model(path)
    im = InferenceModel(device="cuda").load(path)
    live = ncf.predict(x, batch_size=BATCH)
    got = im.predict(x, batch_size=BATCH)
    before = eb.launches.value
    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port, batch_size=SERVE_BATCH,
                           max_batch_size=SERVE_BATCH, warmup=False):
        iq = InputQueue(port=broker.port)
        oq = OutputQueue(port=broker.port)
        uris = iq.enqueue_batch((f"c{i}", {"x": x[i]})
                                for i in range(N_BURST))
        served = oq.query_many(uris, timeout=120, poll_interval=0.002)
        iq.close()
        oq.close()
    launches = eb.launches.value - before
    worst = max(float(np.abs(served[f"c{i}"] - got[i]).max())
                for i in range(N_BURST))
    rep = dict(bitwise=bool(np.array_equal(got, live)), served_max_abs_diff=worst,
               serving_lookup_launches=launches)
    log(f"checkpoints (b) save_model -> InferenceModel.load on {card}: "
        f"predict bitwise equal to the live model {rep['bitwise']}; "
        f"{N_BURST} records served, max |served - predict| {worst:.3g}, "
        f"lookup launches while serving {launches}")
    if not rep["bitwise"] or worst > SLICE_ATOL or launches <= 0:
        raise AssertionError(f"phase 11(b): {rep}")
    return rep


def ckpt_jax_files(np, card):
    """Phase 11(c): the JAX package's committed checkpoints on the card."""
    from analytics_zoo_tpu_torch.inference import InferenceModel

    def arr(name):
        return np.load(os.path.join(JAX_CKPTS, name + ".npy"))
    ncf = InferenceModel(device="cuda").load(os.path.join(JAX_CKPTS, "ncf"))
    ncf_diff = float(np.abs(ncf.predict(arr("ncf_x")) -
                            arr("ncf_pred")).max())
    s2s = InferenceModel(device="cuda").load(
        os.path.join(JAX_CKPTS, "seq2seq"))
    enc, dec, start = arr("seq2seq_enc"), arr("seq2seq_dec"), \
        arr("seq2seq_start")
    s2s_diff = float(np.abs(s2s.predict((enc, dec)) -
                            arr("seq2seq_pred")).max())
    greedy = s2s.generate(enc, start, arr("seq2seq_greedy").shape[1])
    rep = dict(ncf_max_abs_diff=ncf_diff, seq2seq_max_abs_diff=s2s_diff,
               greedy_equal=bool(np.array_equal(greedy,
                                                arr("seq2seq_greedy"))))
    log(f"checkpoints (c) the JAX package's files on {card}: NCF predict "
        f"within {ncf_diff:.3g}, Seq2Seq within {s2s_diff:.3g} of JAX's "
        f"(atol {CKPT_JAX_ATOL}); greedy tokens equal {rep['greedy_equal']}")
    if max(ncf_diff, s2s_diff) > CKPT_JAX_ATOL or not rep["greedy_equal"]:
        raise AssertionError(f"phase 11(c): {rep}")
    return rep


def ckpt_roundtrips(torch, np, root, x, y, hist, card):
    """Phase 11(d)-(e): the history-column NCF and BERT-Base round trips,
    with write and read times."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.text import BERTClassifier, BertConfig
    rep = {}
    # the history-column NCF: two steps, then save_weights / load_weights
    nets = []
    for _ in range(2):
        net = train_model("hist")
        net.compile(optimizer=Adam(NCF_LR),
                    loss="sparse_categorical_crossentropy")
        nets.append(net)
    src, dst = nets
    inputs = train_inputs_of("hist", x, hist, 0, 2 * BATCH)
    src.fit(inputs, y[:2 * BATCH], batch_size=BATCH, nb_epoch=1)
    io = io_times(torch, src.save_weights, dst.load_weights,
                  os.path.join(root, "hist"))
    probe = train_inputs_of("hist", x, hist, 0, BATCH)
    io.update(state_bitwise=same_state(torch, src.estimator, dst.estimator),
              predict_bitwise=bool(np.array_equal(
                  src.predict(probe, batch_size=BATCH),
                  dst.predict(probe, batch_size=BATCH))))
    rep["hist"] = io
    # BERT-Base: one Adam step at the fine-tuning shape, save, load into a
    # classifier drawn from another seed
    config = BertConfig(use_flash=True)
    ids, labels = train_inputs(np.random.RandomState(SEED + 2), TRAIN_BATCH)
    a = BERTClassifier(BERT_CLASSES, config=config, seq_len=TRAIN_LEN,
                       seed=SEED)
    a.fit(ids, labels, epochs=1, batch_size=TRAIN_BATCH)
    b = BERTClassifier(BERT_CLASSES, config=config, seq_len=TRAIN_LEN,
                       seed=SEED + 1)
    io = io_times(torch, a.save, b.load, os.path.join(root, "bert"))
    xb = bert_inputs(np.random.RandomState(SEED), BERT_BATCH)
    sample = tuple(t[:BERT_CPU_ROWS] for t in xb)
    ya = InferenceModel(device="cuda").load_torch(
        a.estimator.model, sample).predict(xb, batch_size=BERT_BATCH)
    yb = InferenceModel(device="cuda").load_torch(
        b.estimator.model, sample).predict(xb, batch_size=BERT_BATCH)
    io.update(state_bitwise=same_state(torch, a.estimator, b.estimator),
              predict_bitwise=bool(np.array_equal(ya, yb)), blocks=config.n_block)
    rep["bert"] = io
    for name, r in rep.items():
        log(f"checkpoints (d)/(e) {name} round trip on {card}: "
            f"{r['mb']:.1f} MB, write {r['write_ms']:.1f} ms "
            f"({r['write_mb_per_s']:.0f} MB/s), read {r['read_ms']:.1f} ms "
            f"({r['read_mb_per_s']:.0f} MB/s) (host clock, median of "
            f"{CKPT_IO_REPS}); state bitwise {r['state_bitwise']}, predict "
            f"bitwise {r['predict_bitwise']}")
        if not (r["state_bitwise"] and r["predict_bitwise"]):
            raise AssertionError(f"phase 11(d) {name}: {r}")
    del a, b
    torch.cuda.empty_cache()
    return rep


def phase_checkpoints(torch, np, x, y, hist, serving_api, card):
    """Phase 11 (a)-(e); the directory it writes is removed after."""
    import shutil
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    try:
        rep = {}
        rep["resume"], ncf = ckpt_resume(torch, np, CKPT_DIR, x, y, card)
        rep["serve"] = ckpt_serve(np, ncf, CKPT_DIR, x[:BATCH],
                                  serving_api, card)
        rep["jax_files"] = ckpt_jax_files(np, card)
        rep["roundtrips"] = ckpt_roundtrips(torch, np, CKPT_DIR, x, y, hist,
                                            card)
        rep["a_io"] = io_times(torch, ncf.model.estimator.save,
                               ncf.model.estimator.load,
                               os.path.join(CKPT_DIR, "ncf_io"))
        log(f"checkpoints (e) NCF at MovieLens-1M width with Adam on "
            f"{card}: {rep['a_io']['mb']:.2f} MB, write "
            f"{rep['a_io']['write_ms']:.2f} ms, read "
            f"{rep['a_io']['read_ms']:.2f} ms (host clock, median of "
            f"{CKPT_IO_REPS})")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return rep


def wnd_info():
    """bench.py's Wide&Deep column set (WND_DIMS)."""
    from analytics_zoo_tpu_torch.models import ColumnFeatureInfo
    d = WND_DIMS
    return ColumnFeatureInfo(
        wide_base_cols=[f"wb{i}" for i in range(len(d["wide_base"]))],
        wide_base_dims=list(d["wide_base"]),
        wide_cross_cols=[f"wc{i}" for i in range(len(d["wide_cross"]))],
        wide_cross_dims=list(d["wide_cross"]),
        indicator_cols=[f"ind{i}" for i in range(len(d["indicator"]))],
        indicator_dims=list(d["indicator"]),
        embed_cols=[f"em{i}" for i in range(len(d["embed_in"]))],
        embed_in_dims=list(d["embed_in"]),
        embed_out_dims=list(d["embed_out"]),
        continuous_cols=[f"con{i}" for i in range(d["n_continuous"])])


def wnd_data(np):
    """bench.py's Wide&Deep batch (measure_widedeep_train, seed 4):
    ``([wide, indicator, embed, continuous], y)``."""
    d = WND_DIMS
    rng = np.random.default_rng(4)
    b = WND_BATCH
    wide = (rng.random((b, sum(d["wide_base"]) + sum(d["wide_cross"])))
            < 0.05).astype(np.float32)
    ind = (rng.random((b, sum(d["indicator"]))) < 0.2).astype(np.float32)
    emb = np.stack([rng.integers(0, n, b) for n in d["embed_in"]],
                   1).astype(np.float32)
    con = rng.standard_normal((b, d["n_continuous"])).astype(np.float32)
    y = rng.integers(0, 2, b).astype(np.int32)
    return [wide, ind, emb, con], y


def seeded_zoo(make):
    """A fresh zoo model from ``make()`` with weights from the numpy
    seed."""
    m = make()
    seeded_weights(m.model.module, SEED)
    return m


def adam_reading(np, cpu, card):
    """(largest |card - cpu| over every parameter, the largest share of a
    leaf's elements past ZOO_PARAM_ATOL)."""
    worst = max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu)
    share = max(float(np.mean(np.abs(card[k] - cpu[k]) > ZOO_PARAM_ATOL))
                for k in cpu)
    return worst, share


def card_cpu_grads(np, make_net, x, y, loss, what):
    """One batch's gradients through the estimator's loss (the penalty
    included) on the card and on the CPU, each from a fresh
    ``make_net()`` (a keras net with weights from the numpy seed): every
    leaf within ZOO_GRAD_RTOL of its largest |gradient| on the CPU."""
    grads = {}
    for dev in ("cpu", "cuda"):
        net = make_net()
        net.compile(optimizer="sgd", loss=loss, device=dev)
        est = net.estimator
        _, g = est._loss_and_grads(x, y)
        grads[dev] = {n: t.cpu().numpy() for n, t in zip(est._names, g)}
    rel = {}
    for n, want in grads["cpu"].items():
        scale = float(np.abs(want).max())
        diff = float(np.abs(grads["cuda"][n] - want).max())
        rel[n] = diff / scale if scale > 0 else diff
    worst = max(rel, key=rel.get)
    rep = dict(grad_max_rel_diff=rel[worst], grad_worst_leaf=worst,
               grad_leaves=len(rel))
    log(f"  {what}: one batch's gradients on the card vs the CPU: each of "
        f"{len(rel)} leaves within {rel[worst]:.3g} of its largest "
        f"|gradient| (worst {worst}; limit {ZOO_GRAD_RTOL})")
    if rel[worst] > ZOO_GRAD_RTOL:
        raise AssertionError(f"{what} gradients, card vs CPU: {rel}")
    return rep


def step_window(torch, net, x, y) -> float:
    """ms a training step of the compiled keras ``net`` on the card, as
    bench.py's _measure_step_time takes it: the batch on the card once,
    STEP_WARMUP steps, then STEP_WINDOW steps on the host clock between
    two syncs (no data feed, no read-back, no summaries)."""
    est = net.estimator
    xs, ys = est._tensors(x), est._tensors(y)
    for _ in range(STEP_WARMUP):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEP_WINDOW):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEP_WINDOW * 1e3


def card_cpu_step(np, make, x, y, loss, what, strict):
    """One Adam step through compile/fit on the card and on the CPU from
    the same weights and batch. ``strict``: the loss and every parameter
    within WND_ATOL (Wide&Deep); else the CPU tests' limits. Then the
    batch's gradients (card_cpu_grads). Returns (the card's model, the
    reading)."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    models, losses = {}, {}
    for dev in ("cpu", "cuda"):
        m = seeded_zoo(make)
        if dev == "cpu":
            before = m.model.get_weights()
        m.compile(optimizer=Adam(ZOO_LR), loss=loss, device=dev)
        m.fit(x, y, batch_size=len(y), nb_epoch=1, shuffle=False)
        models[dev] = m
        losses[dev] = m.model.estimator.step_losses[-1]
    cpu, card = models["cpu"].model.get_weights(), \
        models["cuda"].model.get_weights()
    worst, share = adam_reading(np, cpu, card)
    unmoved = [k for k in card if k.endswith(".embedding")
               and np.array_equal(card[k], before[k])]
    loss_diff = abs(losses["cuda"] - losses["cpu"])
    rep = dict(loss_card=losses["cuda"], loss_cpu=losses["cpu"],
               loss_diff=loss_diff, max_param_diff=worst,
               share_past_atol=share, unmoved_tables=unmoved)
    if strict:
        ok = loss_diff <= WND_ATOL and worst <= WND_ATOL
        limit = f"atol {WND_ATOL}"
    else:
        ok = (loss_diff <= ZOO_LOSS_RTOL * abs(losses["cpu"])
              and share <= ZOO_PARAM_SHARE and worst <= 2 * ZOO_LR)
        limit = (f"loss rtol {ZOO_LOSS_RTOL}; parameters within "
                 f"{ZOO_PARAM_ATOL} in all but {ZOO_PARAM_SHARE:.0%} of "
                 f"each leaf, {2 * ZOO_LR} everywhere")
    log(f"  {what}: one step on the card vs the CPU: loss "
        f"{losses["cuda"]:.7f} vs {losses['cpu']:.7f} (|diff| "
        f"{loss_diff:.3g}); parameters within {worst:.3g} ({share:.2%} of "
        f"a leaf past {ZOO_PARAM_ATOL}); tables unmoved {unmoved}; {limit}")
    if not ok or unmoved:
        raise AssertionError(f"{what} step, card vs CPU: {rep}")
    rep.update(card_cpu_grads(np, lambda: seeded_zoo(make).model, x, y,
                              loss, what))
    return models["cuda"], rep


def wnd_kernels(torch, np, eb, x):
    """Phase 12(a)'s kernels at Wide&Deep's shapes, against their plain
    versions bitwise (tables of 17 x 8 and 1001 x 64, concat, the batch's
    float ids cast by truncation as the layer casts them): the lookup, and
    the scatter-add of both tables for a random gradient, with times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    shapes = [(n + 1, d) for n, d in zip(WND_DIMS["embed_in"],
                                         WND_DIMS["embed_out"])]
    tables = [torch.randn(v, d, generator=gen).to(dev) for v, d in shapes]
    ids = torch.from_numpy(x[2]).to(dev).to(torch.int32)
    got = eb.fused_embedding_lookup(tables, ids, "concat")
    want = eb._fused_ref(tables, ids, "concat")
    g = torch.randn(got.shape, generator=gen).to(dev)
    grads = eb._fused_bwd_cuda(tables, ids, g, "concat")
    grads_ref = eb._fused_bwd_ref(tables, ids, g, "concat")
    again = eb._fused_bwd_cuda(tables, ids, g, "concat")
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError(f"Wide&Deep lookup kernel != plain: "
                             f"{max_abs_err(got, want)}")
    _check_scatter("wide_and_deep", grads, grads_ref, again)
    bound, bound_by = lookup_bound(tables, ids, "concat")
    lookup = dict(case="wide_and_deep", max_abs_err=max_abs_err(got, want),
                  ms=cuda_ms(lambda: eb.fused_embedding_lookup(
                      tables, ids, "concat")),
                  plain_ms=cuda_ms(lambda: eb._fused_ref(tables, ids,
                                                         "concat")),
                  library_ms=cuda_ms(lambda: library_call(tables, ids,
                                                          "concat")),
                  bound_ms=bound, bound_by=bound_by)
    # the scatter: the wider table's launch alone, keys sorted beforehand
    i = 1
    keys, args, cc, sc = eb._fused_scatter_plan(tables, ids, g, "concat", i)
    skeys, perm = torch.sort(keys, stable=True)
    out = torch.zeros_like(tables[i])
    upd = eb._fused_updates(tables, ids, g, "concat", i)
    rows = keys.long()
    bound = scatter_bound(torch, keys, shapes[i][0], WND_BATCH, shapes[i][1],
                          g.element_size())
    scatter = dict(case="wide_and_deep_embed_1",
                   max_abs_err=max(max_abs_err(a, b)
                                   for a, b in zip(grads, grads_ref)),
                   ms=cuda_ms(lambda: eb._scatter_launch(
                       out, skeys, perm, g, args, cc, sc)),
                   plain_ms=cuda_ms(lambda: eb._scatter_ref(
                       shapes[i][0], keys, upd), iters=3, warmup=1),
                   library_ms=cuda_ms(lambda: out.index_add_(0, rows, upd)),
                   bound_ms=bound[0], bound_by=bound[1])
    for name, rec in (("lookup", lookup), ("scatter", scatter)):
        log(f"  {name} at Wide&Deep's tables (8 + 64 wide, b {WND_BATCH}) "
            f"bitwise: kernel {rec['ms']:.4f} ms  plain "
            f"{rec['plain_ms']:.4f} ms  library {rec['library_ms']:.4f} ms"
            f"  bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return lookup, scatter


def events_of(log_dir):
    """The scalars of the one events file under ``log_dir``, read back
    from disk."""
    import glob
    from analytics_zoo_tpu_torch.common.summary import read_scalars
    (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    return read_scalars(path)


def phase_widedeep(torch, np, eb, card):
    """Phase 12(a): Wide&Deep wide_n_deep at bench.py's width through
    compile/fit/predict on the card."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import WideAndDeep
    x, y = wnd_data(np)
    rep = {}
    rep["lookup"], rep["scatter"] = wnd_kernels(torch, np, eb, x)
    loss = "sparse_categorical_crossentropy"

    def make(variant="wide_n_deep"):
        return lambda: WideAndDeep(2, wnd_info(), model_type=variant)
    net, rep["step"] = card_cpu_step(np, make(), x, y, loss,
                                     "Wide&Deep wide_n_deep", strict=True)
    # the path starts here (the launches above compare): the summaries on,
    # a warm-up fit of one step (it opens the events files), then a fit of
    # WND_STEPS steps and bench.py's step window
    from analytics_zoo_tpu_torch.ops import _build
    _build.reset_launch_counts()
    log_dir = os.path.join(ZOO_DIR, "tensorboard")
    net.set_tensorboard(log_dir, "widedeep")
    _, warm, _ = counted(torch, lambda: net.fit(x, y, batch_size=WND_BATCH,
                                                nb_epoch=1, shuffle=False))
    first = net.model.estimator._py_step
    xs = [np.tile(a, (WND_STEPS, 1)) for a in x]
    _, launches, fit_s = counted(torch, lambda: net.fit(
        xs, np.tile(y, WND_STEPS), batch_size=WND_BATCH, nb_epoch=1,
        shuffle=False, summary_interval=WND_SUMMARY_EVERY))
    losses = net.model.estimator.step_losses[-WND_STEPS:]
    per_step = {k: v / WND_STEPS for k, v in launches.items() if v}
    step_ms = step_window(torch, net.model, x, y)
    rep["fit"] = dict(widedeep_train_step_ms=step_ms,
                      widedeep_train_samples_per_sec=WND_BATCH / step_ms
                      * 1e3, fit_step_ms=fit_s / WND_STEPS * 1e3,
                      first_loss=losses[0], last_loss=losses[-1],
                      launches=launches, launches_per_step=per_step,
                      warm_up_launches=warm)
    log(f"Wide&Deep training on {card}: widedeep_train_step_ms "
        f"{step_ms:.3f}, widedeep_train_samples_per_sec "
        f"{rep['fit']['widedeep_train_samples_per_sec']:.1f} ({STEP_WINDOW} "
        f"steps of {WND_BATCH} after {STEP_WARMUP}, the batch on the card, "
        f"host clock); fit of {WND_STEPS} steps, summaries on: "
        f"{rep['fit']['fit_step_ms']:.3f} ms a step; loss {losses[0]:.5f} "
        f"-> {losses[-1]:.5f}; kernel launches per step {per_step}")
    if launches.get("fused_embedding_lookup", 0) != WND_STEPS or \
            launches.get("embedding_scatter_add", 0) != 2 * WND_STEPS:
        raise AssertionError(f"Wide&Deep fit: {launches} in {WND_STEPS} "
                             "steps, not 1 lookup and 2 scatters a step")
    if not np.isfinite(losses).all():
        raise AssertionError(f"Wide&Deep fit losses: {losses}")
    # the summaries, read back from the events files: the warm-up fit's
    # flush, then the long fit's
    flushes = [first] + [first + s for s in range(
        WND_SUMMARY_EVERY, WND_STEPS + 1, WND_SUMMARY_EVERY)]
    events = events_of(os.path.join(log_dir, "widedeep", "train"))
    want_loss = [(s, float(np.float32(net.model.estimator.step_losses[
        s - 1]))) for s in flushes]
    rep["summaries"] = dict(events)
    if (events.get("Loss") != want_loss
            or [s for s, _ in events.get("Throughput", [])] != flushes
            or not all(v > 0 for _, v in events["Throughput"])
            or events.get("LearningRate") != [
                (s, float(np.float32(ZOO_LR))) for s in flushes]):
        raise AssertionError(f"Wide&Deep summaries: {events}, want Loss "
                             f"{want_loss} at {flushes}")
    log(f"  summaries read back: Loss, Throughput and LearningRate at "
        f"steps {flushes}")
    # predict against the CPU from the card's weights; save_model ->
    # InferenceModel.load -> predict bitwise
    pred = net.predict(x, batch_size=WND_BATCH)
    cpu = WideAndDeep(2, wnd_info())
    cpu.model.module.load_state_dict({
        k: torch.from_numpy(v) for k, v in net.model.get_weights().items()})
    pred_cpu = cpu.predict(x, batch_size=WND_BATCH, device="cpu")
    path = os.path.join(ZOO_DIR, "widedeep_model")
    net.save_model(path)
    loaded = InferenceModel(device="cuda").load(path).predict(
        tuple(x), batch_size=WND_BATCH)
    rep["predict"] = dict(max_abs_diff_cpu=float(np.abs(pred - pred_cpu)
                                                 .max()),
                          loaded_bitwise=bool(np.array_equal(pred, loaded)))
    log(f"  predict {WND_BATCH} rows: max |card - cpu| "
        f"{rep['predict']['max_abs_diff_cpu']:.3g} (atol {WND_ATOL}); "
        f"save_model -> InferenceModel.load -> predict bitwise "
        f"{rep['predict']['loaded_bitwise']}")
    if pred.shape != (WND_BATCH, 2) or \
            rep["predict"]["max_abs_diff_cpu"] > WND_ATOL or \
            not rep["predict"]["loaded_bitwise"]:
        raise AssertionError(f"phase 12(a) predict: {rep['predict']}")
    # the other two variants: one step and one predict each
    for variant in ("wide", "deep"):
        xv = x[0] if variant == "wide" else x[1:]
        m, rep[variant] = card_cpu_step(np, make(variant), xv, y, loss,
                                        f"Wide&Deep {variant}", strict=True)
        p = m.predict(xv, batch_size=WND_BATCH)
        if p.shape != (WND_BATCH, 2) or not np.isfinite(p).all():
            raise AssertionError(f"Wide&Deep {variant} predict {p.shape}")
    return rep


def same_topk(got, want, probs) -> bool:
    """The card's top-k items equal the CPU's, rank for rank, where an
    item may stand in for another only if their CPU probabilities lie
    within ZOO_PRED_ATOL (a near tie)."""
    return all(abs(p[a] - p[b]) <= ZOO_PRED_ATOL
               for g, w, p in zip(got, want, probs)
               for (a, _), (b, _) in zip(g, w))


def phase_session(torch, np, card):
    """Phase 12(b): SessionRecommender at MovieLens-1M's item width."""
    from analytics_zoo_tpu_torch.models import SessionRecommender
    items = SR["item_count"]
    rng = np.random.default_rng(12)
    n = ZOO_BATCH * ZOO_FIT_STEPS
    xs = rng.integers(1, items + 1, (n, SR["session_length"])).astype(
        np.float32)
    xh = rng.integers(1, items + 1, (n, SR["history_length"])).astype(
        np.float32)
    y = rng.integers(0, items, n).astype(np.int32)
    loss = "sparse_categorical_crossentropy"
    make = lambda: SessionRecommender(**SR)  # noqa: E731
    m, rep = card_cpu_step(np, make, [xs[:ZOO_BATCH], xh[:ZOO_BATCH]],
                           y[:ZOO_BATCH], loss, "SessionRecommender",
                           strict=False)
    _, launches, _ = counted(torch, lambda: m.fit(
        [xs, xh], y, batch_size=ZOO_BATCH, nb_epoch=1))
    step_ms = step_window(torch, m.model, [xs[:ZOO_BATCH], xh[:ZOO_BATCH]],
                          y[:ZOO_BATCH])
    n_rec = SR_ROWS_RECOMMENDED
    sessions = [xs[:n_rec], xh[:n_rec]]
    got = m.recommend_for_session(sessions, SR_TOPK)
    cpu = make()
    cpu.model.module.load_state_dict({
        k: torch.from_numpy(v) for k, v in m.model.get_weights().items()})
    probs = cpu.predict(sessions, device="cpu")
    want = cpu.recommend_for_session(sessions, SR_TOPK, device="cpu")
    rep.update(step_ms=step_ms, samples_per_s=ZOO_BATCH / step_ms * 1e3,
               launches=launches,
               topk_equal=same_topk(got, want, probs),
               topk_exactly_equal=[[i for i, _ in r] for r in got]
               == [[i for i, _ in r] for r in want])
    log(f"SessionRecommender (3706 items, session 8, history 8) on {card}: "
        f"a fit of {ZOO_FIT_STEPS} steps of {ZOO_BATCH}, then "
        f"{rep['step_ms']:.3f} ms a step over {STEP_WINDOW} (host clock), "
        f"{rep['samples_per_s']:.1f} samples/s; recommend_for_session top "
        f"{SR_TOPK} of {n_rec} sessions equal to the CPU's "
        f"{rep['topk_equal']} (exactly {rep['topk_exactly_equal']})")
    if not rep["topk_equal"]:
        raise AssertionError(f"phase 12(b): {rep}")
    return rep


def phase_anomaly(torch, np, card):
    """Phase 12(c): AnomalyDetector with its default layers."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import AnomalyDetector
    t = np.arange(ZOO_BATCH * ZOO_FIT_STEPS + AD_WINDOW, dtype=np.float32)
    rng = np.random.default_rng(13)
    series = (np.sin(t / 8) + 0.1 * rng.standard_normal(t.shape)).astype(
        np.float32)
    x, y = AnomalyDetector.unroll(series, AD_WINDOW)
    x, y = x[:ZOO_BATCH * ZOO_FIT_STEPS], y[:ZOO_BATCH * ZOO_FIT_STEPS]
    _, rep = card_cpu_step(
        np, lambda: AnomalyDetector((AD_WINDOW, 1), dropouts=(0, 0, 0)),
        x[:ZOO_BATCH], y[:ZOO_BATCH], "mse", "AnomalyDetector dropouts 0",
        strict=False)
    m = seeded_zoo(lambda: AnomalyDetector((AD_WINDOW, 1)))
    m.compile(optimizer=Adam(1e-2), loss="mse", device="cuda")
    hist = m.fit(x, y, batch_size=ZOO_BATCH, nb_epoch=3)
    pred = m.predict(x, batch_size=ZOO_BATCH)
    spiked = y.copy()
    spiked[list(AD_ANOMALIES)] += np.float32(10.0)
    found = sorted(AnomalyDetector.detect_anomalies(
        spiked, pred, len(AD_ANOMALIES)).tolist())
    # the step window after the predictions: its steps move the weights
    step_ms = step_window(torch, m.model, x[:ZOO_BATCH], y[:ZOO_BATCH])
    rep.update(losses=hist["loss"], step_ms=step_ms,
               samples_per_s=ZOO_BATCH / step_ms * 1e3, found=found)
    log(f"AnomalyDetector (8, 32, 15) over windows of {AD_WINDOW} on {card}:"
        f" dropouts 0.2, 3 epochs of {ZOO_FIT_STEPS} steps, loss "
        f"{hist['loss'][0]:.5f} -> {hist['loss'][-1]:.5f}; detect_anomalies "
        f"on the card's predictions: {found}; then {step_ms:.3f} ms a step "
        f"over {STEP_WINDOW} (host clock)")
    if not hist["loss"][-1] < hist["loss"][0] or \
            found != sorted(AD_ANOMALIES) or not np.isfinite(pred).all():
        raise AssertionError(f"phase 12(c): {rep}")
    return rep


def phase_seq2seq_fit(torch, np, card):
    """Phase 12(d): Seq2Seq.fit at bench.py's decode configuration, then
    greedy infer bitwise the decode paths."""
    from analytics_zoo_tpu_torch.inference import InferenceModel, generation
    from analytics_zoo_tpu_torch.models import Seq2Seq
    rng = np.random.default_rng(14)
    n = S2S_BATCH * ZOO_FIT_STEPS
    enc = rng.standard_normal((n, 8, DECODE["input_dim"])).astype(np.float32)
    dec = rng.standard_normal((n, 4, DECODE["output_dim"])).astype(
        np.float32)
    tgt = rng.standard_normal((n, 4, DECODE["output_dim"])).astype(
        np.float32)
    make = lambda: Seq2Seq(**DECODE)  # noqa: E731
    m, rep = card_cpu_step(np, make, [enc[:S2S_BATCH], dec[:S2S_BATCH]],
                           tgt[:S2S_BATCH], "mse", "Seq2Seq", strict=False)
    hist = m.fit([enc, dec], tgt, batch_size=S2S_BATCH, nb_epoch=1)
    step_ms = step_window(torch, m.model, [enc[:S2S_BATCH], dec[:S2S_BATCH]],
                          tgt[:S2S_BATCH])
    b, steps = DECODE_BATCH, DECODE_STEPS
    start = np.zeros((b, DECODE["output_dim"]), np.float32)
    greedy = m.infer(enc[:b], start, max_seq_len=steps + 1, mode="greedy")
    im = InferenceModel(device="cuda").load_zoo(m)
    exact = generation.decode_loop(im.decode_step_fn(), enc[:b], start,
                                   steps, ladder=None, mode="greedy")
    generated = im.generate(enc[:b], start, steps)
    rep.update(step_ms=step_ms, samples_per_s=S2S_BATCH / step_ms * 1e3,
               loss=hist["loss"],
               infer_equals_exact=bool(np.array_equal(greedy, exact)),
               infer_equals_generate=bool(np.array_equal(greedy, generated)))
    log(f"Seq2Seq.fit (GRU, hidden 64) on {card}: a fit of {ZOO_FIT_STEPS} "
        f"steps of {S2S_BATCH}, then {step_ms:.3f} ms a step over "
        f"{STEP_WINDOW} (host clock); "
        f"greedy infer {b} x {steps} bitwise the exact-length loop "
        f"{rep['infer_equals_exact']} and InferenceModel.generate "
        f"{rep['infer_equals_generate']}")
    if not (rep["infer_equals_exact"] and rep["infer_equals_generate"]
            and np.isfinite(hist["loss"]).all()):
        raise AssertionError(f"phase 12(d): {rep}")
    return rep


def regularized_model():
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as zl
    from analytics_zoo_tpu_torch.keras import regularizers as reg
    net = Sequential()
    net.add(zl.Dense(REG_WIDTHS[1], activation="relu",
                     input_shape=(REG_WIDTHS[0],),
                     W_regularizer=reg.l2(1e-3), b_regularizer=reg.l1(1e-3)))
    net.add(zl.Dense(REG_WIDTHS[2], activation="softmax",
                     W_regularizer=reg.l1_l2(1e-4, 1e-3)))
    return net


def phase_regularized(torch, np, card):
    """Phase 12(e): the penalty on the card equals the CPU's."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((ZOO_BATCH, REG_WIDTHS[0])).astype(np.float32)
    y = rng.integers(0, REG_WIDTHS[2], ZOO_BATCH).astype(np.int32)
    losses, penalties = {}, {}
    for dev in ("cpu", "cuda"):
        net = regularized_model()
        seeded_weights(net.module, SEED)
        net.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                    device=dev)
        params = dict(net.module.named_parameters())
        with torch.no_grad():
            penalties[dev] = float(net.estimator.param_penalty(params))
        net.fit(x, y, batch_size=ZOO_BATCH, nb_epoch=1, shuffle=False)
        losses[dev] = net.estimator.step_losses[-1]
    rep = dict(loss_card=losses["cuda"], loss_cpu=losses["cpu"],
               penalty_card=penalties["cuda"], penalty_cpu=penalties["cpu"],
               loss_diff=abs(losses["cuda"] - losses["cpu"]))
    log(f"regularized Sequential on {card}: loss with the penalty "
        f"{losses["cuda"]:.7f} vs the CPU's {losses['cpu']:.7f} (|diff| "
        f"{rep['loss_diff']:.3g}, atol {WND_ATOL}); penalty "
        f"{penalties["cuda"]:.7f} vs {penalties['cpu']:.7f}")
    if rep["loss_diff"] > WND_ATOL or penalties["cuda"] <= 0 or \
            abs(penalties["cuda"] - penalties["cpu"]) > WND_ATOL:
        raise AssertionError(f"phase 12(e): {rep}")

    def seeded():
        net = regularized_model()
        seeded_weights(net.module, SEED)
        return net
    rep.update(card_cpu_grads(np, seeded, x, y,
                              "sparse_categorical_crossentropy",
                              "regularized Sequential"))
    return rep


def zoo_jax_wide_and_deep(np, card):
    """Phase 12(f): the JAX package's committed Wide&Deep on the card."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    xs = tuple(np.load(os.path.join(JAX_CKPTS, f"wide_and_deep_{n}.npy"))
               for n in ("wide", "indicator", "embed", "continuous"))
    want = np.load(os.path.join(JAX_CKPTS, "wide_and_deep_pred.npy"))
    im = InferenceModel(device="cuda").load(os.path.join(JAX_CKPTS,
                                                       "wide_and_deep"))
    diff = float(np.abs(im.predict(xs) - want).max())
    log(f"the JAX package's Wide&Deep checkpoint on {card}: predict within "
        f"{diff:.3g} of JAX's (atol {CKPT_JAX_ATOL})")
    if diff > CKPT_JAX_ATOL:
        raise AssertionError(f"phase 12(f): {diff}")
    return dict(max_abs_diff=diff)


def phase_zoo(torch, np, eb, card):
    """Phase 12 (a)-(f); the directory it writes is removed after."""
    import shutil
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    os.makedirs(ZOO_DIR)
    try:
        return dict(widedeep=phase_widedeep(torch, np, eb, card),
                    session=phase_session(torch, np, card),
                    anomaly=phase_anomaly(torch, np, card),
                    seq2seq=phase_seq2seq_fit(torch, np, card),
                    regularized=phase_regularized(torch, np, card),
                    jax_widedeep=zoo_jax_wide_and_deep(np, card))
    finally:
        shutil.rmtree(ZOO_DIR, ignore_errors=True)


def tcn_bench_data(np):
    """bench.py's measure_tcn batch: default_rng(2), x then y."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((TCN_BATCH, TCN_LOOKBACK, TCN_FEATURES)
                            ).astype(np.float32)
    y = rng.standard_normal((TCN_BATCH, 1)).astype(np.float32)
    return x, y


def tcn_estimator(dropout=0.2, dtype=None, device=None):
    """measure_tcn's model, weights from the numpy seed, through
    Estimator.from_torch with Adam and mse."""
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.zouwu.model.nets import TemporalConvNet
    net = TemporalConvNet(TCN_FEATURES, dropout=dropout, dtype=dtype, **TCN)
    seeded_weights(net, SEED)
    return Estimator.from_torch(model=net, loss="mse", optimizer="adam",
                                device=device)


def tcn_window(torch, est, x, y) -> float:
    """ms a step as bench.py's _measure_step_time takes it: the batch on
    the card once, TCN_WARMUP steps, then TCN_TIMED steps on the host clock
    between two syncs."""
    xs, ys = est._tensors(x), est._tensors(y)
    for _ in range(TCN_WARMUP):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TCN_TIMED):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / TCN_TIMED * 1e3


def tcn_windows(torch, np, precisions, x, y):
    """(b): ms a step, steps/s and samples/s in each of ``precisions``
    (name -> compute dtype), under the context's current flags."""
    out = {}
    for name, dtype in precisions.items():
        ms = tcn_window(torch, tcn_estimator(dtype=dtype), x, y)
        out[name] = dict(step_ms=ms, tcn_steps_per_sec=1e3 / ms,
                         tcn_samples_per_sec=TCN_BATCH * 1e3 / ms,
                         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                         matmul_precision=torch.get_float32_matmul_precision())
        log(f"  TCN {name}: {ms:.3f} ms a step, tcn_steps_per_sec "
            f"{out[name]['tcn_steps_per_sec']:.1f}, tcn_samples_per_sec "
            f"{out[name]['tcn_samples_per_sec']:.1f} ({TCN_TIMED} steps "
            f"after {TCN_WARMUP}, batch {TCN_BATCH}, host clock; matmul "
            f"{out[name]['matmul_precision']}, cudnn TF32 "
            f"{out[name]['cudnn_allow_tf32']})")
    return out


def tcn_card_cpu(torch, np, x, y, card):
    """(c): one Adam step at dropout 0 on the card and on the CPU from the
    same weights and batch, then one batch's gradients."""
    steps = {}
    for dev in ("cpu", "cuda"):
        est = tcn_estimator(dropout=0.0, device=dev)
        loss = float(est._train_step(x, y))
        steps[dev] = (loss, {n: p.detach().cpu().numpy()
                             for n, p in est.model.named_parameters()})
    (l_cpu, p_cpu), (l_card, p_card) = steps["cpu"], steps["cuda"]
    worst = max(float(np.abs(p_card[k] - p_cpu[k]).max()) for k in p_cpu)
    rep = dict(loss_card=l_card, loss_cpu=l_cpu,
               loss_diff=abs(l_card - l_cpu), max_param_diff=worst)
    log(f"  TCN step on {card} vs the CPU (dropout 0, fp32, TF32 off): "
        f"loss {l_card:.7f} vs {l_cpu:.7f} (|diff| {rep['loss_diff']:.3g}, "
        f"atol {TCN_STEP_LOSS_ATOL}); parameters within {worst:.3g} (atol "
        f"{TCN_STEP_PARAM_ATOL})")
    if rep["loss_diff"] > TCN_STEP_LOSS_ATOL or worst > TCN_STEP_PARAM_ATOL:
        raise AssertionError(f"phase 13(c) step: {rep}")
    grads = {}
    for dev in ("cpu", "cuda"):
        est = tcn_estimator(dropout=0.0, device=dev)
        _, g = est._loss_and_grads(x, y)
        grads[dev] = {n: t.cpu().numpy() for n, t in zip(est._names, g)}
    rel = {}
    for n, want in grads["cpu"].items():
        scale = float(np.abs(want).max())
        diff = float(np.abs(grads["cuda"][n] - want).max())
        rel[n] = diff / scale if scale > 0 else diff
    leaf = max(rel, key=rel.get)
    rep.update(grad_max_rel_diff=rel[leaf], grad_worst_leaf=leaf,
               grad_leaves=len(rel))
    log(f"  TCN gradients on the card vs the CPU: each of {len(rel)} leaves "
        f"within {rel[leaf]:.3g} of its largest |gradient| (worst {leaf}; "
        f"limit {ZOO_GRAD_RTOL})")
    if rel[leaf] > ZOO_GRAD_RTOL:
        raise AssertionError(f"phase 13(c) gradients: {rel}")
    return rep


def tcn_stream_data(np):
    """(d)'s windows: the CPU tests' linear target of the last step."""
    rng = np.random.RandomState(SEED)
    x = rng.normal(size=(TCN_STREAM_ROWS, TCN_LOOKBACK, TCN_FEATURES)
                   ).astype(np.float32)
    return x, (x[:, -1:, 0] * 0.5 + 0.1).astype(np.float32)


def tcn_stream_fit(torch, np, x, y, card):
    """(d): TCNForecaster.fit through the streaming feed under DISK_4,
    every row once an epoch, the residency bound; then shuffle=False
    against DRAM, bitwise."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.data import (StreamingShardedDataset,
                                              XShards, to_sharded_dataset)
    from analytics_zoo_tpu_torch.zouwu.model import TCNForecaster
    OrcaContext.train_data_store = TCN_STREAM_TIER
    t0 = time.perf_counter()
    shards = XShards.partition({"x": x, "y": y},
                               num_shards=TCN_STREAM_SHARDS)
    spill_s = time.perf_counter() - t0
    ds = to_sharded_dataset(shards)
    if not isinstance(ds, StreamingShardedDataset):
        raise AssertionError(f"phase 13(d): {type(ds).__name__}")
    ds.prefetch(TCN_STREAM_PREFETCH)
    # C33: zeroed here, the gauge must read this feed's depth after the fit
    telemetry.get_registry().gauge(
        "zoo_data_prefetch_depth",
        "streaming-feed windows loading ahead of the device").set(0)
    gauge_before = telemetry.snapshot().get("zoo_data_prefetch_depth")
    seen = []
    feed = ds.iter_batches

    def recorded(*a, **kw):
        keys = []
        seen.append(keys)
        for bx, by, m in feed(*a, **kw):
            keys.append(bx[:, 0, 0].copy())
            yield bx, by, m
    ds.iter_batches = recorded
    f = TCNForecaster(**TCN)
    f.fit(ds, epochs=1, batch_size=TCN_BATCH)         # warm-up epoch
    steps = TCN_STREAM_EPOCHS * (TCN_STREAM_ROWS // TCN_BATCH)
    t0 = time.perf_counter()
    hist = f.fit(ds, epochs=TCN_STREAM_EPOCHS, batch_size=TCN_BATCH)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) / steps * 1e3
    want = np.sort(x[:, 0, 0])
    once = all(np.array_equal(np.sort(np.concatenate(k)), want)
               for k in seen)
    bound = TCN_STREAM_ROWS // TCN_STREAM_SHARDS * math.ceil(
        TCN_STREAM_SHARDS / int(TCN_STREAM_TIER.split("_")[1])) + TCN_BATCH
    # C33: the feed publishes its depth before its pool starts
    depth_gauge = telemetry.snapshot().get("zoo_data_prefetch_depth")
    rep = dict(fit_step_ms=fit_ms, fit_steps=steps, loss=hist["loss"],
               epochs_seen=len(seen), every_row_once=once,
               peak_window_rows=ds.peak_window_rows, bound_rows=bound,
               window_shards=ds.window_shards, spill_s=spill_s,
               prefetch_depth=ds.prefetch_depth,
               prefetch_depth_gauge_before=gauge_before,
               prefetch_depth_gauge=depth_gauge)
    log(f"  TCN streaming fit on {card}: {TCN_STREAM_ROWS} windows in "
        f"{TCN_STREAM_SHARDS} shards under {TCN_STREAM_TIER} (spilled in "
        f"{spill_s:.3f} s), {TCN_STREAM_EPOCHS} epochs of "
        f"{steps // TCN_STREAM_EPOCHS} steps after a warm-up epoch: "
        f"{fit_ms:.3f} ms a step (host clock, the feed included); loss "
        f"{hist['loss']}; every row once an epoch {once} ({len(seen)} "
        f"epochs); peak_window_rows {ds.peak_window_rows} (bound {bound}); "
        f"zoo_data_prefetch_depth {gauge_before} before the fit, "
        f"{depth_gauge} after (the feed's depth {ds.prefetch_depth})")
    if gauge_before != 0 or depth_gauge != ds.prefetch_depth or \
            ds.prefetch_depth != TCN_STREAM_PREFETCH:
        raise AssertionError(f"phase 13(d): zoo_data_prefetch_depth reads "
                             f"{gauge_before} before the fit and "
                             f"{depth_gauge} after, the feed's depth is "
                             f"{ds.prefetch_depth} (set "
                             f"{TCN_STREAM_PREFETCH})")
    if not once or ds.peak_window_rows > bound or \
            not np.isfinite(hist["loss"]).all() or \
            not hist["loss"][-1] < hist["loss"][0]:
        raise AssertionError(f"phase 13(d) fit: {rep}")
    # shuffle=False: the DISK_4 stream feeds the DRAM order, so the fits
    # end bitwise (cuDNN's deterministic algorithms for both, so that
    # only the feed could differ)
    ends = {}
    torch.backends.cudnn.deterministic = True
    try:
        for tier in ("DRAM", TCN_STREAM_TIER):
            OrcaContext.train_data_store = tier
            g = TCNForecaster(**TCN)
            g.fit(XShards.partition({"x": x, "y": y},
                                    num_shards=TCN_STREAM_SHARDS),
                  epochs=TCN_STREAM_EPOCHS, batch_size=TCN_BATCH,
                  shuffle=False)
            ends[tier] = [p.detach().clone()
                          for p in g._est.model.parameters()]
    finally:
        torch.backends.cudnn.deterministic = False
        OrcaContext.train_data_store = "DRAM"
    rep["disk_equals_dram"] = all(torch.equal(a, b) for a, b in zip(
        ends["DRAM"], ends[TCN_STREAM_TIER]))
    log(f"  shuffle=False: the {TCN_STREAM_TIER} fit ends bitwise where the "
        f"DRAM fit ends: {rep['disk_equals_dram']}")
    if not rep["disk_equals_dram"]:
        raise AssertionError("phase 13(d): DISK_4 and DRAM fits differ")
    return f, rep


def forecaster_card_cpu(torch, np, make, horizon, what):
    """A short fit of a small forecaster on the card and on the CPU from
    the same seed and data: epoch losses within ZOO_LOSS_RTOL, every
    parameter within ZOO_PARAM_ATOL in all but ZOO_PARAM_SHARE of each
    leaf and within 2 lr a step everywhere (the CPU tests' limits)."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(FC_ROWS, FC_LOOKBACK, FC_FEATURES)).astype(
        np.float32)
    y = (x[:, -horizon:, 0] * 0.5 + 0.1).astype(np.float32)
    runs = {}
    for dev in ("cpu", "cuda"):
        f = make(dev)
        hist = f.fit(x, y, epochs=FC_EPOCHS, batch_size=FC_BATCH)
        runs[dev] = (hist["loss"], {n: p.detach().cpu().numpy() for n, p in
                                    f._est.model.named_parameters()})
    (l_cpu, p_cpu), (l_card, p_card) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    worst = max(float(np.abs(p_card[k] - p_cpu[k]).max()) for k in p_cpu)
    share = max(float(np.mean(np.abs(p_card[k] - p_cpu[k])
                              > ZOO_PARAM_ATOL)) for k in p_cpu)
    steps = FC_EPOCHS * (FC_ROWS // FC_BATCH)
    rep = dict(loss_max_rel_diff=loss_rel, max_param_diff=worst,
               share_past_atol=share)
    log(f"  {what}: a fit of {steps} steps on the card vs the CPU: losses "
        f"within {loss_rel:.3g} relative (rtol {ZOO_LOSS_RTOL}); parameters "
        f"within {worst:.3g} ({share:.2%} of a leaf past {ZOO_PARAM_ATOL})")
    if loss_rel > ZOO_LOSS_RTOL or share > ZOO_PARAM_SHARE or \
            worst > 2 * FC_LR * steps:
        raise AssertionError(f"phase 13(e) {what}: {rep}")
    return rep


def tcn_serve(torch, np, f, x, y, card):
    """(e): predict and evaluate after the streaming fit, against the CPU
    from the same checkpoint; save/restore on the card bitwise; the JAX
    package's TCN checkpoint; the LSTM and Seq2Seq forecasters."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.zouwu.model import (LSTMForecaster,
                                                     Seq2SeqForecaster,
                                                     TCNForecaster)
    rows = slice(0, 10 * TCN_BATCH)
    pred = f.predict(x[rows], batch_size=TCN_BATCH)
    ev = f.evaluate(x[rows], y[rows], metrics=("mse", "mae", "smape"),
                    batch_size=TCN_BATCH)
    path = os.path.join(TCN_DIR, "tcn")
    f.save(path)
    g = TCNForecaster(**TCN)
    g.restore(path, sample_x=x[:1])
    same = np.array_equal(g.predict(x[rows], batch_size=TCN_BATCH), pred) \
        and all(torch.equal(a, b) for a, b in zip(
            f._est.model.parameters(), g._est.model.parameters()))
    cpu = TCNForecaster(device="cpu", **TCN)
    cpu.restore(path, sample_x=x[:1])
    cpu_diff = float(np.abs(cpu.predict(x[rows], batch_size=TCN_BATCH)
                            - pred).max())
    ev_cpu = cpu.evaluate(x[rows], y[rows], metrics=tuple(ev),
                          batch_size=TCN_BATCH)
    ev_rel = max(abs(ev[m] - ev_cpu[m]) / abs(ev_cpu[m]) for m in ev)
    rep = dict(evaluate=ev, evaluate_cpu=ev_cpu, evaluate_max_rel_diff=ev_rel,
               restore_bitwise=bool(same), predict_max_abs_diff_cpu=cpu_diff)
    log(f"  TCN predict {len(pred)} rows on {card}: evaluate {ev} (the CPU "
        f"from the same checkpoint within {ev_rel:.3g} relative, rtol "
        f"{ZOO_LOSS_RTOL}); max |card - cpu| {cpu_diff:.3g} (atol "
        f"{ZOO_PRED_ATOL}); save -> restore -> predict bitwise {same}")
    if pred.shape != (len(pred), 1) or not np.isfinite(pred).all() or \
            not same or cpu_diff > ZOO_PRED_ATOL or ev_rel > ZOO_LOSS_RTOL:
        raise AssertionError(f"phase 13(e): {rep}")
    jx = np.load(os.path.join(JAX_CKPTS, "tcn_x.npy"))
    want = np.load(os.path.join(JAX_CKPTS, "tcn_pred.npy"))
    j = TCNForecaster(future_seq_len=2, num_channels=(8, 8), kernel_size=3)
    j.restore(os.path.join(JAX_CKPTS, "tcn"), sample_x=jx)
    rep["jax_tcn_max_abs_diff"] = float(np.abs(j.predict(jx) - want).max())
    log(f"  the JAX package's TCNForecaster checkpoint on {card}: predict "
        f"within {rep['jax_tcn_max_abs_diff']:.3g} of JAX's (atol "
        f"{CKPT_JAX_ATOL})")
    if rep["jax_tcn_max_abs_diff"] > CKPT_JAX_ATOL:
        raise AssertionError(f"phase 13(e) JAX TCN: {rep}")
    rep["lstm"] = forecaster_card_cpu(
        torch, np, lambda dev: LSTMForecaster(
            target_dim=1, lstm_units=(8,), dropouts=(0.0,),
            optimizer=Adam(FC_LR), device=dev), 1, "LSTMForecaster")
    rep["seq2seq"] = forecaster_card_cpu(
        torch, np, lambda dev: Seq2SeqForecaster(
            future_seq_len=3, latent_dim=8, dropout=0.0,
            optimizer=Adam(FC_LR), device=dev), 3, "Seq2SeqForecaster")
    return rep


def phase_tcn(torch, np, card):
    """Phase 13 (a)-(e); the directory it writes is removed after."""
    import shutil
    from analytics_zoo_tpu_torch import (OrcaContext, init_orca_context,
                                         stop_orca_context)
    from analytics_zoo_tpu_torch.learn import estimator
    shutil.rmtree(TCN_DIR, ignore_errors=True)
    os.makedirs(TCN_DIR)
    log_dir = estimator.DEFAULT_LOG_DIR
    estimator.DEFAULT_LOG_DIR = os.path.join(TCN_DIR, "logs")
    rep = {}
    try:
        # (a) the context, fp32 with TF32 off
        OrcaContext.default_matmul_precision = "float32"
        ctx = init_orca_context()
        rep["context"] = dict(
            devices=[str(d) for d in ctx.devices], mesh=repr(ctx.mesh),
            matmul_precision=torch.get_float32_matmul_precision(),
            matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
            cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
        log(f"Zouwu TCN on {card}: {ctx!r}; matmul TF32 "
            f"{rep['context']['matmul_allow_tf32']}, cudnn TF32 "
            f"{rep['context']['cudnn_allow_tf32']}")
        if ctx.num_devices != torch.cuda.device_count() or \
                rep["context"]["cudnn_allow_tf32"] or \
                rep["context"]["matmul_allow_tf32"]:
            raise AssertionError(f"phase 13(a): {rep['context']}")
        x, y = tcn_bench_data(np)
        rep["window"] = tcn_windows(torch, np, {"float32": None}, x, y)
        rep["card_cpu"] = tcn_card_cpu(torch, np, x, y, card)
        xs, ys = tcn_stream_data(np)
        f, rep["stream"] = tcn_stream_fit(torch, np, xs, ys, card)
        rep["serve"] = tcn_serve(torch, np, f, xs, ys, card)
        # (b) again under the context's default precision: TF32, and the
        # mixed_bfloat16 policy
        stop_orca_context()
        OrcaContext.default_matmul_precision = "bfloat16"
        init_orca_context()
        rep["window"].update(tcn_windows(
            torch, np, {"tf32": None, "mixed_bfloat16": torch.bfloat16},
            x, y))
        rep["window"]["fit_step_ms_streaming"] = rep["stream"]["fit_step_ms"]
        log(f"  the streaming fit's {rep['stream']['fit_step_ms']:.3f} ms a "
            f"step against the fp32 window's "
            f"{rep['window']['float32']['step_ms']:.3f}: the feed (spill "
            f"reads, unpickling, pageable copies) and the summaries")
    finally:
        stop_orca_context()
        OrcaContext.default_matmul_precision = "bfloat16"
        estimator.DEFAULT_LOG_DIR = log_dir
        shutil.rmtree(TCN_DIR, ignore_errors=True)
    return rep


# ---------------------------------------------------------------- phase 14

def trace_events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def steady_counts(events, after_step):
    """(host-to-device copies, kernels) on the card after the end of step
    ``after_step``'s range on the card, in a trace's events."""
    t0 = max((e["ts"] + e.get("dur", 0) for e in events
              if e.get("cat") == "gpu_user_annotation"
              and e.get("name") == f"zoo_step_{after_step}"), default=0.0)
    late = [e for e in events if e.get("ts", -1) >= t0]
    return (sum(1 for e in late if e.get("cat") == "gpu_memcpy"
                and "HtoD" in e.get("name", "")),
            sum(1 for e in late if e.get("cat") == "kernel"))


def loop_fit(torch, np, est, ds, mode, epochs=1, **kw):
    """One ``est.fit`` of ``ds`` in loop mode ``mode`` ("per_step",
    "staged", "cached"), shuffle off unless given; (its launches, host
    seconds after a sync)."""
    args = {"per_step": {}, "staged": {"steps_per_loop": NCF_LOOP},
            "cached": {"cache": "device"}}[mode]
    args.update(dict(shuffle=False), **kw)
    _, launches, dt = counted(torch, lambda: est.fit(
        ds, epochs=epochs, batch_size=BATCH, **args))
    return launches, dt


def phase_ncf_loops(torch, np, x, y, kind):
    """Phase 14(a): NCF at measure_ncf's configuration through
    ``fit(steps_per_loop=NCF_LOOP)`` and ``fit(cache="device")`` against
    the per-step fit: three epochs of NCF_STEPS steps each, shuffle off,
    bitwise equal in every parameter and step loss; the second epoch
    timed (the dataset object already on the card for the cached mode),
    the third profiled over 10 steps for the host-to-device copies a
    step; then a shuffled cached epoch visits every row once."""
    from analytics_zoo_tpu_torch.data import ShardedDataset
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.ops import _build
    ds = ShardedDataset(x, y)
    warm = ShardedDataset(x[:NCF_LOOP * BATCH], y[:NCF_LOOP * BATCH])

    def fresh():
        net = train_model("ncf")
        net.compile(optimizer=Adam(NCF_LR),
                    loss="sparse_categorical_crossentropy")
        return net.estimator

    modes = ("per_step", "staged", "cached")
    rep, ests, secs = {}, {}, {m: [] for m in modes}
    for mode in modes:
        loop_fit(torch, np, fresh(), warm, mode)          # warm up
        est = ests[mode] = fresh()
        _build.reset_launch_counts()
        launches, first_s = loop_fit(torch, np, est, ds, mode)
        rep[mode] = dict(
            first_epoch_ms_per_step=first_s / NCF_STEPS * 1e3,
            launches=launches,
            launches_per_step={k: v / NCF_STEPS for k, v in launches.items()
                               if v})
        for name in ("fused_embedding_lookup", "embedding_scatter_add"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"NCF {mode} fit launched no {name}: "
                                     f"{launches}")
    # timed epochs in turns (p s c, then c s p): the host-bound step moves
    # with its machine, so the modes are compared within one rotation
    for r in range(NCF_LOOP_ROUNDS):
        for mode in (modes if r % 2 == 0 else modes[::-1]):
            secs[mode].append(loop_fit(torch, np, ests[mode], ds, mode)[1])
    for mode in modes:
        est = ests[mode]
        dt = float(np.median(secs[mode]))
        est.set_tensorboard(os.path.join(PHASE14_DIR, "ncf"), mode)
        # the trace opens PROFILE_LEAD steps (a loop) before the 10 it
        # counts: a trace that restarts CUPTI kept attached (keep_cupti)
        # can miss its first activities
        lead = NCF_LOOP if mode == "staged" else PROFILE_LEAD
        base = est._py_step
        loop_fit(torch, np, est, ds, mode, profile_steps=(0, lead + 10))
        h2d, kernels = steady_counts(
            trace_events(est._profile_window.path), base + lead - 1)
        rep[mode].update(
            step_ms=dt / NCF_STEPS * 1e3, samples_per_s=NCF_TRAIN_ROWS / dt,
            epoch_ms_per_step=[t / NCF_STEPS * 1e3 for t in secs[mode]],
            h2d_copies_per_step=h2d / 10, kernels_per_step=kernels / 10)
        log(f"NCF fit {mode} on {kind}: {NCF_STEPS} steps of {BATCH} at "
            f"{rep[mode]['step_ms']:.3f} ms/step (host clock, median of "
            f"{NCF_LOOP_ROUNDS} epochs in turns: "
            f"{[round(v, 3) for v in rep[mode]['epoch_ms_per_step']]}), "
            f"{rep[mode]['samples_per_s']:.1f} samples/s (first epoch "
            f"{rep[mode]['first_epoch_ms_per_step']:.3f} ms/step); "
            f"host-to-device copies a step {h2d / 10:.2f}, kernels a step "
            f"{kernels / 10:.1f} (profiler, 10 steps); launches a step "
            f"{rep[mode]['launches_per_step']}")
    if rep["cached"]["h2d_copies_per_step"] != 0:
        raise AssertionError(f"the cached epoch copied to the card: "
                             f"{rep['cached']}")
    ref = ests["per_step"]
    for mode in ("staged", "cached"):
        est = ests[mode]
        same = est.step_losses == ref.step_losses and all(
            torch.equal(p, q) for p, q in zip(est.model.parameters(),
                                              ref.model.parameters()))
        rep[mode]["bitwise_per_step"] = same
        epochs = 2 + NCF_LOOP_ROUNDS
        if not same or est._py_step != epochs * NCF_STEPS:
            raise AssertionError(f"NCF {mode} fit differs from the per-step "
                                 f"fit after {est._py_step} steps")
    log(f"  staged and cached fits bitwise the per-step fit after "
        f"{epochs * NCF_STEPS} steps (parameters, step losses)")
    # a shuffled cached epoch: the order drawn on the card covers every row
    est = fresh()
    orders = []
    real = est._device_order
    est._device_order = lambda n, sh: orders.append(real(n, sh)) or \
        orders[-1]
    _, shuffled_s = loop_fit(torch, np, est, ds, "cached", shuffle=True)
    order = orders[0]
    every = bool(torch.equal(order.sort().values,
                             torch.arange(len(x), device=order.device)))
    rep["cached_shuffled"] = dict(
        step_ms=shuffled_s / NCF_STEPS * 1e3,
        samples_per_s=NCF_TRAIN_ROWS / shuffled_s, every_row_once=every,
        loss=est.step_losses[-1])
    log(f"  a shuffled cached epoch: every row once {every}; "
        f"{rep['cached_shuffled']['step_ms']:.3f} ms/step; bench.py's "
        f"staged {rep['staged']['samples_per_s']:.1f} and cached "
        f"{rep['cached']['samples_per_s']:.1f} samples/s against the "
        f"per-step fit's {rep['per_step']['samples_per_s']:.1f}")
    if not every or NCF_TRAIN_ROWS % BATCH or \
            not np.isfinite(est.step_losses).all():
        raise AssertionError(f"shuffled cached epoch: {rep}")
    return rep


def phase_optimizers(torch, np, x, y, card):
    """Phase 14(b): each of the eight optimizers, OPT_STEPS steps of NCF on
    the card: its updates replayed on the CPU from the same parameters
    and the card's gradients (every parameter within NCF_STEP_PARAM_ATOL;
    for L-BFGS the last update, taken from the card's state before it),
    and the fit against the CPU's fit (every step's loss and every
    parameter within NCF_STEP_*_ATOL; the AMPLIFYING ones' losses within
    AMPLIFIED_LOSS_ATOL); a LAMB checkpoint written and read back
    bitwise."""
    import shutil
    from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
    from analytics_zoo_tpu_torch.learn import optimizers as opt_lib
    rows = OPT_STEPS * BATCH
    rep = {}
    for name, cls, kw in OPTIMIZER_ARGS:
        nets, secs = {}, {}
        for dev in ("cpu", "cuda"):
            net = train_model("ncf")
            net.compile(optimizer=getattr(opt_lib, cls)(**kw),
                        loss="sparse_categorical_crossentropy", device=dev)
            if dev == "cuda":
                start, grads, last = record_updates(net.estimator,
                                                    OPT_STEPS - 1)
            t0 = time.perf_counter()
            net.fit(x[:rows], y[:rows], batch_size=BATCH, nb_epoch=1,
                    shuffle=False)
            secs[dev] = time.perf_counter() - t0
            nets[dev] = net
        # the card's updates again on the CPU: all of them from the same
        # parameters with the card's gradients, and the last one from the
        # card's own parameters and state before it
        card_params = [p.detach().cpu()
                       for p in nets["cuda"].estimator._params]
        replay = getattr(opt_lib, cls)(**kw)
        params = [p.clone() for p in start]
        state = {"count": 0, **replay.init(params)}
        for g in grads:
            replay.step(params, g, state, state["count"])
            state["count"] += 1
        update_diff = max(float((p - q).abs().max())
                          for p, q in zip(params, card_params))
        params, state = last
        replay.step(params, grads[-1], state, state["count"])
        last_diff = max(float((p - q).abs().max())
                        for p, q in zip(params, card_params))
        lc = np.asarray(nets["cpu"].estimator.step_losses)
        lg = np.asarray(nets["cuda"].estimator.step_losses)
        wc, wg = nets["cpu"].get_weights(), nets["cuda"].get_weights()
        loss_diff = float(np.abs(lc - lg).max())
        per_leaf = {k: float(np.abs(wc[k] - wg[k]).max()) for k in wc}
        worst = max(per_leaf, key=per_leaf.get)
        amplifies = name in AMPLIFYING
        rep[name] = dict(loss_first=float(lg[0]), loss_last=float(lg[-1]),
                         update_max_diff=update_diff,
                         last_update_max_diff=last_diff,
                         max_loss_diff=loss_diff,
                         max_param_diff=per_leaf[worst], worst_leaf=worst,
                         amplifies=amplifies,
                         card_ms_per_step=secs["cuda"] / OPT_STEPS * 1e3)
        held = (f"{AMPLIFIED_LOSS_ATOL} in the loss alone: its trajectory "
                f"amplifies rounding" if amplifies else
                f"{NCF_STEP_LOSS_ATOL}, {NCF_STEP_PARAM_ATOL}")
        log(f"  {name}: {OPT_STEPS} NCF steps on {card}: loss {lg[0]:.5f} "
            f"-> {lg[-1]:.5f}, {rep[name]['card_ms_per_step']:.3f} ms/step;"
            f" its updates replayed on the CPU within {update_diff:.3g}, "
            f"the last from the card's state within {last_diff:.3g} (atol "
            f"{NCF_STEP_PARAM_ATOL}{' for the last' * (name == 'lbfgs')}); "
            f"the CPU's fit: every step's loss within {loss_diff:.3g}, "
            f"every parameter within {per_leaf[worst]:.3g} (worst {worst}; "
            f"atol {held})")
        fit_ok = (loss_diff <= AMPLIFIED_LOSS_ATOL if amplifies else
                  loss_diff <= NCF_STEP_LOSS_ATOL
                  and per_leaf[worst] <= NCF_STEP_PARAM_ATOL)
        replay_ok = last_diff <= NCF_STEP_PARAM_ATOL and (
            name == "lbfgs" or update_diff <= NCF_STEP_PARAM_ATOL)
        if not (np.isfinite(lg).all() and replay_ok and fit_ok):
            raise AssertionError(f"optimizer {name}: card vs CPU "
                                 f"{rep[name]}")
        if name == "lamb":
            est = nets["cuda"].estimator
            path = os.path.join(PHASE14_DIR, "lamb")
            shutil.rmtree(path, ignore_errors=True)
            est.save(path)
            back = train_model("ncf")
            back.compile(optimizer=opt_lib.LAMB(),
                         loss="sparse_categorical_crossentropy")
            back.estimator.load(path)
            got = back.estimator
            found = ckpt.find_latest_checkpoint(path)
            with open(os.path.join(found[0], "state.msgpack"), "rb") as fh:
                data = fh.read()
            same = (got._py_step == est._py_step
                    and got._opt_state["count"] == est._opt_state["count"]
                    and all(torch.equal(p, q) for p, q in zip(
                        got.model.parameters(), est.model.parameters()))
                    and all(torch.equal(p, q) for k in ("mu", "nu")
                            for p, q in zip(got._opt_state[k],
                                            est._opt_state[k]))
                    and ckpt.to_bytes(got._state_tree()) == data)
            rep[name]["checkpoint_bitwise"] = same
            rep[name]["checkpoint_mb"] = len(data) / 1e6
            log(f"  lamb checkpoint ({len(data) / 1e6:.1f} MB) read back "
                f"bitwise: {same}")
            if not same:
                raise AssertionError("the LAMB checkpoint did not read back "
                                     "bitwise")
    return rep


def host_copy(tree):
    """A host copy of an optimizer state (dicts, lists, tensors, ints)."""
    import torch
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def record_updates(est, last_count):
    """Wrap ``est.optimizer.step`` to keep (host copies) the parameters
    before the first update, every update's gradients, and the parameters
    and optimizer state before update ``last_count``; returns (the
    parameters, the gradient lists, that [parameters, state]), filled as
    the fit runs. The flop count's update, on copies of the parameters,
    is not the fit's and is not kept."""
    start, grads, last = [], [], []
    real = est.optimizer.step

    def step(params, g, state, count):
        if params[0] is not est._params[0]:
            return real(params, g, state, count)
        if not start:
            start.extend(p.detach().cpu().clone() for p in params)
        grads.append([t.detach().cpu().clone() for t in g])
        if count == last_count:
            last.extend((host_copy(list(params)), host_copy(state)))
        return real(params, g, state, count)

    est.optimizer.step = step
    return start, grads, last


def bert_task_inputs(np, rng, n, length, task):
    """Token ids, segments, ragged input masks (at least a quarter of the
    row) and labels: NER's tags, SQuAD's start <= end inside the mask."""
    ids = rng.randint(0, BERT_VOCAB, (n, length)).astype(np.int32)
    lens = rng.randint(length // 4, length + 1, (n, 1))
    pos = np.arange(length)[None]
    mask = (pos < lens).astype(np.int32)
    seg = ((pos >= rng.randint(1, length // 4, (n, 1))) & (pos < lens)
           ).astype(np.int32)
    if task == "ner":
        labels = rng.randint(0, NER_ENTITIES, (n, length)).astype(np.int32)
    else:
        a = rng.randint(0, lens[:, 0])
        b = np.minimum(a + rng.randint(0, 30, n), lens[:, 0] - 1)
        labels = np.stack([a, b], 1).astype(np.int32)
    return ids, seg, mask, labels


def task_estimator(task, config, dev, optimizer):
    from analytics_zoo_tpu_torch.text import BERTNER, BERTSQuAD
    if task == "ner":
        return BERTNER(NER_ENTITIES, config=config, seq_len=NER_LEN,
                       optimizer=optimizer, seed=SEED, device=dev)
    return BERTSQuAD(config=config, seq_len=SQUAD_LEN, optimizer=optimizer,
                     seed=SEED, device=dev)


def zero_grad_reading(grads_cpu, grads_card, flat_leaves=()):
    """(largest |card - cpu| over each leaf's largest |cpu| gradient, the
    leaf): the attention key biases and ``flat_leaves`` (SQuAD's qa bias
    and the last norm's bias, which shift every position's logit alike),
    whose gradients are zero in exact arithmetic (softmax ignores a
    shift), are held against the model's largest gradient instead."""
    top = max(float(g.abs().max()) for g in grads_cpu.values())
    rel = {}
    for n, want in grads_cpu.items():
        flat = n.endswith("attention.key.bias") or n in flat_leaves
        scale = top if flat else float(want.abs().max())
        rel[n] = float((grads_card[n].cpu() - want).abs().max()) / max(
            scale, 1e-30)
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def phase_bert_tasks(torch, np, card):
    """Phase 14(d): BERTNER (32 x 128, 9 tags) and BERTSQuAD (12 x 384,
    AdamWeightDecay), ragged masks: one batch's loss and gradients at full
    width with TASK_CPU_BLOCKS blocks on the card against the CPU, each
    leaf within ZOO_GRAD_RTOL (SQuAD: SQUAD_GRAD_RTOL) of its largest; a
    TASK_STEPS-step fit at
    full depth, dropout 0.1 (SQuAD with remat off and on: peak memory and
    ms a step)."""
    from analytics_zoo_tpu_torch.learn.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.text import BertConfig
    rep = {}
    rng = np.random.RandomState(SEED + 14)
    for task, batch, length in (("ner", NER_BATCH, NER_LEN),
                                ("squad", SQUAD_BATCH, SQUAD_LEN)):
        ids, seg, mask, labels = bert_task_inputs(
            np, rng, batch * TASK_STEPS, length, task)

        def optimizer():
            return "adam" if task == "ner" else AdamWeightDecay(3e-5)
        one = {}
        for dev in ("cpu", "cuda"):
            cfg = BertConfig(n_block=TASK_CPU_BLOCKS, hidden_drop=0.0,
                             attn_drop=0.0)
            t = task_estimator(task, cfg, dev, optimizer())
            y = t._masked(labels[:batch], mask[:batch]) if task == "ner" \
                else labels[:batch]
            loss, grads = t.estimator._loss_and_grads(
                (ids[:batch], seg[:batch], mask[:batch]), y)
            one[dev] = (float(loss), {n: g.detach().float().cpu() for n, g
                                      in zip(t.estimator._names, grads)})
            del t
        flat = () if task == "ner" else (
            "qa.bias", f"bert.block_{TASK_CPU_BLOCKS - 1}.ffn_norm.bias")
        rel, worst = zero_grad_reading(one["cpu"][1], one["cuda"][1], flat)
        loss_diff = abs(one["cpu"][0] - one["cuda"][0])
        rep[task] = dict(loss_cpu=one["cpu"][0], loss_card=one["cuda"][0],
                         loss_diff=loss_diff, grad_max_rel_diff=rel,
                         grad_worst_leaf=worst)
        log(f"BERT {task} ({batch} x {length}, {TASK_CPU_BLOCKS} blocks) "
            f"one batch on {card} vs the CPU: loss {one['cuda'][0]:.6f} vs "
            f"{one['cpu'][0]:.6f}; every gradient within {rel:.3g} of its "
            f"largest (worst {worst}; limit "
            f"{ZOO_GRAD_RTOL if task == 'ner' else SQUAD_GRAD_RTOL})")
        limit = ZOO_GRAD_RTOL if task == "ner" else SQUAD_GRAD_RTOL
        if loss_diff > NCF_STEP_LOSS_ATOL or rel > limit:
            raise AssertionError(f"BERT {task} card vs CPU: {rep[task]}")
        del one
        for remat in ((False, True) if task == "squad" else (False,)):
            t = task_estimator(task, BertConfig(remat=remat), "cuda",
                               optimizer())
            t.fit(ids[:batch], labels[:batch], token_type_ids=seg[:batch],
                  input_mask=mask[:batch], epochs=1, batch_size=batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            hist, launches, dt = counted(torch, lambda: t.fit(
                ids, labels, token_type_ids=seg, input_mask=mask, epochs=1,
                batch_size=batch))
            losses = t.estimator.step_losses[-TASK_STEPS:]
            pred = t.predict(ids[:batch], seg[:batch], mask[:batch],
                             batch_size=batch)
            key = f"fit_remat_{remat}".lower()
            rep[task][key] = dict(
                step_ms=dt / TASK_STEPS * 1e3,
                samples_per_s=TASK_STEPS * batch / dt,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                first_loss=losses[0], last_loss=losses[-1],
                launches=launches)
            log(f"  {task} fit, 12 blocks, remat {remat}: {TASK_STEPS} steps "
                f"at {rep[task][key]['step_ms']:.3f} ms/step, peak "
                f"{rep[task][key]['peak_memory_gb']:.2f} GB; loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches}")
            shapes = ([(batch, length, NER_ENTITIES)] if task == "ner"
                      else [(batch, length)] * 2)
            outs = pred if isinstance(pred, tuple) else (pred,)
            if not np.isfinite(losses).all() or [o.shape for o in outs] \
                    != shapes or not all(np.isfinite(o).all() for o in outs):
                raise AssertionError(f"BERT {task} fit/predict: {losses}")
            del t
    return rep


def phase_bert_remat(torch, np, state, Estimator, kind):
    """Phase 14(c): bench.py's measure_bert classifier (token ids alone,
    dropout 0.1, use_flash=True): one step with remat against one without
    from the same weights and step seed (fp32 with TF32 off, bf16) within
    phase 8's limits; a remat fit whose steps launch the flash forward 24
    times and each backward kernel 12; peak memory and ms a step with
    remat off and on at BERT_SWEEP batches (bf16); the steps_per_loop =
    BERT_SCAN_STEPS sweep (bf16); one LAMB fit."""
    from analytics_zoo_tpu_torch.learn.optimizers import LAMB
    from analytics_zoo_tpu_torch.ops import _build
    loss_name = "sparse_categorical_crossentropy_logits"

    def make(dtype, remat, optimizer="adam"):
        return Estimator.from_torch(
            model=bert_classifier(state, use_flash=True, dtype=dtype,
                                  remat=remat),
            loss=loss_name, optimizer=optimizer, seed=SEED)

    rep = {"step": {}}
    ids, labels = train_inputs(np.random.RandomState(SEED + 2),
                               max(BERT_SWEEP) * 2 * BERT_SCAN_STEPS)
    b0 = (ids[:TRAIN_BATCH], labels[:TRAIN_BATCH])
    for label, dtype, loss_atol, rtol in (
            ("fp32", None, TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL),
            ("bf16", torch.bfloat16, TRAIN_BF16_LOSS_ATOL,
             TRAIN_BF16_GRAD_RTOL)):
        out = {}
        for remat in (False, True):
            est = make(dtype, remat)
            loss, grads = est._loss_and_grads(*b0)
            out[remat] = (float(loss), dict(zip(est._names, grads)))
            del est
        rel, worst = grad_reading(out[True][1], out[False][1])
        diff = abs(out[True][0] - out[False][0])
        rep["step"][label] = dict(loss=out[False][0], loss_remat=out[True][0],
                                  loss_diff=diff, max_rel_grad_diff=rel,
                                  worst_param=worst)
        log(f"BERT-Base step {label}, remat vs not (dropout 0.1, one step "
            f"seed): loss {out[True][0]:.6f} vs {out[False][0]:.6f} "
            f"(|diff| {diff:.3g}, atol {loss_atol}); gradients within "
            f"{rel:.3g} of their scale (limit {rtol}; worst {worst})")
        if not (np.isfinite(out[True][0]) and diff <= loss_atol
                and rel <= rtol):
            raise AssertionError(f"remat {label} step: {rep['step'][label]}")
        del out
    # the remat path: a fit whose steps recompute every block's forward
    est = make(torch.bfloat16, True)
    est.fit(b0, epochs=1, batch_size=TRAIN_BATCH)              # warm up
    torch.cuda.synchronize()
    rows = (ids[:TRAIN_BATCH * TRAIN_STEPS], labels[:TRAIN_BATCH *
                                                   TRAIN_STEPS])
    _build.reset_launch_counts()
    _, launches, dt = counted(torch, lambda: est.fit(
        rows, epochs=1, batch_size=TRAIN_BATCH))
    rep["remat_fit"] = dict(step_ms=dt / TRAIN_STEPS * 1e3,
                            launches=launches,
                            losses=est.step_losses[-TRAIN_STEPS:])
    log(f"  remat fit bf16 {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_LEN}:"
        f" {rep['remat_fit']['step_ms']:.3f} ms/step; launches {launches}")
    want = {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 12,
            "flash_attention_bwd_dkv": 12}
    for name, n in want.items():
        if launches.get(name) != n * TRAIN_STEPS:
            raise AssertionError(f"remat fit: {name} launched "
                                 f"{launches.get(name)} times in "
                                 f"{TRAIN_STEPS} steps, not {n} a step")
    if not np.isfinite(rep["remat_fit"]["losses"]).all():
        raise AssertionError(f"remat fit losses: {rep['remat_fit']}")
    del est
    # peak memory and ms a step, remat off and on, bf16; a fresh estimator
    # each: one reused across the batch sizes carries what the earlier
    # sizes left resident into the peak
    rep["memory"] = {}
    for b in BERT_SWEEP:
        for remat in (False, True):
            est = make(torch.bfloat16, remat)
            xs, ys = est._tensors(ids[:b]), est._tensors(labels[:b])
            est._train_step(xs, ys)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(MEM_STEPS):
                est._train_step(xs, ys)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / MEM_STEPS * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            rep["memory"][f"{b}_remat_{remat}".lower()] = dict(
                step_ms=ms, peak_memory_gb=peak)
            log(f"  bf16 batch {b} remat {remat}: peak {peak:.3f} GB, "
                f"{ms:.3f} ms/step")
            del est, xs, ys
    # the scan sweep: fit(steps_per_loop=BERT_SCAN_STEPS), bf16, one
    # estimator; a loop at each batch size warms it, the next is timed
    rep["scan"] = {}
    est = make(torch.bfloat16, False)
    k = BERT_SCAN_STEPS
    for b in BERT_SWEEP:
        est.fit((ids[:k * b], labels[:k * b]), epochs=1, batch_size=b,
                steps_per_loop=k)                            # warm up
        torch.cuda.synchronize()
        _, _, dt = counted(torch, lambda: est.fit(
            (ids[k * b:2 * k * b], labels[k * b:2 * k * b]), epochs=1,
            batch_size=b, steps_per_loop=k))
        rep["scan"][str(b)] = dict(step_ms=dt / k * 1e3,
                                   samples_per_s=k * b / dt)
        log(f"  steps_per_loop={k} bf16 batch {b}: "
            f"{rep['scan'][str(b)]['step_ms']:.3f} ms/step, "
            f"{rep['scan'][str(b)]['samples_per_s']:.1f} samples/s")
    del est
    est = make(torch.bfloat16, False, LAMB(1e-4))
    est.fit(b0, epochs=1, batch_size=TRAIN_BATCH)
    _, _, dt = counted(torch, lambda: est.fit(rows, epochs=1,
                                              batch_size=TRAIN_BATCH))
    losses = est.step_losses[-TRAIN_STEPS:]
    rep["lamb"] = dict(step_ms=dt / TRAIN_STEPS * 1e3, losses=losses)
    log(f"  LAMB fit bf16 at {TRAIN_BATCH}: {rep['lamb']['step_ms']:.3f} "
        f"ms/step; losses {[round(v, 4) for v in losses]}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"LAMB fit losses: {losses}")
    del est
    return rep


def phase_profile(torch, np, x, y, card):
    """Phase 14(e): an NCF fit with ``profile_steps=PROFILE_STEPS`` writes
    a trace holding exactly those steps' ranges, and its kernels run
    inside them on the card."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    net = train_model("ncf")
    net.compile(optimizer=Adam(NCF_LR),
                loss="sparse_categorical_crossentropy")
    net.set_tensorboard(os.path.join(PHASE14_DIR, "profile"), "ncf")
    n = (PROFILE_STEPS[1] + 2) * BATCH
    net.fit(x[:n], y[:n], batch_size=BATCH, nb_epoch=1,
            profile_steps=PROFILE_STEPS)
    path = net.estimator._profile_window.path
    events = trace_events(path)
    want = [f"zoo_step_{i}" for i in range(*PROFILE_STEPS)]
    cpu = sorted({e["name"] for e in events if e.get("cat") ==
                  "user_annotation" and e["name"].startswith("zoo_step_")})
    gpu = [e for e in events if e.get("cat") == "gpu_user_annotation"
           and e.get("name", "").startswith("zoo_step_")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    lo = min((e["ts"] for e in gpu), default=0.0)
    hi = max((e["ts"] + e.get("dur", 0) for e in gpu), default=0.0)
    outside = [e["name"] for e in kernels
               if not lo <= e["ts"] <= hi]
    rep = dict(trace=os.path.relpath(path), steps=cpu,
               gpu_steps=sorted({e["name"] for e in gpu}),
               kernels=len(kernels), kernels_outside=len(outside))
    log(f"profile window {PROFILE_STEPS} on {card}: {os.path.basename(path)}"
        f" holds {cpu} ({len(kernels)} kernels, {len(outside)} outside the "
        f"steps' ranges on the card)")
    if cpu != want or rep["gpu_steps"] != want or not kernels or outside:
        raise AssertionError(f"profile window: {rep}; outside {outside[:5]}")
    return rep


# ------------------------------------------------------------- phase 15

def p15_env(**knobs):
    """Set serving knobs (environment variables read at engine
    construction); returns a function that restores them."""
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update({k: str(v) for k, v in knobs.items()})

    def restore():
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return restore


def p15_results(client, uris):
    """{uri: the result hash's payload or None}: one pipelined read."""
    uris = list(uris)
    return dict(zip(uris, client.pipeline(("HGET", "result", u)
                                          for u in uris)))


def p15_arrivals(client, uris, timeout: float = 120.0):
    """Poll the result hash through a BrokerClient until every uri has a
    payload: ({uri: payload}, {uri: perf_counter time first seen})."""
    got, seen = {}, {}
    pending = list(uris)
    deadline = time.perf_counter() + timeout
    while pending and time.perf_counter() < deadline:
        raw = p15_results(client, pending)
        now = time.perf_counter()
        for u, v in raw.items():
            if v is not None:
                got[u], seen[u] = v, now
        pending = [u for u in pending if u not in got]
        if pending:
            time.sleep(0.0005)
    if pending:
        raise AssertionError(f"{len(pending)} records never answered, "
                             f"e.g. {pending[:3]}")
    return got, seen


def p15_same_as_some_rung(np, got, refs, i) -> bool:
    """Served ``got`` equals, bit for bit, row ``i`` of the predict at one
    of the ladder's rungs (a product's row count picks cuBLAS's kernel,
    so the reference is the predict at the batch the record rode)."""
    return any(np.array_equal(got, ref[i]) for ref in refs.values())


def p15_native_protocol(Broker, ShedError):
    """15(a): the port's native broker, built from its own source."""
    from analytics_zoo_tpu_torch.serving import broker as broker_mod
    t0 = time.perf_counter()
    binary = broker_mod.build_native_broker()
    build_s = time.perf_counter() - t0
    lanes = "interactive,default,batch"
    with Broker.launch(backend="native") as b:
        if b.backend != "native":
            raise AssertionError(f"15(a): backend {b.backend}")
        c = b.client()
        ok = c.ping()
        for payload, lane in (("YjA=", "batch"), ("ZDA=", "default"),
                              ("aTA=", "interactive"), ("YjE=", "batch")):
            c.xadd("s", payload, lane=lane)
        read = c.xreadgroup("g", "dead", "s", 10, lanes=lanes)
        claimed = c.xclaim("s", "g", "live", 0, 10, lanes=lanes)
        detail = c.xpending_detail("s", "g")
        c.xshed_set("s", "batch", True)
        shed = c.xshed("s")
        try:
            c.xadd("s", "YQ==", lane="batch")
            refused = False
        except ShedError:
            refused = True
        c.xadd("s", "Yg==", lane="interactive")
        c.xshed_set("s", "batch", False)
        for eid, _, _ in claimed:
            c.xack("s", "g", eid)
        c.close()
    order = [p for _, _, p in read]
    if not (ok and order == ["aTA=", "ZDA=", "YjA=", "YjE="]
            and [p for _, _, p in claimed] == order
            and detail == {"live": 4} and shed == ["batch"] and refused):
        raise AssertionError(f"15(a) native protocol: {order}, {claimed}, "
                             f"{detail}, {shed}, {refused}")
    log(f"phase 15(a): native broker {binary.name} (build {build_s:.2f} s "
        f"or reused): lanes, XCLAIM, XSHED and XPENDING DETAIL held")
    return dict(binary=binary.name, build_s=build_s)


def p15_lane_burst(np, api, im, backend, x, refs, tag, frontend=None):
    """One mixed burst (3 batch : 1 interactive, interleaved) and
    P15_SINGLE single requests through ``backend``'s broker and a fresh
    engine; every result equals predict's bits at some rung. With
    ``frontend(broker, engine)`` the HTTP checks run on this engine."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import schema
    Broker, ClusterServing, InputQueue, OutputQueue = api
    stream = f"p15_{tag}"
    rep = {"backend": backend}
    with Broker.launch(backend=backend) as b:
        if b.backend != backend:
            raise AssertionError(f"15(b): backend {b.backend}")
        with ClusterServing(im, b.port, batch_size=P15_NCF_BATCH,
                            max_batch_size=P15_NCF_MAX_BATCH,
                            stream=stream) as eng:
            eng.wait_warm(timeout=120)
            _build.reset_launch_counts()
            iq = InputQueue(port=b.port, stream=stream)
            oq = OutputQueue(port=b.port)
            lane_of, row_of = {}, {}
            t0 = time.perf_counter()
            for j in range(P15_LANE_ROUNDS):
                rows = range(4 * j, 4 * j + 3)
                iq.enqueue_batch(((f"{tag}b{k}", {"x": x[k]})
                                  for k in rows), priority="batch")
                k = 4 * j + 3
                iq.enqueue(f"{tag}i{k}", priority="interactive", x=x[k])
                lane_of.update({f"{tag}b{r}": "batch" for r in rows})
                lane_of[f"{tag}i{k}"] = "interactive"
                row_of.update({f"{tag}b{r}": r for r in rows})
                row_of[f"{tag}i{k}"] = k
            c = b.client()
            got, seen = p15_arrivals(c, list(lane_of))
            c.close()
            singles = []
            n0 = 4 * P15_LANE_ROUNDS
            for k in range(P15_SINGLE):
                t1 = time.perf_counter()
                u = iq.enqueue(f"{tag}s{k}", x=x[n0 + k])
                got[u] = schema.encode_result(
                    oq.query(u, timeout=30, poll_interval=0.0005))
                singles.append(time.perf_counter() - t1)
                row_of[u] = n0 + k
            if frontend is not None:
                rep["frontend"] = frontend(b, eng, stream)
            m = eng.metrics()
            rep["launches"] = _build.launch_counts()
            iq.close()
            oq.close()
        lat = telemetry.get_registry().histogram(
            "zoo_serving_latency_seconds", "", ("stream", "priority"))
        for lane in ("interactive", "batch"):
            n = sum(1 for v in lane_of.values() if v == lane)
            last = max(seen[u] for u, v in lane_of.items() if v == lane)
            h = lat.labels(stream, lane)
            rep[lane] = dict(records=n, records_per_s=n / (last - t0),
                             p50_ms=h.quantile(0.5) * 1e3,
                             p99_ms=h.quantile(0.99) * 1e3)
        rep["records_per_s"] = len(lane_of) / (max(seen.values()) - t0)
        rep["single_p50_ms"] = float(np.percentile(singles, 50)) * 1e3
        rep["batches"] = m["batches"]
        bad = [u for u, raw in got.items() if not p15_same_as_some_rung(
            np, schema.decode_result(raw), refs, row_of[u])]
        if bad:
            raise AssertionError(f"15(b) {tag}: {len(bad)} results differ "
                                 f"from predict at every rung, e.g. {bad[:3]}")
        if m["records_out"] < len(got):
            raise AssertionError(f"15(b) {tag}: metrics {m['records_out']}")
    return rep


def p15_frontend(np, x, refs):
    """15(h): the HTTP frontend over (b)'s engine."""
    import json as _json
    import urllib.error
    import urllib.request
    from analytics_zoo_tpu_torch.serving import FrontEnd, schema

    def post(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=_json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, _json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, _json.loads(e.read())

    def get(port, path, accept=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     headers={"Accept": accept} if accept
                                     else {})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()

    def run(broker, eng, stream):
        import re
        rep = {}
        with FrontEnd(broker.port, engine=eng) as fe:
            n0 = 4 * P15_LANE_ROUNDS + P15_SINGLE
            lat = []
            for k in range(8):
                t1 = time.perf_counter()
                code, body = post(fe.port, {
                    "priority": "interactive", "deadline_ms": 30_000.0,
                    "inputs": {"x": schema.encode_tensor(x[n0 + k])}})
                lat.append(time.perf_counter() - t1)
                if code != 200 or not p15_same_as_some_rung(
                        np, schema.decode_tensor(body["result"]), refs,
                        n0 + k):
                    raise AssertionError(f"15(h) POST /predict: {code}")
            rep["post_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
            c = broker.client()
            c.xshed_set(stream, "batch", True)
            code, body = post(fe.port, {
                "priority": "batch",
                "inputs": {"x": schema.encode_tensor(x[0])}})
            c.xshed_set(stream, "batch", False)
            c.close()
            if (code, body.get("code")) != (429, "shed"):
                raise AssertionError(f"15(h) shed lane: {code} {body}")
            code, body = post(fe.port, {
                "deadline_ms": 0.001,
                "inputs": {"x": schema.encode_tensor(x[1])}})
            if (code, body.get("code")) != (504, "expired"):
                raise AssertionError(f"15(h) lapsed deadline: {code} {body}")
            code, text = get(fe.port, "/metrics", accept="text/plain")
            m = re.search(r'^zoo_serving_records_total\{stream="'
                          + re.escape(stream) + r'"\} (\S+)$', text, re.M)
            served = eng.metrics()["records_out"]
            if code != 200 or m is None or float(m.group(1)) != served:
                raise AssertionError(f"15(h) /metrics: {code}, "
                                     f"{m and m.group(1)} vs {served}")
            for path in ("/healthz", "/slo",
                         "/query?name=zoo_serving_latency_seconds&agg=p99"):
                code, text = get(fe.port, path)
                if code != 200:
                    raise AssertionError(f"15(h) {path}: {code}")
            rep["query_p99"] = _json.loads(text)["points"]
            rep["records_total"] = served
        return rep

    return run


def p15_ncf_lanes(np, api, im, x):
    """15(b) and (h): NCF at MovieLens-1M width behind the lanes, turns
    of the Python and the native broker."""
    n = 4 * P15_LANE_ROUNDS + P15_SINGLE + 8
    rungs = (P15_NCF_BATCH, 2 * P15_NCF_BATCH, P15_NCF_MAX_BATCH)
    # references first: the engine attaches its ladder to the model
    refs = {r: im.predict(x[:n], batch_size=r) for r in rungs}
    turns, counts = [], {}
    front = p15_frontend(np, x, refs)
    for t in range(P15_TURNS):
        for backend in ("python", "native"):
            last = t == P15_TURNS - 1 and backend == "native"
            turns.append(p15_lane_burst(
                np, api, im, backend, x, refs, f"{backend}{t}",
                frontend=front if last else None))
            counts[f"{backend}{t}"] = turns[-1].pop("launches")
    for backend in ("python", "native"):
        mine = [r for r in turns if r["backend"] == backend]
        log(f"phase 15(b) NCF lanes on the {backend} broker (burst of "
            f"{4 * P15_LANE_ROUNDS}: {3 * P15_LANE_ROUNDS} batch, "
            f"{P15_LANE_ROUNDS} interactive; batch {P15_NCF_BATCH}, max "
            f"{P15_NCF_MAX_BATCH}), per turn: " + "; ".join(
                f"{r['records_per_s']:.1f} records/s, interactive "
                f"{r['interactive']['records_per_s']:.1f}/s p50 "
                f"{r['interactive']['p50_ms']:.3f} p99 "
                f"{r['interactive']['p99_ms']:.3f} ms, batch "
                f"{r['batch']['records_per_s']:.1f}/s p50 "
                f"{r['batch']['p50_ms']:.3f} p99 "
                f"{r['batch']['p99_ms']:.3f} ms, single p50 "
                f"{r['single_p50_ms']:.3f} ms" for r in mine))
    h = turns[-1]["frontend"]
    log(f"phase 15(h) frontend: POST /predict p50 {h['post_p50_ms']:.3f} "
        f"ms (8 requests, bitwise predict), 429 shed, 504 expired, "
        f"/metrics records_total {h['records_total']}, /healthz /slo "
        f"/query 200")
    for tag, c in counts.items():
        if c.get("fused_embedding_lookup", 0) <= 0:
            raise AssertionError(f"15(b) {tag} launched no lookup: {c}")
    return dict(turns=turns, launches=counts)


def p15_bert_warmup(torch, np, api, state, kind):
    """15(c): BERT-Base bf16 behind ClusterServing(warmup=True) over
    rungs 8-32, after a fresh engine without warm-up whose first batch
    lands on a rung no model of the process has run."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _build
    Broker, ClusterServing, InputQueue, OutputQueue = api
    x = bert_inputs(np.random.RandomState(SEED + 15), P15_BERT_BURST)
    sample = tuple(a[:1] for a in x)
    bf16 = dict(use_flash=True, dtype=torch.bfloat16)
    rep = {}

    def singles(port, stream, n=P15_BERT_SINGLES):
        """ms of ``n`` requests one after another, and their results."""
        iq, oq = InputQueue(port=port, stream=stream), OutputQueue(port=port)
        ms, outs = [], []
        for k in range(n):
            t0 = time.perf_counter()
            u = iq.enqueue(f"{stream}{k}", input_ids=x[0][k],
                           token_type_ids=x[1][k])
            outs.append(oq.query(u, timeout=120, poll_interval=0.0005))
            ms.append((time.perf_counter() - t0) * 1e3)
        iq.close()
        oq.close()
        return ms, outs

    with Broker.launch(backend="native") as b:
        cold = InferenceModel(device="cuda").load_torch(
            bert_classifier(state, **bf16), sample)
        with ClusterServing(cold, b.port, batch_size=P15_COLD_RUNG,
                            max_batch_size=P15_COLD_RUNG, warmup=False,
                            stream="p15_bert_cold"):
            rep["cold_ms"], _ = singles(b.port, "p15_bert_cold")
        # the warmed engine: start() until every rung is ready
        im = InferenceModel(device="cuda").load_torch(
            bert_classifier(state, **bf16), sample)
        eng = ClusterServing(im, b.port, batch_size=P15_BERT_RUNGS[0],
                             max_batch_size=P15_BERT_RUNGS[1],
                             stream="p15_bert", pipeline_window=1)
        grown = []
        set_bucket = eng._set_bucket

        def spy(rung, why):
            grown.append((int(rung), im.rung_ready(rung)))
            set_bucket(rung, why)

        eng._set_bucket = spy
        t0 = time.perf_counter()
        eng.start()
        eng.wait_warm(timeout=300)
        torch.cuda.synchronize()
        rep["warm_s"] = time.perf_counter() - t0
        if not all(im.rung_ready(r) for r in eng.ladder.rungs):
            raise AssertionError(f"15(c) rungs not ready: {eng.ladder}")
        _build.reset_launch_counts()
        rep["warm_ms"], firsts = singles(b.port, "p15_bert")
        iq = InputQueue(port=b.port, stream="p15_bert")
        oq = OutputQueue(port=b.port)
        t0 = time.perf_counter()
        uris = iq.enqueue_batch(
            (f"c{i}", {"input_ids": x[0][i], "token_type_ids": x[1][i]})
            for i in range(P15_BERT_BURST))
        got = oq.query_many(uris, timeout=300, poll_interval=0.002)
        rep["burst_records_per_s"] = P15_BERT_BURST / (
            time.perf_counter() - t0)
        iq.close()
        oq.close()
        eng.stop()
    m = eng.metrics()
    rep["launches"] = _build.launch_counts()
    flash = rep["launches"].get("flash_attention_fwd", 0)
    blocks = im._module.config.n_block
    if flash != blocks * m["batches"] or m["batches"] <= 0:
        raise AssertionError(f"15(c) flash launches {flash} for "
                             f"{m['batches']} batches ({blocks} a batch)")
    if not grown or not all(ready for _, ready in grown):
        raise AssertionError(f"15(c) growth onto unready rungs or none: "
                             f"{grown}")
    rep.update(grown=grown, batches=m["batches"])
    refs = {r: im.predict(x, batch_size=r) for r in eng.ladder.rungs}
    bad = [u for i, u in enumerate(uris)
           if not p15_same_as_some_rung(np, got[u], refs, i)]
    # a lone request is its row padded to the bottom rung
    bad += [k for k, out in enumerate(firsts) if not np.array_equal(
        out, im.predict((x[0][k:k + 1], x[1][k:k + 1]),
                        batch_size=P15_BERT_RUNGS[0])[0])]
    if bad:
        raise AssertionError(f"15(c) {len(bad)} results differ from "
                             f"predict at every rung")
    ms = lambda v: ", ".join(f"{t:.3f}" for t in v)  # noqa: E731
    log(f"phase 15(c) BERT-Base bf16 on {kind}: a fresh engine without "
        f"warm-up, first batch on rung {P15_COLD_RUNG} (no model of this "
        f"process ran it): requests {ms(rep['cold_ms'])} ms; start() until "
        f"rungs {list(eng.ladder.rungs)} ready {rep['warm_s']:.3f} s, then "
        f"requests {ms(rep['warm_ms'])} ms; burst of {P15_BERT_BURST}: "
        f"{rep['burst_records_per_s']:.2f} records/s, growth {grown}, "
        f"{flash} flash launches for {m['batches']} batches; every result "
        f"bitwise predict at its rung")
    return rep


def p15_deadlines(np, api, im, x, refs):
    """15(d): deadline_ms=1 records behind a held batch expire, typed."""
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import schema
    Broker, ClusterServing, InputQueue, _ = api
    stream = "p15_deadline"
    with Broker.launch(backend="native") as b:
        iq = InputQueue(port=b.port, stream=stream)
        held = iq.enqueue_batch((f"h{i}", {"x": x[i]})
                                for i in range(P15_DEADLINE_HELD))
        dead = iq.enqueue_batch(
            ((f"d{i}", {"x": x[P15_DEADLINE_HELD + i]})
             for i in range(P15_DEADLINE_RECORDS)), deadline_ms=1.0)
        time.sleep(0.05)
        _build.reset_launch_counts()
        with ClusterServing(im, b.port, batch_size=P15_NCF_BATCH,
                            max_batch_size=P15_NCF_BATCH, warmup=False,
                            stream=stream) as eng:
            c = b.client()
            got, _ = p15_arrivals(c, held + dead)
            c.close()
            m = eng.metrics()
        pending = b.client().xpending(stream, "serving")
        iq.close()
    outcome = {"result": 0, "expired": 0}
    for i, u in enumerate(held + dead):
        try:
            val = schema.decode_result(got[u])
            if not p15_same_as_some_rung(np, val, refs, i):
                raise AssertionError(f"15(d) {u} differs from predict")
            outcome["result"] += 1
        except schema.DeadlineExpiredError:
            outcome["expired"] += 1
    want = {"result": P15_DEADLINE_HELD, "expired": P15_DEADLINE_RECORDS}
    if outcome != want or m["records_expired"] != P15_DEADLINE_RECORDS \
            or pending != 0:
        raise AssertionError(f"15(d) outcomes {outcome}, metrics "
                             f"{m['records_expired']}, pending {pending}")
    log(f"phase 15(d) deadlines: {P15_DEADLINE_RECORDS} records with "
        f"deadline_ms=1 behind {P15_DEADLINE_HELD} held: {outcome}; none "
        f"pending, none silent")
    return dict(outcome=outcome, launches=_build.launch_counts())


def p15_admission(api, im, x):
    """15(e): a burning SLO sheds the batch lane at the broker; clearing
    the burn clears the flag."""
    from analytics_zoo_tpu_torch.common import slo
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import ShedError
    Broker, ClusterServing, InputQueue, OutputQueue = api
    stream = "p15_admission"

    def monitor(threshold_s):
        return slo.SLOMonitor(slos=[slo.SLO(
            name="serving_p99_latency_interactive", kind="latency",
            objective=0.99, metric="zoo_serving_latency_seconds",
            threshold_s=threshold_s,
            labels=(("stream", stream), ("priority", "interactive")),
            shed=False)], windows=(1.0,), shed_burn=2.0, tick_s=0.02)

    def wait_shed(c, want, timeout=10.0):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if c.xshed(stream) == want:
                return time.perf_counter()
            time.sleep(0.005)
        raise AssertionError(f"15(e) shed flags never became {want}")

    restore = p15_env(ZOO_SERVING_ADMISSION_S="0.05")
    rep = {}
    try:
        _build.reset_launch_counts()
        # every interactive latency counts as bad: burn 100 against 2
        slo.set_monitor(monitor(1e-6))
        with Broker.launch(backend="native") as b, \
                ClusterServing(im, b.port, batch_size=P15_NCF_BATCH,
                               max_batch_size=P15_NCF_BATCH, warmup=False,
                               stream=stream) as eng:
            iq, oq = InputQueue(port=b.port, stream=stream), \
                OutputQueue(port=b.port)
            c = b.client()
            t0 = time.perf_counter()
            for k in range(8):
                u = iq.enqueue(f"e{k}", priority="interactive", x=x[k])
                oq.query(u, timeout=30, poll_interval=0.0005)
            rep["shed_after_s"] = wait_shed(c, ["batch"]) - t0
            try:
                iq.enqueue("refused", priority="batch", x=x[8])
                raise AssertionError("15(e) a batch enqueue was accepted")
            except ShedError:
                pass
            u = iq.enqueue("still", priority="interactive", x=x[9])
            if oq.query(u, timeout=30) is None:
                raise AssertionError("15(e) interactive not served")
            if not eng.metrics()["admission_shedding"]:
                raise AssertionError("15(e) engine does not report it")
            t0 = time.perf_counter()
            slo.set_monitor(monitor(1e3))          # the burn clears
            rep["cleared_after_s"] = wait_shed(c, []) - t0
            u = iq.enqueue("accepted", priority="batch", x=x[10])
            if oq.query(u, timeout=30) is None:
                raise AssertionError("15(e) batch not served after clear")
            c.close()
            iq.close()
            oq.close()
    finally:
        slo.set_monitor(None)
        restore()
    rep["launches"] = _build.launch_counts()
    log(f"phase 15(e) admission: XSHED on batch {rep['shed_after_s']:.3f} "
        f"s after the burn began; batch enqueue refused (ShedError), "
        f"interactive served; cleared {rep['cleared_after_s']:.3f} s after "
        f"the burn cleared")
    return rep


def p15_leases(np, api, im, x, refs):
    """15(f): a consumer takes entries and never acks; the engine's
    short lease reclaims them, each result written once."""
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import schema
    Broker, ClusterServing, InputQueue, _ = api
    stream = "p15_lease"
    n = P15_LEASE_RECORDS
    with Broker.launch(backend="native") as b:
        iq = InputQueue(port=b.port, stream=stream)
        uris = iq.enqueue_batch((f"l{i}", {"x": x[i]}) for i in range(n))
        c = b.client()
        if len(c.xreadgroup("serving", "ghost", stream, n)) != n:
            raise AssertionError("15(f) the ghost consumer read short")
        t_ghost = time.perf_counter()
        _build.reset_launch_counts()
        with ClusterServing(im, b.port, batch_size=P15_NCF_BATCH,
                            max_batch_size=P15_NCF_BATCH, warmup=False,
                            stream=stream, claim_min_idle_ms=P15_LEASE_MS,
                            reclaim_interval_s=0.02) as eng:
            t0 = time.perf_counter()
            got, seen = p15_arrivals(c, uris)
            recovery_s = max(seen.values()) - t0
            for u in uris:                          # collect and delete
                c.hdel("result", u)
            time.sleep(3 * P15_LEASE_MS / 1000.0)
            again = [u for u, v in p15_results(c, uris).items()
                     if v is not None]
            m = eng.metrics()
        pending = c.xpending(stream, "serving")
        c.close()
        iq.close()
    bad = [u for i, u in enumerate(uris) if not p15_same_as_some_rung(
        np, schema.decode_result(got[u]), refs, i)]
    if bad or again or m["records_redelivered"] != n or \
            m["records_out"] != n or pending != 0:
        raise AssertionError(f"15(f) differ {bad[:3]}, written again "
                             f"{again[:3]}, metrics {m}, pending {pending}")
    log(f"phase 15(f) leases: {n} entries a consumer never acked, "
        f"reclaimed and served {recovery_s:.3f} s after the engine "
        f"started ({max(seen.values()) - t_ghost:.3f} s after the ghost's "
        f"read; lease {P15_LEASE_MS} ms); each result written once")
    return dict(recovery_s=recovery_s, launches=_build.launch_counts())


def p15_decode(np, api, dec_im, greedy, inputs, kind):
    """15(g): batch-lane generate records with interactive predicts
    interleaved, on the paged path; then self-drafted."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.ops import _build, autotune
    Broker, ClusterServing, InputQueue, OutputQueue = api
    enc, start = inputs
    b = DECODE_BATCH
    rng = np.random.default_rng(15)
    px = rng.standard_normal(
        (P15_GEN_PREDICTS, 8, DECODE["input_dim"])).astype(np.float32)
    py = rng.standard_normal(
        (P15_GEN_PREDICTS, DECODE["decoder_seq_len"],
         DECODE["output_dim"])).astype(np.float32)
    want = dec_im.predict((px, py), batch_size=b)
    gen = {"max_new_tokens": DECODE_STEPS}
    rep = {}
    restore = p15_env(ZOO_SERVING_MAX_WAIT_MS=(
        f"interactive={P15_INTERACTIVE_WAIT_MS}"))
    try:
        for what, kw, n_gen in (
                ("paged", {}, P15_GEN_RECORDS),
                ("draft", dict(draft_model=dec_im, spec_k=DECODE_SPEC_K),
                 P15_DRAFT_RECORDS)):
            stream = f"p15_decode_{what}"
            with Broker.launch(backend="native") as bk, \
                    ClusterServing(dec_im, bk.port, batch_size=b,
                                   max_batch_size=b, warmup=False,
                                   input_cols=["x", "y"], stream=stream,
                                   **kw) as eng, autotune_mode("on"):
                # paged="auto" in the engine's scheduler: its verdicts
                # first, then the counts from 0
                verdicts = build_step_verdicts(
                    eng._ensure_scheduler(), enc[0].shape,
                    DECODE["output_dim"], DECODE_STEPS)
                _build.reset_launch_counts()
                iq = InputQueue(port=bk.port, stream=stream)
                oq = OutputQueue(port=bk.port)
                t0 = time.perf_counter()
                gens = iq.enqueue_batch(
                    ((f"g{i}", {"x": enc[i % b], "start": start[i % b]})
                     for i in range(n_gen)), priority="batch",
                    generate=gen)
                preds = []
                if what == "paged":
                    for k in range(P15_GEN_PREDICTS):
                        preds.append(iq.enqueue(
                            f"p{k}", priority="interactive", x=px[k],
                            y=py[k]))
                        time.sleep(0.01)
                got = oq.query_many(gens + preds, timeout=300,
                                    poll_interval=0.002)
                dt = time.perf_counter() - t0
                sched = eng._decode_sched
                m = eng.metrics()
                iq.close()
                oq.close()
            launches = _build.launch_counts()
            preempt = int(eng._preempt_counter.value)
            for i, u in enumerate(gens):
                if got[u] is None or not np.array_equal(got[u],
                                                        greedy[i % b]):
                    raise AssertionError(f"15(g) {what}: {u} differs from "
                                         f"greedy generate of row {i % b}")
            for k, u in enumerate(preds):
                if not np.array_equal(got[u], want[k]):
                    raise AssertionError(f"15(g) predict {u} differs")
            gathers = launches.get("paged_gather", 0)
            if gathers != m["paged_steps"] or autotune.pending_count():
                raise AssertionError(f"15(g) {what}: {gathers} gathers for "
                                     f"{m['paged_steps']} paged steps; "
                                     f"{autotune.pending_count()} step "
                                     f"shapes without a verdict")
            bound = ClusterServing.DECODE_STARVATION_FLOOR * sched.steps_run
            if what == "paged" and not 0 < preempt <= bound:
                raise AssertionError(f"15(g) preemptions {preempt}, bound "
                                     f"{bound}")
            snap = telemetry.snapshot()
            steps_h = snap["zoo_request_cost_decode_steps"][
                f"stream={stream},priority=batch,kind=generate"]
            enc_h = snap["zoo_request_cost_device_seconds"].get(
                f"stream={stream},priority=interactive,kind=encode",
                {"count": 0})
            if steps_h["count"] != n_gen or enc_h["count"] != len(preds):
                raise AssertionError(f"15(g) cost entries {steps_h['count']}"
                                     f" / {enc_h['count']}")
            rep[what] = dict(
                generate_records=n_gen, predicts=len(preds), seconds=dt,
                tokens_per_s=n_gen * DECODE_STEPS / dt,
                preemptions=preempt, steps=sched.steps_run,
                paged_steps=m["paged_steps"], gather_launches=gathers,
                step_verdicts=verdicts,
                gather_steps=sched.paged_fallbacks,
                cost_steps_mean=steps_h["sum"] / steps_h["count"],
                launches=launches)
    finally:
        restore()
    p, d = rep["paged"], rep["draft"]
    log(f"phase 15(g) decode on {kind}: {p['generate_records']} batch-lane "
        f"generate records of {DECODE_STEPS} tokens with "
        f"{p['predicts']} interactive predicts interleaved in "
        f"{p['seconds']:.3f} s ({p['tokens_per_s']:.1f} tokens/s), "
        f"{p['preemptions']} preemptions over {p['steps']} steps, "
        f"{p['gather_launches']} gathers = paged steps (paged='auto' by "
        f"the step verdicts {p['step_verdicts']}, {p['gather_steps']} "
        f"host-gather steps; self-drafted {d['paged_steps']} paged, "
        f"{d['gather_steps']} host-gather); self-drafted "
        f"{d['generate_records']} records {d['tokens_per_s']:.1f} tokens/s;"
        f" tokens bitwise greedy generate, one cost entry a record")
    return rep


def phase_serving_a7(torch, np, api, im, x, state, dec, kind):
    """Phase 15: Cluster Serving's scheduling and delivery."""
    from analytics_zoo_tpu_torch.serving import ShedError
    t0 = time.perf_counter()
    rep = {"a": p15_native_protocol(api[0], ShedError)}
    rep["b"] = p15_ncf_lanes(np, api, im, x)
    refs = {P15_NCF_BATCH: im.predict(x[:P15_DEADLINE_HELD
                                        + P15_DEADLINE_RECORDS],
                                      batch_size=P15_NCF_BATCH)}
    rep["c"] = p15_bert_warmup(torch, np, api, state, kind)
    rep["d"] = p15_deadlines(np, api, im, x, refs)
    rep["e"] = p15_admission(api, im, x)
    rep["f"] = p15_leases(np, api, im, x, refs)
    dec_im, greedy, inputs = dec
    rep["g"] = p15_decode(np, api, dec_im, greedy, inputs, kind)
    rep["seconds"] = time.perf_counter() - t0
    ncf_lanes = {}
    for counts in rep["b"]["launches"].values():
        for name, n in counts.items():
            ncf_lanes[name] = ncf_lanes.get(name, 0) + n
    launches = {
        "ncf_lanes": ncf_lanes, "bert": rep["c"]["launches"],
        "deadline": rep["d"]["launches"],
        "admission": rep["e"]["launches"], "lease": rep["f"]["launches"],
        "decode": rep["g"]["paged"]["launches"],
        "decode_draft": rep["g"]["draft"]["launches"]}
    for path in ("deadline", "admission", "lease"):
        if launches[path].get("fused_embedding_lookup", 0) <= 0:
            raise AssertionError(f"15 {path} path launched no lookup: "
                                 f"{launches[path]}")
    rep["launches"] = launches
    return rep


def phase_a3(torch, np, eb, state, Estimator, x, y, kind, card):
    """Phase 14 (a)-(e); the directory it writes is removed after. Each
    part's paths zero the launch counts before they run."""
    import shutil
    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.ops import _build
    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    os.makedirs(PHASE14_DIR)
    log_dir = estimator.DEFAULT_LOG_DIR
    estimator.DEFAULT_LOG_DIR = os.path.join(PHASE14_DIR, "logs")
    rep, counts, secs = {}, {}, {}
    t0 = time.perf_counter()

    def took(part):
        nonlocal t0
        secs[part] = time.perf_counter() - t0
        t0 = time.perf_counter()
    try:
        rep["ncf_loops"] = phase_ncf_loops(torch, np, x, y, kind)
        counts["ncf_loops"] = {m: rep["ncf_loops"][m]["launches"]
                               for m in ("per_step", "staged", "cached")}
        took("ncf_loops")
        _build.reset_launch_counts()
        rep["optimizers"] = phase_optimizers(torch, np, x, y, card)
        counts["optimizers"] = _build.launch_counts()
        took("optimizers")
        rep["bert"] = phase_bert_remat(torch, np, state, Estimator, kind)
        counts["bert_remat"] = rep["bert"]["remat_fit"]["launches"]
        took("bert_remat")
        rep["tasks"] = phase_bert_tasks(torch, np, card)
        counts["tasks"] = {t: rep["tasks"][t]["fit_remat_false"]["launches"]
                           for t in ("ner", "squad")}
        took("tasks")
        _build.reset_launch_counts()
        rep["profile"] = phase_profile(torch, np, x, y, card)
        counts["profile"] = _build.launch_counts()
        took("profile")
        rep["seconds_by_part"] = secs
        log(f"phase 14: seconds by part "
            f"{ {k: round(v, 1) for k, v in secs.items()} }")
        for name in ("fused_embedding_lookup", "embedding_scatter_add"):
            if counts["optimizers"].get(name, 0) <= 0 or \
                    counts["profile"].get(name, 0) <= 0:
                raise AssertionError(f"phase 14 launched no {name}: "
                                     f"{counts}")
    finally:
        estimator.DEFAULT_LOG_DIR = log_dir
        shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    rep["launches"] = counts
    return rep


# ------------------------------------------------------------- phase 16

def p16_nrmse(np, got, want) -> float:
    """JAX's int8 reading (tests/test_inference_net.py): rms error over
    the reference's spread."""
    return float(np.sqrt(np.mean((got - want) ** 2)) / want.std())


def p16_agree(np, got, want) -> float:
    return float((got.argmax(-1) == want.argmax(-1)).mean())


def p16_int8_layers_bitwise(torch, np, im, x):
    """Each int8 layer's output on the card against the same layer on the
    CPU fed the same input: (layers, those that differ)."""
    import copy
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    seen, hooks = {}, []

    def keep(name):
        def hook(mod, args, out):
            seen.setdefault(name, (mod, args[0].detach().clone(),
                                   out.detach().clone()))
        return hook

    for name, mod in im._module.named_modules():
        if isinstance(mod, qlib._Int8):
            hooks.append(mod.register_forward_hook(keep(name)))
    try:
        im.predict(x, batch_size=len(x[0]) if isinstance(x, tuple)
                   else len(x))
    finally:
        for h in hooks:
            h.remove()
    differ = []
    for name, (mod, a, out) in seen.items():
        cpu = copy.deepcopy(mod).to("cpu")
        with torch.inference_mode():
            want = cpu(a.cpu())
        if not same_bits(out.cpu(), want):
            differ.append(name)
    return sorted(seen), differ


def p16_ncf_int8(torch, np, ncf, kind):
    """16(a): bench.py's measure_int8_predict NCF half (MovieLens-1M
    width, P16_NCF_ROWS rows, calibration on P16_CALIB rows, min_elems
    1024): fp32, weight-only and int8 predict ms (CUDA events), the
    resident parameter bytes, agreement and nrmse against fp32 at JAX's
    limits, each int8 layer bitwise its CPU self, B1's launches."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    from analytics_zoo_tpu_torch.ops import _build
    rng = np.random.RandomState(SEED + 16)
    x = np.stack([rng.randint(1, NCF["user_count"] + 1, P16_NCF_ROWS),
                  rng.randint(1, NCF["item_count"] + 1, P16_NCF_ROWS)],
                 1).astype(np.float32)
    rep, ims, outs = {}, {}, {}
    _build.reset_launch_counts()
    for mode in ("fp32", "weight", "int8"):
        im = InferenceModel(device="cuda").load_zoo(ncf)
        if mode != "fp32":
            im.quantize(min_elems=P16_MIN_ELEMS, mode=mode,
                        calibration_data=x[:P16_CALIB] if mode == "int8"
                        else None)
        before = _build.launch_counts().get("fused_embedding_lookup", 0)
        outs[mode] = im.predict(x, batch_size=P16_NCF_ROWS)
        ms = cuda_ms(lambda: im.predict(x, batch_size=P16_NCF_ROWS),
                     iters=P16_REPS, warmup=2)
        launches = _build.launch_counts().get(
            "fused_embedding_lookup", 0) - before
        rep[mode] = dict(predict_ms=ms, launches=launches,
                         resident_bytes=qlib.resident_bytes(im._module))
        if mode != "fp32":
            rep[mode].update(
                tree_nbytes=qlib.tree_nbytes(im._qtree),
                agreement=p16_agree(np, outs[mode], outs["fp32"]),
                nrmse=p16_nrmse(np, outs[mode], outs["fp32"]))
        ims[mode] = im
    rep["int8"]["layers"], rep["int8"]["layers_differ"] = \
        p16_int8_layers_bitwise(torch, np, ims["int8"], x[:SERVE_BATCH])
    log(f"phase 16(a) NCF int8 on {kind}, {P16_NCF_ROWS} rows: predict ms "
        + ", ".join(f"{m} {rep[m]['predict_ms']:.4f}" for m in rep)
        + "; resident bytes " + ", ".join(
            f"{m} {rep[m]['resident_bytes']}" for m in rep)
        + "; against fp32: " + ", ".join(
            f"{m} agreement {rep[m]['agreement']:.4f} nrmse "
            f"{rep[m]['nrmse']:.4g}" for m in ("weight", "int8"))
        + f"; int8 layers {rep['int8']['layers']} bitwise their CPU selves"
        f" (differ: {rep['int8']['layers_differ']}); lookup launches "
        + ", ".join(f"{m} {rep[m]['launches']}" for m in rep))
    for m in ("weight", "int8"):
        if not (np.isfinite(outs[m]).all()
                and rep[m]["agreement"] >= P16_AGREE
                and rep[m]["nrmse"] < P16_NRMSE):
            raise AssertionError(f"16(a) NCF {m}: {rep[m]}")
    if rep["int8"]["layers_differ"] or not rep["int8"]["layers"] or \
            any(rep[m]["launches"] <= 0 for m in rep):
        raise AssertionError(f"16(a): {rep}")
    return ims["int8"], x, outs["int8"], rep


def p16_int8_products(torch, im, x, batch=None, out_dir=P16_DIR):
    """The int8 products of one forward, by the names of the kernels the
    profiler saw on the card inside the last of three forwards' ranges
    (a trace can miss its first activities, keep_cupti): (count, their
    distinct names, every kernel name of that forward). ``batch``: the
    predict's batch size (default: the rows of a tuple's first input)."""
    import re
    pat = re.compile(P16_INT8_KERNEL)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(3):
            with torch.profiler.record_function(f"p16_forward_{i}"):
                im.predict(x, batch_size=batch or len(x[0]))
        torch.cuda.synchronize()
    path = os.path.join(out_dir, "int8_forward.pt.trace.json")
    prof.export_chrome_trace(path)
    events = trace_events(path)
    rng = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
           if e.get("cat") == "gpu_user_annotation"
           and e.get("name") == "p16_forward_2"]
    if not rng:
        raise AssertionError("16(b): no range of the last forward on the "
                             "card in the trace")
    lo, hi = rng[0]
    names = [e["name"] for e in events if e.get("cat") == "kernel"
             and lo <= e["ts"] <= hi]
    hits = [n for n in names if pat.search(n)]
    return len(hits), sorted(set(hits)), sorted(set(names))


def state_blocks(state) -> int:
    """The encoder blocks of a BERT classifier's state dict."""
    return len({k.split(".")[1] for k in state if k.startswith("bert.block_")})


def p16_bert_int8(torch, np, state, kind):
    """16(b): the BERT-Base classifier of phase 6 at 32 x 512 in fp32
    (TF32 off) and bf16: weight-only and int8 predict ms beside the
    unquantized ones, resident bytes, agreement and nrmse at 16(a)'s
    limits, the int8 products a forward (26: 12 x 2 FFN, the pooler, the
    head) and B3's launches (12 a forward)."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    x = bert_inputs(np.random.RandomState(SEED), BERT_BATCH)
    sample = tuple(a[:BERT_CPU_ROWS] for a in x)
    calib = tuple(a[:P16_BERT_CALIB] for a in x)
    rep = {}
    for label, cfg in (("fp32", {}), ("bf16", dict(dtype=torch.bfloat16))):
        out, r = {}, {}
        for mode in ("float", "weight", "int8"):
            im = InferenceModel(device="cuda").load_torch(
                bert_classifier(state, use_flash=True, **cfg), sample)
            if mode != "float":
                im.quantize(min_elems=P16_MIN_ELEMS, mode=mode,
                            calibration_data=calib if mode == "int8"
                            else None)
            before = fa.launches.value
            out[mode], ms = timed_predict(im, x, reps=5)
            r[mode] = dict(predict_ms=ms,
                           flash_launches_per_predict=(
                               fa.launches.value - before) / 6,
                           resident_bytes=qlib.resident_bytes(im._module))
            if mode != "float":
                r[mode].update(agreement=p16_agree(np, out[mode],
                                                   out["float"]),
                               nrmse=p16_nrmse(np, out[mode], out["float"]))
            if mode == "int8":
                n, hits, names = p16_int8_products(torch, im, x)
                r[mode].update(int8_products=n, int8_kernel_names=hits,
                               layers=len(im._act_ranges))
                if n != 2 * im._module.config.n_block + 2:
                    log(f"  kernels of one int8 forward: {names}")
            del im
            torch.cuda.empty_cache()
        rep[label] = r
        log(f"phase 16(b) BERT-Base {label} {BERT_BATCH}x{BERT_LEN} on "
            f"{kind}: predict ms " + ", ".join(
                f"{m} {r[m]['predict_ms']:.3f}" for m in r)
            + "; resident bytes " + ", ".join(
                f"{m} {r[m]['resident_bytes']}" for m in r)
            + "; against float: " + ", ".join(
                f"{m} agreement {r[m]['agreement']:.4f} nrmse "
                f"{r[m]['nrmse']:.4g}" for m in ("weight", "int8"))
            + f"; int8 products a forward {r['int8']['int8_products']} "
            f"({r['int8']['int8_kernel_names']}), calibrated layers "
            f"{r['int8']['layers']}; flash launches a predict "
            f"{r['int8']['flash_launches_per_predict']:.0f}")
        for m in ("weight", "int8"):
            if not (np.isfinite(out[m]).all()
                    and r[m]["agreement"] >= P16_AGREE
                    and r[m]["nrmse"] < P16_NRMSE
                    and r[m]["flash_launches_per_predict"]
                    == state_blocks(state)):
                raise AssertionError(f"16(b) {label} {m}: {r[m]}")
        want = 2 * state_blocks(state) + 2
        if r["int8"]["int8_products"] != want or \
                r["int8"]["layers"] != want:
            raise AssertionError(f"16(b) {label} int8 products: {r}")
    return rep


def p16_serve_int8(np, api, im8, x, y8, kind):
    """16(c) and (e): 16(a)'s int8 model served through ClusterServing on
    the native broker, every result bitwise the int8 predict; a lone
    record's ``GET /trace`` spans in order, none negative, their sum
    within its end-to-end latency; the flight recorder's dump; the
    backend on ``/healthz``."""
    import urllib.request
    from analytics_zoo_tpu_torch.common import profiling, telemetry
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import FrontEnd
    Broker, ClusterServing, InputQueue, OutputQueue = api
    telemetry.set_trace_sampling(1.0)        # ZOO_TELEMETRY_SAMPLE=1
    recorder = profiling.get_flight_recorder()   # attached from here on
    n = N_BURST
    _build.reset_launch_counts()
    with Broker.launch(backend="native") as b, \
            ClusterServing(im8, b.port, batch_size=SERVE_BATCH,
                           max_batch_size=SERVE_BATCH,
                           warmup=False) as eng, \
            FrontEnd(b.port, engine=eng) as fe:
        iq, oq = InputQueue(port=b.port), OutputQueue(port=b.port)
        t0 = time.perf_counter()
        uris = iq.enqueue_batch((f"c{i}", {"x": x[i]}) for i in range(n))
        got = oq.query_many(uris, timeout=120, poll_interval=0.002)
        burst_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        lone = iq.enqueue("c_lone", x=x[n])
        got[lone] = oq.query(lone, timeout=30, poll_interval=0.0005)
        t_got = time.perf_counter()
        e2e_s = t_got - t1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fe.port}/trace?uri={lone}",
                timeout=30) as resp:
            trace = json.loads(resp.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{fe.port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        iq.close()
        oq.close()
    launches = _build.launch_counts()
    rows = {f"c{i}": i for i in range(n)}
    rows[lone] = n
    differ = [u for u, i in rows.items()
              if got.get(u) is None or not np.array_equal(got[u], y8[i])]
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    stages = [e["name"] for e in sorted(spans, key=lambda e: e["ts"])
              if e["name"] in ("dequeue", "preprocess", "device",
                               "postprocess")]
    stage_ms = {e["name"]: e["dur"] / 1e3 for e in spans
                if e["name"] in stages}
    # the engine's read may block before the record exists: each stage's
    # time counts from the enqueue on (the tracer's clock is this
    # process's perf_counter)
    abs_spans = {sp.name: sp for sp in telemetry.get_tracer().get(lone)}
    owned_ms = {k: (abs_spans[k].end - max(abs_spans[k].start, t1)) * 1e3
                for k in stage_ms}
    dump = recorder.dump_once(
        "phase16", reason="phase 16(e)",
        path=os.path.join(P16_DIR, "flightrec_phase16.json"))
    with open(dump) as fh:
        fr = json.load(fh)
    rep = dict(records_per_s=n / burst_s, lone_e2e_ms=e2e_s * 1e3,
               lone_stage_ms=stage_ms, lone_stage_ms_from_enqueue=owned_ms,
               stages=stages, differ=len(differ),
               launches=launches, backend=health.get("backend"),
               flight_recorder=dict(path=os.path.relpath(dump),
                                    spans=len(fr["spans"]),
                                    metrics=len(fr["metrics"])))
    log(f"phase 16(c) the int8 NCF served on the native broker on {kind}: "
        f"{n} records at {rep['records_per_s']:.1f} records/s, {len(differ)}"
        f" differ from the int8 predict; lookup launches {launches}")
    log(f"phase 16(e) GET /trace?uri={lone}: stages {stages} "
        f"{ {k: round(v, 4) for k, v in stage_ms.items()} } ms (from its "
        f"enqueue on: sum {sum(owned_ms.values()):.4f} ms) within its "
        f"{e2e_s * 1e3:.4f} ms end to end; /healthz backend "
        f"{rep['backend']}; flight recorder {rep['flight_recorder']}")
    if differ or launches.get("fused_embedding_lookup", 0) <= 0:
        raise AssertionError(f"16(c): {len(differ)} differ ({differ[:3]}),"
                             f" launches {launches}")
    if stages != ["dequeue", "preprocess", "device", "postprocess"] or \
            min(stage_ms.values()) < 0 or \
            sum(owned_ms.values()) > e2e_s * 1e3 or \
            abs_spans["postprocess"].end > t_got:
        raise AssertionError(f"16(e) trace of {lone}: {trace}")
    if rep["backend"].get("platform") != "gpu" or \
            rep["backend"].get("device_kind") != kind or \
            not fr["spans"] or not fr["metrics"]:
        raise AssertionError(f"16(e): {rep}")
    return rep


def p16_get(url, timeout=5.0):
    """A frontend's JSON answer, a 503's body included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def p16_records_total(snap) -> float:
    fam = snap.get("zoo_serving_records_total", {})
    return float(fam.get("stream=serving_stream", 0.0))


def p16_fleet(np, api, ncf, y32, x, kind):
    """16(d): a replica started from config.yaml in a subprocess
    (``python -m analytics_zoo_tpu_torch.serving.start``) and one in this
    process share the native broker's stream; the fleet's merged count
    equals the replicas' own; the subprocess is SIGKILLed while it holds
    leased entries and the survivor answers every record once."""
    import threading
    Broker = api[0]
    model_dir = os.path.join(P16_DIR, "ncf")
    ncf.save_model(model_dir, over_write=True)
    knobs = dict(ZOO_FLEET_HEARTBEAT_S=0.25, ZOO_FLEET_STALE_S=1,
                 ZOO_SERVING_LEASE_MS=P16_LEASE_MS,
                 ZOO_SERVING_RECLAIM_S=0.25)
    restore = p15_env(**knobs)
    rep = {}
    try:
        with Broker.launch(backend="native") as b:
            cfg = os.path.join(P16_DIR, "config.yaml")
            with open(cfg, "w") as fh:
                fh.write(f"model:\n  path: {model_dir}\n"
                         f"data:\n  src: 127.0.0.1:{b.port}\n"
                         f"params:\n  batch_size: {SERVE_BATCH}\n")
            env = dict(os.environ, HTTP_PORT="0", BIND_HOST="127.0.0.1",
                       PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "analytics_zoo_tpu_torch.serving.start", cfg,
                 "--device", "cuda"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            lines = []

            def read():
                for line in proc.stdout:
                    lines.append(line.rstrip())

            reader = threading.Thread(target=read, daemon=True)
            reader.start()
            try:
                rep.update(p16_fleet_drill(np, api, b, proc, lines, y32, x,
                                           t0))
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=30)
                reader.join(10)
    finally:
        restore()
    return rep


def p16_fleet_drill(np, api, b, proc, lines, y32, x, t0):
    """16(d) once both replicas run. The in-process replica polls the
    broker without blocking while a batch is in flight and so takes
    nearly every record it can reach; it is stopped (it drains, acks and
    deregisters) while the subprocess alone takes a half of the first
    burst and the whole second one, and started again for the rest."""
    import signal
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import FrontEnd, schema
    _, ClusterServing, InputQueue, OutputQueue = api
    deadline = time.perf_counter() + 180
    while time.perf_counter() < deadline and \
            not any(ln.startswith("replica ") for ln in lines):
        if proc.poll() is not None:
            raise AssertionError(f"16(d) serving.start exited: {lines}")
        time.sleep(0.05)
    up = [ln for ln in lines if ln.startswith("serving up")]
    rid2 = [ln.split()[1] for ln in lines if ln.startswith("replica ")]
    if not up or not rid2:
        raise AssertionError(f"16(d) serving.start did not come up: {lines}")
    boot_s = time.perf_counter() - t0
    port2, rid2 = int(up[0].rsplit(":", 1)[1]), rid2[0]
    im = InferenceModel(device="cuda").load(os.path.join(P16_DIR, "ncf"))
    rep = dict(boot_s=boot_s, replica2=rid2)
    _build.reset_launch_counts()
    eng = ClusterServing(im, b.port, batch_size=SERVE_BATCH,
                         max_batch_size=SERVE_BATCH, warmup=False)
    with FrontEnd(b.port, engine=eng) as fe:
        base1 = f"http://127.0.0.1:{fe.port}"
        base2 = f"http://127.0.0.1:{port2}"

        def fleet_of(n_live):
            t1 = time.perf_counter()
            while p16_get(f"{base1}/healthz")["fleet"]["replicas"] != n_live:
                if time.perf_counter() - t1 > 30:
                    raise AssertionError(f"16(d) the fleet never listed "
                                         f"{n_live}")
                time.sleep(0.05)

        iq, oq = InputQueue(port=b.port), OutputQueue(port=b.port)
        c = b.client()
        try:
            eng.start()
            fleet_of(2)
            before = [p16_records_total(p16_get(
                f"{u}/metrics?format=snapshot")) for u in (base1, base2)]
            fleet0 = p16_records_total(p16_get(
                f"{base1}/metrics?scope=fleet")["metrics"])
            half = P16_BURST // 2
            eng.stop()
            uris = iq.enqueue_batch((f"d{i}", {"x": x[i]})
                                    for i in range(half))
            got = oq.query_many(uris, timeout=120, poll_interval=0.002)
            eng.start()
            fleet_of(2)
            more = iq.enqueue_batch((f"d{i}", {"x": x[i]})
                                    for i in range(half, P16_BURST))
            got.update(oq.query_many(more, timeout=120,
                                     poll_interval=0.002))
            uris = list(uris) + list(more)
            own = [p16_records_total(p16_get(
                f"{u}/metrics?format=snapshot")) - before[k]
                for k, u in enumerate((base1, base2))]
            view = p16_get(f"{base1}/metrics?scope=fleet")
            merged = p16_records_total(view["metrics"]) - fleet0
            rep["first"] = dict(own=own, merged=merged,
                                partial=view["partial"],
                                scraped=view["replicas"]["scraped"],
                                missing=sum(got[u] is None for u in uris))
            log(f"phase 16(d) fleet of 2 (one from config.yaml, up in "
                f"{boot_s:.1f} s): {P16_BURST} records, replicas' own "
                f"counts {own}, merged ?scope=fleet {merged} (partial "
                f"{view['partial']})")
            if rep["first"]["missing"] or sum(own) != P16_BURST or \
                    merged != sum(own) or view["partial"] or min(own) <= 0:
                raise AssertionError(f"16(d) first burst: {rep['first']}")
            # the kill: the subprocess alone takes the burst and is
            # frozen until it holds leased entries, then SIGKILLed; the
            # in-process replica starts again and reclaims them
            eng.stop()
            uris2 = iq.enqueue_batch((f"k{i}", {"x": x[i]})
                                     for i in range(P16_BURST))
            held, probes, t_kill = 0, 0, None
            while t_kill is None and probes < 100_000:
                probes += 1
                os.kill(proc.pid, signal.SIGSTOP)
                held = c.xpending_detail("serving_stream", "serving").get(
                    rid2, 0)
                if held:
                    os.kill(proc.pid, signal.SIGKILL)
                    t_kill = time.perf_counter()
                else:
                    os.kill(proc.pid, signal.SIGCONT)
                    if probes % 64 == 0 and all(
                            v is not None for v in
                            p15_results(c, uris2).values()):
                        break
            if t_kill is None:
                raise AssertionError(f"16(d) replica 2 never held an entry "
                                     f"in {probes} probes")
            proc.wait(timeout=30)
            reclaims0 = eng.lease_reclaims
            eng.start()
            got2, seen = p15_arrivals(c, uris2, timeout=120)
            recover_s = max(seen.values()) - t_kill
            t2 = time.perf_counter()
            while c.xpending("serving_stream", "serving") and \
                    time.perf_counter() - t2 < 30:
                time.sleep(0.05)
            pending = c.xpending("serving_stream", "serving")
            hz = p16_get(f"{base1}/healthz")["fleet"]
            while (hz["replicas"], hz["stale"]) != (1, 1) and \
                    time.perf_counter() - t2 < 30:
                time.sleep(0.1)
                hz = p16_get(f"{base1}/healthz")["fleet"]
            m = eng.metrics()
        finally:
            eng.stop()
            iq.close()
            oq.close()
            c.close()
    launches = _build.launch_counts()
    vals = [got[u] for u in uris] + [
        None if got2.get(u) is None else schema.decode_result(got2[u])
        for u in uris2]
    worst = max(float(np.abs(v - y32[i % P16_BURST]).max())
                for i, v in enumerate(vals) if v is not None)
    rep["kill"] = dict(held=held, probes=probes, recover_s=recover_s,
                       lease_ms=P16_LEASE_MS, pending=pending,
                       answered=sum(v is not None for v in vals),
                       lease_reclaims=m["lease_reclaims"] - reclaims0,
                       records_redelivered=m["records_redelivered"],
                       healthz_fleet=hz, max_abs_diff=worst)
    rep["launches"] = launches
    log(f"phase 16(d) SIGKILL of the config.yaml replica holding {held} "
        f"leased entries ({probes} freeze probes): every record answered "
        f"({rep['kill']['answered']} of {2 * P16_BURST}), time to recover "
        f"{recover_s:.3f} s (lease {P16_LEASE_MS} ms); survivor lease "
        f"reclaims {rep['kill']['lease_reclaims']}, redelivered "
        f"{m['records_redelivered']}; /healthz fleet {hz}; max |served - "
        f"predict| {worst:.3g}; lookup launches {launches}")
    if rep["kill"]["answered"] != 2 * P16_BURST or pending != 0 or \
            rep["kill"]["lease_reclaims"] < 1 or \
            (hz["replicas"], hz["stale"]) != (1, 1) or \
            worst > SLICE_ATOL or \
            launches.get("fused_embedding_lookup", 0) <= 0:
        raise AssertionError(f"16(d) the kill: {rep['kill']}")
    return rep


def p16_fit_mfu(torch, np, state, Estimator, x_tr, y_tr, kind):
    """16(f): fit P16_FIT_STEPS steps of phase 8's BERT-Base bf16
    classifier at 32 x 128 and of phase 10's NCF at batch 8000 under the
    step profiler: zoo_step_flops at least the script's hand count of
    the step's products (with the Denses' bias adds) and within
    P16_FLOPS_MARGIN above it (the elementwise work and Adam's update,
    ROADMAP C18); NCF's equal to the same step counted on the CPU; 0 <
    zoo_mfu <= 1, zoo_hbm_bytes, the phase medians; the ms a step with
    the profiler and with its sampled fences off, in turns."""
    from analytics_zoo_tpu_torch.common import profiling, telemetry
    from analytics_zoo_tpu_torch.common.flax_compat import Dense
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.ops import _build
    ids, labels = train_inputs(np.random.RandomState(SEED + 1),
                               TRAIN_BATCH * P16_FIT_STEPS)
    rep = {}

    def run(label, make_fit, hand, margin, same=None):
        telemetry.reset_for_tests()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        make_fit()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        snap = telemetry.snapshot()
        phases = {k.split("=")[1]: v["p50"] for k, v in
                  snap["zoo_train_phase_seconds"].items()}
        r = dict(step_flops=snap.get("zoo_step_flops"),
                 hand_flops=float(hand), cpu_flops=same,
                 mfu=snap.get("zoo_mfu"),
                 hbm_bytes=snap.get("zoo_hbm_bytes"),
                 phase_p50_s=phases, fit_ms_per_step=dt / P16_FIT_STEPS
                 * 1e3, launches=_build.launch_counts())
        log(f"phase 16(f) {label} fit of {P16_FIT_STEPS} steps on {kind}: "
            f"zoo_step_flops {r['step_flops']} (hand count of the "
            f"products {r['hand_flops']}, ratio "
            f"{r['step_flops'] / r['hand_flops']:.5f}, limit 1 + {margin}; "
            f"the CPU's count {same}), zoo_mfu {r['mfu']}, zoo_hbm_bytes "
            f"{r['hbm_bytes']}, phase p50 s {phases}, "
            f"{r['fit_ms_per_step']:.3f} ms a step in the first fit; "
            f"launches {r['launches']}")
        if not r["hand_flops"] <= r["step_flops"] <= r["hand_flops"] * (
                1 + margin) or (same is not None and r["step_flops"] != same) \
                or r["mfu"] is None or not 0 < r["mfu"] <= 1:
            raise AssertionError(f"16(f) {label}: {r}")
        return r

    est = Estimator.from_torch(
        model=bert_classifier(state, use_flash=True, dtype=torch.bfloat16),
        loss="sparse_categorical_crossentropy_logits", optimizer="adam",
        seed=SEED)
    # the hand count of the products: 2mkn forward and 4mkn backward for
    # each Dense and projection (the packed QKV is three), attention's
    # QK^T and PV as the einsum chain computes them, 4bhs^2d forward and
    # twice that backward; each Dense's bias add, one an output element
    cfg = est.model.config
    b, s, hid = TRAIN_BATCH, TRAIN_LEN, cfg.hidden_size
    m = b * s
    bert_fwd = cfg.n_block * (
        2 * m * (4 * hid * hid + 2 * hid * cfg.intermediate_size)
        + 4 * b * cfg.n_head * s * s * cfg.head_dim) \
        + 2 * b * hid * hid + 2 * b * hid * BERT_CLASSES
    bert_bias = cfg.n_block * m * (5 * hid + cfg.intermediate_size) \
        + b * hid + b * BERT_CLASSES
    rep["bert_bf16"] = run("BERT-Base bf16 32x128", lambda: est.fit(
        (ids, labels), epochs=1, batch_size=TRAIN_BATCH),
        3 * bert_fwd + bert_bias, P16_FLOPS_MARGIN["bert_bf16"])
    del est
    net = train_model("ncf")
    net.compile(optimizer=Adam(NCF_LR),
                loss="sparse_categorical_crossentropy")
    denses = [mod for mod in net.module.modules() if isinstance(mod, Dense)]
    ncf_hand = sum(3 * 2 * BATCH * mod.in_features * mod.out_features
                   + BATCH * mod.out_features for mod in denses)
    # the same step counted on the CPU: the count holds on any route
    cpu_net = train_model("ncf")
    cpu_net.compile(optimizer=Adam(NCF_LR),
                    loss="sparse_categorical_crossentropy", device="cpu")
    ncf_cpu = cpu_net.estimator._step_flops(x_tr[:BATCH], y_tr[:BATCH])
    del cpu_net
    rows = BATCH * P16_FIT_STEPS
    rep["ncf"] = run("NCF batch 8000", lambda: net.fit(
        x_tr[:rows], y_tr[:rows], batch_size=BATCH, nb_epoch=1,
        shuffle=False), ncf_hand, P16_FLOPS_MARGIN["ncf"], ncf_cpu)
    for label in ("bert_bf16", "ncf"):
        need = ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv") if label == "bert_bf16" else \
            ("fused_embedding_lookup", "embedding_scatter_add")
        if any(rep[label]["launches"].get(k, 0) <= 0 for k in need):
            raise AssertionError(f"16(f) {label} launches: {rep[label]}")
    # the sampled fences' cost: the same NCF fit with and without them,
    # in turns (the flop count is taken already)
    est = net.estimator
    secs = {"profiled": [], "no_fences": []}
    real = profiling.StepProfiler.should_sample
    for r_ in range(P16_FENCE_ROUNDS):
        for mode in (("profiled", "no_fences") if r_ % 2 == 0
                     else ("no_fences", "profiled")):
            if mode == "no_fences":
                profiling.StepProfiler.should_sample = lambda self, s: False
            try:
                _, _, dt = counted(torch, lambda: est.fit(
                    (x_tr[:rows], y_tr[:rows]), epochs=1, batch_size=BATCH,
                    shuffle=False))
            finally:
                profiling.StepProfiler.should_sample = real
            secs[mode].append(dt / P16_FIT_STEPS * 1e3)
    rep["ncf_fences"] = {k: dict(ms_per_step=float(np.median(v)), each=v)
                         for k, v in secs.items()}
    log(f"phase 16(f) NCF fit ms a step, {P16_FENCE_ROUNDS} rounds in "
        f"turns: with the profiler's sampled fences "
        f"{rep['ncf_fences']['profiled']['ms_per_step']:.3f}, without "
        f"{rep['ncf_fences']['no_fences']['ms_per_step']:.3f}")
    telemetry.reset_for_tests()
    return rep


def phase_a7b(torch, np, api, ncf, state, Estimator, x_tr, y_tr, kind):
    """Phase 16: the rest of Cluster Serving (ROADMAP A7b); the directory
    it writes is removed after. Each part zeroes the counts before its
    paths."""
    import shutil
    from analytics_zoo_tpu_torch.learn import estimator
    shutil.rmtree(P16_DIR, ignore_errors=True)
    os.makedirs(P16_DIR)
    log_dir = estimator.DEFAULT_LOG_DIR
    estimator.DEFAULT_LOG_DIR = os.path.join(P16_DIR, "logs")
    t0 = time.perf_counter()
    rep = {}
    try:
        im8, x, y8, rep["a"] = p16_ncf_int8(torch, np, ncf, kind)
        rep["b"] = p16_bert_int8(torch, np, state, kind)
        rep["f"] = p16_fit_mfu(torch, np, state, Estimator, x_tr, y_tr,
                               kind)
        rep["c_e"] = p16_serve_int8(np, api, im8, x, y8, kind)
        from analytics_zoo_tpu_torch.inference import InferenceModel
        y32 = InferenceModel(device="cuda").load_zoo(ncf).predict(
            x[:P16_BURST], batch_size=SERVE_BATCH)
        rep["d"] = p16_fleet(np, api, ncf, y32, x, kind)
    finally:
        estimator.DEFAULT_LOG_DIR = log_dir
        shutil.rmtree(P16_DIR, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t0
    rep["launches"] = {
        "ncf_int8": {"fused_embedding_lookup": sum(
            rep["a"][m]["launches"] for m in ("fp32", "weight", "int8"))},
        "bert_int8": {"flash_attention_fwd": int(sum(
            rep["b"][d][m]["flash_launches_per_predict"] * 6
            for d in rep["b"] for m in rep["b"][d]))},
        "fit_bert_bf16": rep["f"]["bert_bf16"]["launches"],
        "fit_ncf": rep["f"]["ncf"]["launches"],
        "served_int8": rep["c_e"]["launches"],
        "fleet": rep["d"]["launches"]}
    return rep


def p17_data(np, n, classes=P17_CLASSES, seed=3):
    """bench.py's measure_resnet50_train batch: NHWC normal images from
    ``default_rng(seed)`` and integer labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, P17_IMAGE, P17_IMAGE, 3)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


def p17_weights(np, module, seed):
    """ResNet-50's weights from a numpy seed: each convolution's and the
    Dense's He-normal over its fan-in, the norms as flax initialises them
    (scale 1, bias 0, running mean 0 and variance 1)."""
    import torch
    rng = np.random.RandomState(seed)
    state = {}
    for key, val in module.state_dict().items():
        shape = tuple(val.shape)
        if key.endswith(".weight") and len(shape) == 2:
            arr = rng.standard_normal(shape) * np.sqrt(2.0 / shape[1])
        elif key.endswith(".var") or (key.endswith(".weight")
                                      and len(shape) == 1):
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        state[key] = torch.from_numpy(arr.astype(np.float32))
    module.load_state_dict(state)


def p17_classifier(np, dtype="float32", classes=P17_CLASSES, state=None,
                   seed=SEED + 17):
    """ImageClassifier(resnet-50, 224 px) with weights from the numpy
    seed, or ``state`` (a state dict) when given."""
    from analytics_zoo_tpu_torch.models import ImageClassifier
    clf = ImageClassifier(class_num=classes, model_name="resnet-50",
                          image_size=P17_IMAGE, dtype=dtype)
    if state is None:
        p17_weights(np, clf.model.module, seed)
    else:
        clf.model.module.load_state_dict(state)
    return clf


class p17_tf32:
    """``with p17_tf32(torch, on):`` TF32 on or off for cuBLAS and cuDNN,
    the flags put back after."""

    def __init__(self, torch, on: bool):
        self.backends, self.on = torch.backends, on

    def __enter__(self):
        b = self.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        b = self.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


def p17_window(torch, est, xs, ys) -> float:
    """bench.py's _measure_step_time: P17_WARMUP steps, then P17_TIMED
    on the host clock between two syncs; ms a step."""
    for _ in range(P17_WARMUP):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P17_TIMED):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / P17_TIMED * 1e3


def p17_hand_flops(torch, module, x) -> dict:
    """The hand count of a training step's products at ``x``'s batch:
    each convolution 2 * out * in * (its taps that fall inside the input,
    summed over the output positions; XLA counts no tap on padding) and
    the Dense 2 * in * out + out (its bias add) a row forward; the step
    three times the forward products less the stem's input gradient,
    which nothing asks for, and the Dense's bias add once."""
    from analytics_zoo_tpu_torch.common.flax_compat import Conv, Dense
    from analytics_zoo_tpu_torch.common.profiling import _valid_taps
    shapes, hooks = {}, []

    def keep(name):
        def hook(mod, args, out):
            shapes.setdefault(name, (tuple(args[0].shape),
                                     tuple(out.shape)))
        return hook

    for name, mod in module.named_modules():
        if isinstance(mod, (Conv, Dense)):
            hooks.append(mod.register_forward_hook(keep(name)))
    try:
        with torch.inference_mode():
            module(x[:1])
    finally:
        for h in hooks:
            h.remove()
    fwd, stem, bias, n_conv, n_dense = 0, 0, 0, 0, 0
    for name, mod in module.named_modules():
        if name not in shapes:
            continue
        inp, out = shapes[name]
        if isinstance(mod, Conv):
            taps = 1
            for d, (lo, _) in enumerate(mod.pads(inp[1:-1])):
                taps *= _valid_taps(inp[1 + d], out[1 + d],
                                    mod.kernel_size[d], mod.strides[d], lo,
                                    mod.dilation[d])
            per = 2 * mod.out_features * mod.in_features * taps
            n_conv += 1
            if mod.in_features == x.shape[-1] and not stem:
                stem = per
        else:
            per = 2 * mod.in_features * mod.out_features
            bias += mod.out_features
            n_dense += 1
        fwd += per
    b = int(x.shape[0])
    return dict(step=b * (3 * fwd - stem + bias), forward=b * (fwd + bias),
                convs=n_conv, denses=n_dense)


def p17_train(torch, np, kind):
    """17(a): bench.py's ResNet-50 window in bf16, fp32 under TF32 and
    fp32 with TF32 off; a fit under the step profiler."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.ops import _build
    x, y = p17_data(np, P17_BATCH)
    rep = {}
    bf16 = p17_classifier(np, "mixed_bfloat16")
    state = {k: v.clone() for k, v in bf16.model.module.state_dict().items()}
    bf16.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    est = bf16.model.estimator
    xs, ys = est._tensors(x), est._tensors(y)
    _build.reset_launch_counts()
    rep["bf16_step_ms"] = p17_window(torch, est, xs, ys)
    rep["launches"] = {k: v for k, v in _build.launch_counts().items() if v}
    for label, on in (("fp32_tf32", True), ("fp32_tf32_off", False)):
        with p17_tf32(torch, on):
            clf = p17_classifier(np, "float32", state=state)
            clf.compile(optimizer="adam",
                        loss="sparse_categorical_crossentropy")
            e = clf.model.estimator
            rep[f"{label}_step_ms"] = p17_window(torch, e, e._tensors(x),
                                                 e._tensors(y))
            del clf, e
    for k in ("bf16", "fp32_tf32", "fp32_tf32_off"):
        rep[f"{k}_samples_per_sec"] = P17_BATCH / rep[f"{k}_step_ms"] * 1e3
    # a fit under the step profiler: the step's flops, counted once, and
    # the MFU of its sampled steps
    xf, yf = p17_data(np, P17_BATCH * P17_FIT_STEPS, seed=4)
    telemetry.reset_for_tests()
    t0 = time.perf_counter()
    bf16.fit(xf, yf, batch_size=P17_BATCH, nb_epoch=1, shuffle=False)
    torch.cuda.synchronize()
    rep["fit_ms_per_step"] = (time.perf_counter() - t0) / P17_FIT_STEPS \
        * 1e3
    snap = telemetry.snapshot()
    rep["step_flops"] = snap.get("zoo_step_flops")
    rep["mfu"] = snap.get("zoo_mfu")
    hand = p17_hand_flops(torch, bf16.model.module, xs)
    rep["hand_flops"] = hand
    telemetry.reset_for_tests()
    log(f"phase 17(a) ResNet-50 on {kind}, batch {P17_BATCH} x "
        f"{P17_IMAGE} px, bench.py's window ({P17_WARMUP} warm-up, "
        f"{P17_TIMED} timed): resnet50_train_step_ms bf16 "
        f"{rep['bf16_step_ms']:.3f} ({rep['bf16_samples_per_sec']:.1f} "
        f"samples/s), fp32 TF32 {rep['fp32_tf32_step_ms']:.3f} "
        f"({rep['fp32_tf32_samples_per_sec']:.1f}), fp32 TF32 off "
        f"{rep['fp32_tf32_off_step_ms']:.3f} "
        f"({rep['fp32_tf32_off_samples_per_sec']:.1f}); a "
        f"{P17_FIT_STEPS}-step bf16 fit, its first (the flop count's pass "
        f"included) {rep['fit_ms_per_step']:.3f} ms a step: "
        f"zoo_step_flops {rep['step_flops']} (hand count of the "
        f"{hand['convs']} convolutions' and {hand['denses']} Dense's "
        f"products {hand['step']}, ratio "
        f"{rep['step_flops'] / hand['step']:.5f}, limit 1 + "
        f"{P17_FLOPS_MARGIN}), zoo_mfu {rep['mfu']}; launches of the "
        f"port's kernels {rep['launches']}")
    if not hand["step"] <= rep["step_flops"] <= hand["step"] * (
            1 + P17_FLOPS_MARGIN) or rep["mfu"] is None or \
            not 0 < rep["mfu"] <= 1 or hand["convs"] != 53:
        raise AssertionError(f"17(a): {rep}")
    return bf16, state, rep


def p17_grads(est, x, y):
    loss, grads = est._loss_and_grads(x, y)
    return float(loss), {n: g.detach().cpu() for n, g in
                         zip(est._names, grads)}


def p17_norm_rel(got, want, names=None) -> float:
    """The distance of gradients ``got`` from ``want`` (dicts by parameter
    name; ``names``, default all): the norm of the difference over the
    norm of ``want``."""
    names = list(want) if names is None else names
    diff = sum(float(((got[n].double() - want[n].double()) ** 2).sum())
               for n in names)
    ref = sum(float((want[n].double() ** 2).sum()) for n in names)
    return math.sqrt(diff / ref) if ref else math.sqrt(diff)


def p17_rel(got, want) -> float:
    """norm(got - want) / norm(want) of two tensors, in float64."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def p17_stats(module):
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items() if k.endswith((".mean", ".var"))}


def p17_run(torch, np, state, x, y, device, dtype="float32", f64=False):
    """One training step's loss and gradients on ``x, y`` from ``state``,
    the running statistics it leaves, the logits (the Dense's output
    before the softmax) and the stem convolution's output of its train
    forward, and the eval-mode logits: the classifier and the readings."""
    from analytics_zoo_tpu_torch.common.flax_compat import Conv, Dense
    clf = p17_classifier(np, dtype, state=state)
    mod = clf.model.module
    if f64:
        mod.double()
    clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                device=device)
    convs = [m for m in mod.modules() if isinstance(m, Conv)]
    dense = [m for m in mod.modules() if isinstance(m, Dense)][-1]
    seen = {}

    def keep(key):
        def hook(m, args, out):
            seen.setdefault(key, out.detach().double().cpu())
        return hook

    hooks = [dense.register_forward_hook(keep("logits")),
             convs[0].register_forward_hook(keep("stem"))]
    try:
        loss, grads = p17_grads(clf.model.estimator, x, y)
        run = dict(loss=loss, grads=grads, stats=p17_stats(mod),
                   logits=seen.pop("logits"), stem=seen.pop("stem"))
        clf.predict(x, batch_size=len(x))
        run["eval_logits"] = seen.pop("logits")
    finally:
        for h in hooks:
            h.remove()
    return clf, run


def p17_correctness(torch, np, state, kind):
    """17(b): one step on P17_CHECK_ROWS rows from the same weights, in
    float64 on the card against the CPU at P17_LOSS_ATOL, P17_GRAD_RTOL,
    P17_STATS_ATOL and P17_PREDICT_RTOL; fp32 (TF32 off) and bf16 on the
    card against the float64 step; save and load bitwise. The Dense and
    the last norm make the head."""
    import shutil
    x, y = p17_data(np, P17_CHECK_ROWS, seed=5)
    rep = {}
    with p17_tf32(torch, False):
        _, ref = p17_run(torch, np, state, x, y, "cpu", f64=True)
        _, c64 = p17_run(torch, np, state, x, y, "cuda", f64=True)
        _, cpu = p17_run(torch, np, state, x, y, "cpu")
        card_clf, card = p17_run(torch, np, state, x, y, "cuda")
        _, bf = p17_run(torch, np, state, x, y, "cuda", "mixed_bfloat16")
        head = [n for n in ref["grads"] if n.startswith((
            "dense_", f"batchnormalization_{P17_NORMS}."))]
        # float64: the card against the CPU
        rep["f64_loss_diff"] = abs(c64["loss"] - ref["loss"])
        rep["f64_grad_rel"], rep["f64_grad_worst"] = grad_reading(
            c64["grads"], ref["grads"])
        rep["f64_grad_norm_rel"] = p17_norm_rel(c64["grads"], ref["grads"])
        rep["f64_stats_diff"] = max(float((c64["stats"][k] - v).abs().max())
                                    for k, v in ref["stats"].items())
        rep["f64_predict_rel"] = p17_rel(c64["eval_logits"],
                                         ref["eval_logits"])
        # fp32 on the card and on the CPU against float64
        for label, run in (("fp32", card), ("cpu_fp32", cpu)):
            rep[f"{label}_loss_diff"] = abs(run["loss"] - ref["loss"])
            rep[f"{label}_grad_norm_rel"] = p17_norm_rel(run["grads"],
                                                         ref["grads"])
            rep[f"{label}_grad_rel"], rep[f"{label}_grad_worst"] = \
                grad_reading(run["grads"], ref["grads"])
            rep[f"{label}_head_rel"] = p17_norm_rel(run["grads"],
                                                    ref["grads"], head)
            rep[f"{label}_logits_rel"] = p17_rel(run["logits"],
                                                 ref["logits"])
            rep[f"{label}_predict_rel"] = p17_rel(run["eval_logits"],
                                                  ref["eval_logits"])
        rep["fp32_stats_within"] = all(bool(
            ((card["stats"][k].double() - v).abs()
             <= P17_FP32_STATS_ATOL + P17_FP32_STATS_RTOL * v.abs()).all())
            for k, v in ref["stats"].items())
        # bf16 against float64
        rep["bf16_loss_rel"] = abs(bf["loss"] - ref["loss"]) / abs(
            ref["loss"])
        rep["bf16_logits_rel"] = p17_rel(bf["logits"], ref["logits"])
        rep["bf16_head_rel"] = p17_norm_rel(bf["grads"], ref["grads"], head)
        rep["bf16_stem_rel"] = p17_rel(bf["stem"], ref["stem"])
        rep["bf16_grad_norm_rel"] = p17_norm_rel(bf["grads"], ref["grads"])
        # save and load on the card, bitwise (batch_stats included)
        path = os.path.join(P17_DIR, "ckpt")
        card_clf.model.estimator.save(path)
        back = p17_classifier(np, "float32", seed=SEED + 18)
        back.compile(optimizer="adam",
                     loss="sparse_categorical_crossentropy")
        back.model.estimator.load(path)
        want = card_clf.model.module.state_dict()
        got = back.model.module.state_dict()
        rep["roundtrip_bitwise"] = sorted(got) == sorted(want) and all(
            torch.equal(got[k], want[k]) for k in want)
        rep["roundtrip_stats"] = sum(k.endswith((".mean", ".var"))
                                     for k in got)
        rep["roundtrip_predict_bitwise"] = same_bits(
            torch.as_tensor(back.predict(x, batch_size=len(x))),
            torch.as_tensor(card_clf.predict(x, batch_size=len(x))))
        shutil.rmtree(path, ignore_errors=True)
    log(f"phase 17(b) ResNet-50 one training step on {P17_CHECK_ROWS} "
        f"rows, TF32 off, against the same step in float64 on the CPU. "
        f"float64 on {kind}: loss {rep['f64_loss_diff']:.3g} apart (limit "
        f"{P17_LOSS_ATOL}), gradients within {rep['f64_grad_rel']:.3g} of "
        f"each leaf's largest (worst {rep['f64_grad_worst']}; limit "
        f"{P17_GRAD_RTOL}), the whole gradient {rep['f64_grad_norm_rel']:.3g}"
        f" of its norm, running statistics {rep['f64_stats_diff']:.3g} "
        f"(limit {P17_STATS_ATOL}), eval logits "
        f"{rep['f64_predict_rel']:.3g} of their norm (limit "
        f"{P17_PREDICT_RTOL}). fp32 on {kind} (the CPU's fp32 in "
        f"brackets): loss {rep['fp32_loss_diff']:.3g} "
        f"({rep['cpu_fp32_loss_diff']:.3g}; limit {P17_FP32_LOSS_ATOL}), "
        f"the whole gradient {rep['fp32_grad_norm_rel']:.3g} of its norm "
        f"({rep['cpu_fp32_grad_norm_rel']:.3g}), the worst leaf "
        f"{rep['fp32_grad_rel']:.3g} ({rep['cpu_fp32_grad_rel']:.3g}; "
        f"limits {P17_FP32_OVER_CPU} x the CPU's), the head's gradient "
        f"{rep['fp32_head_rel']:.3g} ({rep['cpu_fp32_head_rel']:.3g}; limit "
        f"{P17_FP32_HEAD_RTOL}), train logits {rep['fp32_logits_rel']:.3g} "
        f"({rep['cpu_fp32_logits_rel']:.3g}; limit {P17_FP32_LOGITS_RTOL}),"
        f" eval logits {rep['fp32_predict_rel']:.3g} "
        f"({rep['cpu_fp32_predict_rel']:.3g}; limit {P17_PREDICT_RTOL}), "
        f"running statistics within {P17_FP32_STATS_ATOL} + "
        f"{P17_FP32_STATS_RTOL} of each: {rep['fp32_stats_within']}. bf16 "
        f"on {kind}: loss {rep['bf16_loss_rel']:.3g} relative (limit "
        f"{P17_BF16_LOSS_RTOL}), train logits {rep['bf16_logits_rel']:.3g} "
        f"(limit {P17_BF16_LOGITS_RTOL}), the head's gradient "
        f"{rep['bf16_head_rel']:.3g} (limit {P17_BF16_HEAD_RTOL}), the stem "
        f"convolution's output {rep['bf16_stem_rel']:.3g} (limit "
        f"{P17_BF16_STEM_RTOL}), the whole gradient "
        f"{rep['bf16_grad_norm_rel']:.3g} (not held: past 1, as the step "
        f"amplifies bf16's rounding). Save/load bitwise "
        f"{rep['roundtrip_bitwise']} ({rep['roundtrip_stats']} running "
        f"statistics), its predict bitwise "
        f"{rep['roundtrip_predict_bitwise']}")
    over = P17_FP32_OVER_CPU
    if not (rep["f64_loss_diff"] <= P17_LOSS_ATOL
            and rep["f64_grad_rel"] <= P17_GRAD_RTOL
            and rep["f64_stats_diff"] <= P17_STATS_ATOL
            and rep["f64_predict_rel"] <= P17_PREDICT_RTOL
            and rep["fp32_loss_diff"] <= P17_FP32_LOSS_ATOL
            and rep["fp32_grad_norm_rel"]
            <= over * rep["cpu_fp32_grad_norm_rel"]
            and rep["fp32_grad_rel"] <= over * rep["cpu_fp32_grad_rel"]
            and rep["fp32_head_rel"] <= P17_FP32_HEAD_RTOL
            and rep["fp32_logits_rel"] <= P17_FP32_LOGITS_RTOL
            and rep["fp32_predict_rel"] <= P17_PREDICT_RTOL
            and rep["fp32_stats_within"]
            and rep["bf16_loss_rel"] <= P17_BF16_LOSS_RTOL
            and rep["bf16_logits_rel"] <= P17_BF16_LOGITS_RTOL
            and rep["bf16_head_rel"] <= P17_BF16_HEAD_RTOL
            and rep["bf16_stem_rel"] <= P17_BF16_STEM_RTOL
            and rep["roundtrip_bitwise"]
            and rep["roundtrip_stats"] == 2 * P17_NORMS
            and rep["roundtrip_predict_bitwise"]):
        raise AssertionError(f"17(b): {rep}")
    return rep


def p17_int8_convs_bitwise(torch, im, x):
    """The first int8 3x3 stride-2 convolution and the first 1x1 one of
    a forward on the card, each against the same layer on the CPU fed
    the same input: {layer: bitwise}."""
    import copy
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    pick = {}
    for name, mod in im._module.named_modules():
        if not isinstance(mod, qlib._Int8) or \
                mod.__dict__.get("_zoo_kind") != "conv":
            continue
        key = (tuple(mod.kernel_size), tuple(mod.strides))
        if key in (((3, 3), (2, 2)), ((1, 1), (1, 1))) and key not in {
                k for k, _ in pick.values()}:
            pick[name] = (key, mod)
    seen, hooks = {}, []

    def keep(name):
        def hook(mod, args, out):
            seen.setdefault(name, (args[0].detach().clone(),
                                   out.detach().clone()))
        return hook

    for name, (_, mod) in pick.items():
        hooks.append(mod.register_forward_hook(keep(name)))
    try:
        im.predict(x, batch_size=len(x))
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for name, (a, y) in seen.items():
        cpu = copy.deepcopy(pick[name][1]).to("cpu")
        with torch.inference_mode():
            want = cpu(a.cpu())
        out[name] = same_bits(y.cpu(), want)
    return out


def p17_predict(torch, np, kind):
    """17(c): measure_int8_predict's ResNet-50 half, as bench.py runs it:
    random weights and flax's initial running statistics (mean 0,
    variance 1). Its eval-mode activations grow block by block, so the
    softmax is one-hot and JAX's readings on the probabilities (printed)
    cannot fail; agreement and nrmse are held on the logits, the Dense's
    output before the softmax, taken by a hook."""
    from analytics_zoo_tpu_torch.common.flax_compat import Dense
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    x = np.random.default_rng(0).standard_normal(
        (P17_BATCH, P17_IMAGE, P17_IMAGE, 3)).astype(np.float32)
    clf = p17_classifier(np, "float32", classes=P17_INT8_CLASSES)
    state = clf.model.module.state_dict()
    rep, outs, logits = {}, {}, {}
    with p17_tf32(torch, False):
        for mode in ("fp32", "bf16", "int8"):
            src = clf if mode != "bf16" else p17_classifier(
                np, "mixed_bfloat16", classes=P17_INT8_CLASSES, state=state)
            im = InferenceModel(device="cuda").load_zoo(src)
            if mode == "int8":
                im.quantize(min_elems=P17_MIN_ELEMS, mode="int8",
                            calibration_data=x[:P17_CALIB])
            seen = []
            head = [m for m in im._module.modules()
                    if isinstance(m, Dense)][-1]
            hook = head.register_forward_hook(
                lambda m, a, out: seen.append(out.detach().float().cpu()))
            try:
                outs[mode] = im.predict(x, batch_size=P17_BATCH)
            finally:
                hook.remove()
            logits[mode] = torch.cat(seen).numpy()
            r = dict(predict_ms=cuda_ms(
                lambda: im.predict(x, batch_size=P17_BATCH),
                iters=P17_REPS, warmup=2),
                resident_bytes=qlib.resident_bytes(im._module))
            if mode == "fp32":
                r["mean_top_prob"] = float(outs[mode].max(-1).mean())
            else:
                r.update(agreement=p16_agree(np, outs[mode], outs["fp32"]),
                         nrmse=p16_nrmse(np, outs[mode], outs["fp32"]),
                         logits_agreement=p16_agree(np, logits[mode],
                                                    logits["fp32"]),
                         logits_nrmse=p16_nrmse(np, logits[mode],
                                                logits["fp32"]))
            if mode == "int8":
                r["calibrated"] = len(im._act_ranges)
                r["products"], r["product_kernels"], _ = p16_int8_products(
                    torch, im, x, batch=P17_BATCH, out_dir=P17_DIR)
                r["bitwise"] = p17_int8_convs_bitwise(
                    torch, im, x[:P17_CHECK_ROWS])
            rep[mode] = r
            del im
    i8 = rep["int8"]
    log(f"phase 17(c) ResNet-50 predict on {kind}, {P17_BATCH} x "
        f"{P17_IMAGE} px, {P17_INT8_CLASSES} classes: ms (CUDA events) "
        + ", ".join(f"{m} {rep[m]['predict_ms']:.3f}" for m in rep)
        + "; resident bytes " + ", ".join(
            f"{m} {rep[m]['resident_bytes']}" for m in rep)
        + f"; fp32's mean top probability {rep['fp32']['mean_top_prob']:.4f}"
        + "; against fp32 (TF32 off), on the logits (JAX's readings on "
        "the probabilities in brackets): " + ", ".join(
            f"{m} agreement {rep[m]['logits_agreement']:.4f} nrmse "
            f"{rep[m]['logits_nrmse']:.4g} ({rep[m]['agreement']:.4f}, "
            f"{rep[m]['nrmse']:.4g})" for m in ("bf16", "int8"))
        + f"; int8: {i8['calibrated']} layers calibrated, {i8['products']} "
        f"int8 products a forward ({i8['product_kernels']}; JAX's plan "
        f"takes {P17_INT8_PRODUCTS}); layers bitwise their CPU selves "
        f"{i8['bitwise']}")
    if not (np.isfinite(outs["int8"]).all()
            and i8["agreement"] >= P16_AGREE and i8["nrmse"] < P16_NRMSE
            and i8["logits_agreement"] >= P16_AGREE
            and i8["logits_nrmse"] < P16_NRMSE
            and i8["calibrated"] == P17_INT8_PRODUCTS
            and i8["products"] == P17_INT8_PRODUCTS
            and len(i8["bitwise"]) == 2 and all(i8["bitwise"].values())):
        raise AssertionError(f"17(c): {rep}")
    return rep


# cuDNN's convolution kernels by name (H100, torch 2.11, cuDNN 9:
# sm90_xmma_{fprop,dgrad,wgrad}_implicit_gemm_..., cutlass ImplicitGemm
# and s16816fprop kernels, split-k reductions, padding) and the GEMMs of
# the Dense and of the 1x1 convolutions cuDNN hands to cuBLAS (nvjet,
# cutlass s16816gemm)
P17_CONV_KERNEL = (r"(?i)(conv|fprop|dgrad|wgrad|implicit_gemm|"
                   r"xmma_.*(fprop|dgrad|wgrad)|cudnn)")
P17_GEMM_KERNEL = r"(?i)(nvjet|gemm)"
# the one 4-D activation a bf16 step copies: the input batch cast to bf16
P17_ACTIVATION_COPIES = 1


def p17_profile(torch, np, clf, kind):
    """17(d): where a bf16 training step's time goes, from the profiler's
    trace of the last of P17_PROFILE_STEPS steps."""
    import re
    from collections import Counter
    x, y = p17_data(np, P17_BATCH, seed=6)
    est = clf.model.estimator
    xs, ys = est._tensors(x), est._tensors(y)
    est._train_step(xs, ys)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        for i in range(P17_PROFILE_STEPS):
            with torch.profiler.record_function(f"p17_step_{i}"):
                est._train_step(xs, ys)
            torch.cuda.synchronize()
    path = os.path.join(P17_DIR, "train_step.pt.trace.json")
    prof.export_chrome_trace(path)
    events = trace_events(path)
    last = f"p17_step_{P17_PROFILE_STEPS - 1}"
    dev_rng = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
               if e.get("cat") == "gpu_user_annotation"
               and e.get("name") == last]
    host_rng = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                if e.get("cat") == "user_annotation"
                and e.get("name") == last]
    if not dev_rng or not host_rng:
        raise AssertionError("17(d): the last step's ranges are not in the "
                             "trace")
    lo, hi = dev_rng[0]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and lo <= e["ts"] <= hi]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    wall = (host_rng[0][1] - host_rng[0][0]) / 1e3
    by_name = Counter()
    for e in kernels:
        by_name[e["name"]] += e.get("dur", 0) / 1e3
    conv = re.compile(P17_CONV_KERNEL)
    gemm = re.compile(P17_GEMM_KERNEL)
    conv_ms = sum(v for k, v in by_name.items() if conv.search(k))
    gemm_ms = sum(v for k, v in by_name.items()
                  if gemm.search(k) and not conv.search(k))
    norm_ms = sum(v for k, v in by_name.items() if "batch_norm" in k)
    hlo, hhi = host_rng[0]
    copies = [e for e in events if e.get("cat") == "cpu_op"
              and e.get("name") in ("aten::copy_", "aten::clone",
                                    "aten::contiguous")
              and hlo <= e["ts"] <= hhi]
    act_copies = 0
    for e in copies:
        dims = (e.get("args") or {}).get("Input Dims") or []
        if dims and len(dims[0]) == 4 and dims[0][0] == P17_BATCH:
            act_copies += 1
    rep = dict(kernels=len(kernels), device_busy_ms=busy, wall_ms=wall,
               idle_share=max(0.0, 1 - busy / wall) if wall else None,
               conv_ms=conv_ms, conv_share=conv_ms / busy if busy else None,
               gemm_ms=gemm_ms, norm_ms=norm_ms,
               top=[(k, round(v, 4)) for k, v in by_name.most_common(10)],
               activation_copies=act_copies,
               conv_kernels=sorted(k for k in by_name if conv.search(k)),
               by_name={k: round(v, 5) for k, v in by_name.most_common()})
    log(f"phase 17(d) a bf16 ResNet-50 training step on {kind} "
        f"(profiler, step {P17_PROFILE_STEPS} of {P17_PROFILE_STEPS}): "
        f"{rep['kernels']} kernels, {busy:.3f} ms of device time in a "
        f"{wall:.3f} ms step (idle share {rep['idle_share']:.3f}); "
        f"cuDNN's convolution kernels {conv_ms:.3f} ms "
        f"({rep['conv_share']:.3f} of device time), cuBLAS's GEMMs "
        f"{gemm_ms:.3f} ms, the batch norms' kernels {norm_ms:.3f} ms; "
        f"copies of 4-D activations {act_copies} (limit "
        f"{P17_ACTIVATION_COPIES}: the input's cast); top "
        f"device operations (ms) {rep['top']}")
    if not rep["kernels"] or not busy or not conv_ms or \
            act_copies > P17_ACTIVATION_COPIES:
        raise AssertionError(f"17(d): {rep}")
    return rep


def phase_image(torch, np, kind):
    """Phase 17: ResNet-50 through ImageClassifier on the card (ROADMAP
    A15); the directory it writes is removed after."""
    import shutil
    shutil.rmtree(P17_DIR, ignore_errors=True)
    os.makedirs(P17_DIR)
    t0 = time.perf_counter()
    rep = {}
    try:
        bf16, state, rep["a"] = p17_train(torch, np, kind)
        rep["d"] = p17_profile(torch, np, bf16, kind)
        del bf16
        torch.cuda.empty_cache()
        rep["b"] = p17_correctness(torch, np, state, kind)
        torch.cuda.empty_cache()
        rep["c"] = p17_predict(torch, np, kind)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(P17_DIR, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t0
    rep["launches"] = {"resnet50_train": rep["a"]["launches"]}
    return rep


def p18_classifier(np, name, dtype="float32", classes=P18_CLASSES,
                   state=None, seed=SEED + 18, image=None):
    """ImageClassifier(name) at P18_IMAGE px with weights from the numpy
    seed (p17_weights' rule), or ``state`` when given."""
    from analytics_zoo_tpu_torch.models import ImageClassifier
    clf = ImageClassifier(class_num=classes, model_name=name,
                          image_size=image or P18_IMAGE, dtype=dtype)
    if state is None:
        p17_weights(np, clf.model.module, seed)
    else:
        clf.model.module.load_state_dict(state)
    return clf


def p18_images(np, n, seed=SEED):
    """``n`` normal NHWC images at P18_IMAGE px from ``default_rng``."""
    return np.random.default_rng(seed).standard_normal(
        (n, P18_IMAGE, P18_IMAGE, 3)).astype(np.float32)


def p18_head(torch, module):
    """The last Dense of ``module``, or its last Conv (squeezenet's
    convolutional head)."""
    from analytics_zoo_tpu_torch.common.flax_compat import Conv, Dense
    return [m for m in module.modules() if isinstance(m, (Dense, Conv))][-1]


class p18_logits:
    """``with p18_logits(torch, module) as seen:`` the pre-softmax logits
    of every forward of ``module`` appended to ``seen`` (float64, on the
    CPU): a Dense head's output, or a conv head's relu pooled."""

    def __init__(self, torch, module):
        self.torch, self.head, self.seen = torch, p18_head(torch, module), []

    def __enter__(self):
        def keep(mod, args, out):
            out = out.detach().double()
            if out.dim() == 4:
                out = self.torch.relu(out).mean((1, 2))
            self.seen.append(out.cpu())
        self.hook = self.head.register_forward_hook(keep)
        return self.seen

    def __exit__(self, *exc):
        self.hook.remove()


def p18_forward(torch, module, x, device, f64=False):
    """Eval forward of a copy of ``module`` on ``device`` (in float64 with
    ``f64``): (probabilities, logits) as float64 CPU tensors."""
    import copy
    mod = copy.deepcopy(module).to(device).eval()
    dt = torch.float64 if f64 else torch.float32
    if f64:
        mod = mod.double()
    with p18_logits(torch, mod) as seen, torch.inference_mode():
        probs = mod(torch.as_tensor(x, dtype=dt, device=device))
    return probs.double().cpu(), torch.cat(seen)


def p18_archs(torch, np, kind, dev="cuda"):
    """18(a): mobilenet, inception-v1 and mobilenet-v2 at 224 px, 1000
    classes: eval logits on the card in fp32 (TF32 off) and bf16 against
    the same forward on the CPU in float64 on P18_ROWS rows, and predict
    ms of P18_BATCH rows in fp32 and bf16 (CUDA events)."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    x = p18_images(np, P18_BATCH, seed=SEED + 1)
    rep = {}
    with p17_tf32(torch, False):
        for name in P18_ARCHS:
            clf = p18_classifier(np, name)
            state = clf.model.module.state_dict()
            bf = p18_classifier(np, name, "mixed_bfloat16", state=state)
            _, ref = p18_forward(torch, clf.model.module, x[:P18_ROWS],
                                 "cpu", f64=True)
            r = {}
            for label, src in (("fp32", clf), ("bf16", bf)):
                probs, logits = p18_forward(torch, src.model.module,
                                            x[:P18_ROWS], dev)
                r[f"{label}_rel"] = p17_rel(logits, ref)
                r[f"{label}_finite"] = bool(torch.isfinite(probs).all())
                im = InferenceModel(device=dev).load_zoo(src)
                r[f"{label}_ms"] = cuda_ms(
                    lambda: im.predict(x, batch_size=P18_BATCH),
                    iters=P18_REPS, warmup=2)
                del im
            r["params"] = sum(p.numel()
                              for p in clf.model.module.parameters())
            rep[name] = r
    log(f"phase 18(a) on {kind}, {P18_IMAGE} px, {P18_CLASSES} classes, "
        f"eval logits against float64 on the CPU ({P18_ROWS} rows; "
        "limits from dev/estimate_image_limits.py), predict ms of "
        f"{P18_BATCH} rows (CUDA events): " + "; ".join(
            f"{n} ({r['params']} parameters): fp32 (TF32 off) "
            f"{r['fp32_rel']:.3g} (limit {P18_FP32_RTOL[n]}), bf16 "
            f"{r['bf16_rel']:.3g} (limit {P18_BF16_RTOL[n]}); ms fp32 "
            f"{r['fp32_ms']:.3f}, bf16 {r['bf16_ms']:.3f}"
            for n, r in rep.items()))
    for n, r in rep.items():
        if not (r["fp32_finite"] and r["bf16_finite"]
                and r["fp32_rel"] <= P18_FP32_RTOL[n]
                and r["bf16_rel"] <= P18_BF16_RTOL[n]):
            raise AssertionError(f"18(a) {n}: {r}")
    return rep


def p18_twin(np, name, seed):
    """The torchvision-layout twin of ``name`` (1000 classes), torch's
    default init under ``seed`` and its batch norms moved off their
    initial state (so an import that dropped the statistics would
    show)."""
    import torch
    from analytics_zoo_tpu_torch.models.migration_image import MAKE_TWINS
    torch.manual_seed(seed)
    twin = MAKE_TWINS[name](P18_CLASSES).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
    return twin


def p18_twin_forward(torch, twin, x, dev):
    """The twin's (probabilities, logits) on NHWC ``x``, float64 on the
    CPU."""
    with torch.inference_mode():
        logits = twin(torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)
                      .contiguous()).double().cpu()
    return torch.softmax(logits, -1), logits


def p18_import(torch, np, kind, dev="cuda"):
    """18(b): ImageClassifier(pretrained=twin.state_dict()) against its
    twin on the card, both fp32 with TF32 off, P18_TWIN_ROWS rows; the
    forwards' ms at P18_BATCH for P18_TWIN_TIMED. Returns the imported
    ResNet-50 and its twin for (c)-(d)."""
    from analytics_zoo_tpu_torch.models import ImageClassifier
    x = p18_images(np, P18_BATCH, seed=SEED + 2)
    rep, keep = {}, {}
    with p17_tf32(torch, False):
        for i, name in enumerate(P18_TWINS):
            twin = p18_twin(np, name, SEED + 180 + i)
            clf = ImageClassifier(P18_CLASSES, name, image_size=P18_IMAGE,
                                  pretrained=twin.state_dict())
            twin = twin.to(dev)
            tp, tl = p18_twin_forward(torch, twin, x[:P18_TWIN_ROWS], dev)
            pp, pl = p18_forward(torch, clf.model.module,
                                 x[:P18_TWIN_ROWS], dev)
            r = dict(probs_diff=float((pp - tp).abs().max()),
                     logits_rel=float((pl - tl).abs().max()
                                      / tl.abs().max()),
                     top1_equal=bool((pp.argmax(-1) == tp.argmax(-1))
                                     .all()),
                     top_prob=float(tp.max(-1).values.mean()))
            if name in P18_TWIN_TIMED:
                mod = clf.model.module.to(dev).eval()
                xt = torch.as_tensor(x, device=dev)
                xc = xt.permute(0, 3, 1, 2).contiguous()
                with torch.inference_mode():
                    r["port_ms"] = cuda_ms(lambda: mod(xt), iters=P18_REPS,
                                           warmup=2)
                    r["twin_ms"] = cuda_ms(lambda: twin(xc),
                                           iters=P18_REPS, warmup=2)
            if name == "resnet-50":
                keep = dict(clf=clf, twin=twin)
            del twin, clf
            if dev == "cuda":
                torch.cuda.empty_cache()
            rep[name] = r
    log(f"phase 18(b) torchvision-layout import on {kind}, {P18_IMAGE} px, "
        f"{P18_TWIN_ROWS} rows, fp32 TF32 off, ImageClassifier(pretrained="
        "twin.state_dict()) against the twin: " + "; ".join(
            f"{n} probabilities {r['probs_diff']:.3g} (limit "
            f"{P18_TWIN_ATOL}), logits {r['logits_rel']:.3g} of their "
            f"largest (limit {P18_TWIN_LOGITS_RTOL}), top-1 equal "
            f"{r['top1_equal']}, the twin's mean top probability "
            f"{r['top_prob']:.4f}" + (
                f", forward ms at {P18_BATCH} rows (CUDA events): port "
                f"{r['port_ms']:.3f}, twin {r['twin_ms']:.3f}"
                if "port_ms" in r else "") for n, r in rep.items()))
    for n, r in rep.items():
        if not (r["probs_diff"] <= P18_TWIN_ATOL
                and r["logits_rel"] <= P18_TWIN_LOGITS_RTOL
                and r["top1_equal"]):
            raise AssertionError(f"18(b) {n}: {r}")
    return rep, keep


def p18_dogs_and_cats(np, n, seed=SEED + 3):
    """``n`` uint8 RGB images of dogs-vs-cats' typical sizes, 375 x 500
    and 500 x 375 in turns, from ``default_rng``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (375, 500, 3) if i % 2 else (500, 375, 3),
                         dtype=np.uint8) for i in range(n)]


def p18_image_set(torch, np, clf, twin, kind, dev="cuda"):
    """18(c): images -> ImageSet.from_arrays -> the torchvision preset ->
    the imported ResNet-50's predict_image_set -> LabelOutput(top_k),
    held against the twin on the same preprocessed arrays; the host's
    preprocessing ms an image beside the predict's."""
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    from analytics_zoo_tpu_torch.models.image.imageclassification. \
        image_classifier import LabelOutput, preprocessor
    raw = p18_dogs_and_cats(np, P18_IMAGES)
    t0 = time.perf_counter()
    iset = ImageSet.from_arrays(raw).transform(
        preprocessor("resnet-50", source="torchvision"))
    x = np.stack(iset.get_image())
    host_s = time.perf_counter() - t0
    with p17_tf32(torch, False):
        clf.compile(optimizer="adam",
                    loss="sparse_categorical_crossentropy", device=dev)
        clf.predict_image_set(iset, batch_size=P18_BATCH)
        t1 = time.perf_counter()
        with p18_logits(torch, clf.model.module) as seen:
            probs = clf.predict_image_set(iset, batch_size=P18_BATCH)
        predict_s = time.perf_counter() - t1
        tp, tl = p18_twin_forward(torch, twin, x, dev)
    logits = torch.cat(seen)
    labels = {i: f"class_{i}" for i in range(P18_CLASSES)}
    out = LabelOutput(labels)(probs, top_k=P18_TOP_K)
    ranked = all(
        len(o["classes"]) == P18_TOP_K
        and o["classes"][0] == f"class_{int(np.argmax(p))}"
        and bool(np.all(np.diff(o["probs"]) <= 0))
        for o, p in zip(out, probs))
    rep = dict(images=len(raw), shape=list(x.shape),
               host_ms_per_image=host_s / len(raw) * 1e3,
               predict_ms_per_image=predict_s / len(raw) * 1e3,
               probs_diff=float(np.abs(probs - tp.numpy()).max()),
               logits_rel=float((logits - tl).abs().max()
                                / tl.abs().max()),
               top1_equal=bool((probs.argmax(-1) == tp.numpy().argmax(-1))
                               .all()),
               ranked=ranked, first=out[0]["classes"][:2])
    log(f"phase 18(c) ImageSet on {kind}: {len(raw)} uint8 images (375 x "
        f"500 and 500 x 375) -> the torchvision preset (host, "
        f"{rep['host_ms_per_image']:.2f} ms an image) -> {x.shape} -> "
        f"ResNet-50 predict_image_set ({rep['predict_ms_per_image']:.3f} ms "
        f"an image, host clock, batch {P18_BATCH}) -> LabelOutput(top_k="
        f"{P18_TOP_K}): against the twin, probabilities "
        f"{rep['probs_diff']:.3g} (limit {P18_TWIN_ATOL}), logits "
        f"{rep['logits_rel']:.3g} of their largest, top-1 equal "
        f"{rep['top1_equal']}, labels ranked {ranked}")
    if not (x.shape == (len(raw), 224, 224, 3)
            and rep["probs_diff"] <= P18_TWIN_ATOL
            and rep["logits_rel"] <= P18_TWIN_LOGITS_RTOL
            and rep["top1_equal"] and ranked):
        raise AssertionError(f"18(c): {rep}")
    return rep, x


def p18_png(np, img) -> bytes:
    """``img`` (HWC uint8 RGB) as PNG bytes, written with zlib alone (a
    host may lack PIL, which the engine needs only to decode)."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    h, w, _ = img.shape
    rows = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def p18_serving(torch, np, api, clf, x, kind, dev="cuda"):
    """18(d): the imported ResNet-50 in ClusterServing on the native
    broker (batch pinned at P18_BATCH): a burst of P18_BURST tensor
    records of (c)'s preprocessed images, every answer bitwise the
    predict of its rows at that batch; P18_SINGLE lone requests; one PNG
    record by enqueue_image (on a host with PIL its answer is the
    predict of the decoded, preprocessed image; without PIL the typed
    error naming PIL), then a tensor record answered."""
    from analytics_zoo_tpu_torch.feature.image.transforms import decode_rgb
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import schema
    from analytics_zoo_tpu_torch.serving.engine import image_pipeline
    Broker, ClusterServing, InputQueue, OutputQueue = api
    xs = np.concatenate([x, x[::-1]])[:P18_BURST]
    chain = image_pipeline("resnet-50", source="torchvision")
    rep = {}
    with p17_tf32(torch, False):
        im = InferenceModel(device=dev).load_zoo(clf)
        refs = im.predict(xs, batch_size=P18_BATCH)
        with Broker.launch(backend="native") as b, \
                ClusterServing(im, b.port, batch_size=P18_BATCH,
                               max_batch_size=P18_BATCH, warmup=False,
                               image_preprocess=chain) as eng:
            if b.backend != "native":
                raise AssertionError(f"18(d): backend {b.backend}")
            iq, oq = InputQueue(port=b.port), OutputQueue(port=b.port)
            t0 = time.perf_counter()
            uris = iq.enqueue_batch((f"p18b{i}", {"x": xs[i]})
                                    for i in range(len(xs)))
            got = oq.query_many(uris, timeout=120, poll_interval=0.002)
            burst_s = time.perf_counter() - t0
            lat = []
            for i in range(P18_SINGLE):
                t1 = time.perf_counter()
                u = iq.enqueue(f"p18s{i}", x=xs[i])
                got[u] = oq.query(u, timeout=30, poll_interval=0.0005)
                lat.append(time.perf_counter() - t1)
            img = np.random.default_rng(SEED + 4).integers(
                0, 256, (240, 320, 3), dtype=np.uint8)
            png = p18_png(np, img)
            iq.enqueue_image("p18png", png)
            try:
                answer = oq.query("p18png", timeout=30)
                rep["png"] = "answered"
            except schema.ServingError as e:
                answer, rep["png"] = None, f"typed error: {e}"
            after = oq.query(iq.enqueue("p18after", x=xs[0]), timeout=30)
            metrics = eng.metrics()
            iq.close()
            oq.close()
    rows = {f"p18b{i}": i for i in range(len(xs))}
    rows.update({f"p18s{i}": i for i in range(P18_SINGLE)})
    bad = [u for u, i in rows.items() if got.get(u) is None
           or not np.array_equal(got[u], refs[i])]
    rep.update(records=len(xs), records_per_s=len(xs) / burst_s,
               single_p50_ms=float(np.percentile(lat, 50)) * 1e3,
               not_bitwise=len(bad), after_bitwise=bool(
                   np.array_equal(after, refs[0])),
               batches=metrics["batches"],
               records_failed=metrics["records_failed"])
    if answer is not None:
        # a host with PIL decodes the PNG: the answer is the predict of
        # the decoded, preprocessed image
        want = im.predict(chain(np.asarray(decode_rgb(png), np.float32))[
            None], batch_size=1)[0]
        rep["png_diff"] = float(np.abs(answer - want).max())
    del im
    log(f"phase 18(d) serving on {kind}: {len(xs)} tensor records of "
        f"{P18_IMAGE} x {P18_IMAGE} x 3 fp32 on the native broker, batch "
        f"{P18_BATCH}: {rep['records_per_s']:.1f} records/s, a lone "
        f"request's p50 {rep['single_p50_ms']:.3f} ms over {P18_SINGLE}; "
        f"answers not bitwise the predict at batch {P18_BATCH}: "
        f"{len(bad)}; the PNG record by enqueue_image: {rep['png']}; the "
        f"tensor record after it bitwise {rep['after_bitwise']}; "
        f"{metrics['batches']} batches, {metrics['records_failed']} failed")
    pil_error = answer is None and "PIL" in rep["png"]
    if not (not bad and rep["after_bitwise"]
            and (pil_error or rep.get("png_diff", 1.0) <= 1e-5)):
        raise AssertionError(f"18(d): {rep}, e.g. {bad[:3]}")
    return rep


def p18_int8(torch, np, kind, dev="cuda"):
    """18(e): InferenceModel.quantize of mobilenet-v2 at 224 px (1000
    classes), calibrated on P18_CALIB_BATCHES batches: the products
    quantized against JAX's plan, top-1 agreement and nrmse of the logits
    against fp32 (JAX's limits), predict ms fp32 / bf16 / int8 (CUDA
    events), a depthwise and a 1x1 int8 layer bitwise their CPU selves."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    x = p18_images(np, P18_BATCH, seed=SEED + 5)
    calib = [x[i * P18_CALIB_ROWS:(i + 1) * P18_CALIB_ROWS]
             for i in range(P18_CALIB_BATCHES)]
    clf = p18_classifier(np, "mobilenet-v2")
    state = clf.model.module.state_dict()
    rep, logits = {}, {}
    with p17_tf32(torch, False):
        for mode in ("fp32", "bf16", "int8"):
            src = clf if mode != "bf16" else p18_classifier(
                np, "mobilenet-v2", "mixed_bfloat16", state=state)
            im = InferenceModel(device=dev).load_zoo(src)
            if mode == "int8":
                im.quantize(min_elems=P17_MIN_ELEMS, mode="int8",
                            calibration_data=calib)
            with p18_logits(torch, im._module) as seen:
                im.predict(x, batch_size=P18_BATCH)
            logits[mode] = torch.cat(seen).float().numpy()
            r = dict(predict_ms=cuda_ms(
                lambda: im.predict(x, batch_size=P18_BATCH),
                iters=P18_REPS, warmup=2))
            if mode != "fp32":
                r.update(agreement=p16_agree(np, logits[mode],
                                             logits["fp32"]),
                         nrmse=p16_nrmse(np, logits[mode], logits["fp32"]))
            if mode == "int8":
                int8 = [m for m in im._module.modules()
                        if isinstance(m, qlib._Int8)]
                r["calibrated"] = len(im._act_ranges)
                r["int8_layers"] = len(int8)
                r["depthwise"] = sum(getattr(m, "groups", 1) > 1
                                     for m in int8)
                r["gemm_products"], r["product_kernels"], _ = \
                    p16_int8_products(torch, im, x, batch=P18_BATCH,
                                      out_dir=P18_DIR)
                r["products"] = r["gemm_products"] + r["depthwise"]
                r["bitwise"] = p18_int8_bitwise(torch, im,
                                                x[:P17_CHECK_ROWS])
            rep[mode] = r
            del im
    i8 = rep["int8"]
    log(f"phase 18(e) int8 mobilenet-v2 on {kind}, {P18_BATCH} x "
        f"{P18_IMAGE} px, calibrated on {P18_CALIB_BATCHES} batches of "
        f"{P18_CALIB_ROWS}: predict ms (CUDA events) " + ", ".join(
            f"{m} {rep[m]['predict_ms']:.3f}" for m in rep)
        + "; against fp32 (TF32 off) on the logits: " + ", ".join(
            f"{m} agreement {rep[m]['agreement']:.4f} nrmse "
            f"{rep[m]['nrmse']:.4g}" for m in ("bf16", "int8"))
        + f"; products quantized {i8['products']} ({i8['gemm_products']} "
        f"int8 GEMMs by the profiler's kernel names {i8['product_kernels']}"
        f", {i8['depthwise']} depthwise as exact float32 sums of int8 "
        f"values) of JAX's plan's {P18_INT8_PRODUCTS}, "
        f"{i8['calibrated']} layers calibrated; layers bitwise their CPU "
        f"selves {i8['bitwise']}")
    if not (np.isfinite(logits["int8"]).all()
            and i8["agreement"] >= P16_AGREE and i8["nrmse"] < P16_NRMSE
            and i8["calibrated"] == i8["int8_layers"] == P18_INT8_PRODUCTS
            and i8["depthwise"] == P18_DEPTHWISE
            and i8["products"] == P18_INT8_PRODUCTS
            and len(i8["bitwise"]) == 3 and all(i8["bitwise"].values())):
        raise AssertionError(f"18(e): {rep}")
    return rep


def p18_int8_bitwise(torch, im, x):
    """The first int8 depthwise convolution at stride 1 and at stride 2,
    and the first 1x1, of a forward on the card, each against the same
    layer on the CPU fed the same input: {layer: bitwise}."""
    import copy
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    pick, keys = {}, set()
    for name, mod in im._module.named_modules():
        if not isinstance(mod, qlib._Int8) or \
                mod.__dict__.get("_zoo_kind") != "conv":
            continue
        key = (mod.groups > 1, tuple(mod.kernel_size), tuple(mod.strides))
        if key in ((True, (3, 3), (1, 1)), (True, (3, 3), (2, 2)),
                   (False, (1, 1), (1, 1))) and key not in keys:
            keys.add(key)
            pick[name] = mod
    seen, hooks = {}, []

    def keep(name):
        def hook(mod, args, out):
            seen.setdefault(name, (args[0].detach().clone(),
                                   out.detach().clone()))
        return hook

    for name, mod in pick.items():
        hooks.append(mod.register_forward_hook(keep(name)))
    try:
        im.predict(x, batch_size=len(x))
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for name, (a, y) in seen.items():
        cpu = copy.deepcopy(pick[name]).to("cpu")
        with torch.inference_mode():
            out[name] = same_bits(y.cpu(), cpu(a.cpu()))
    return out


def p18_snapshot(torch, np, kind, dev="cuda"):
    """18(f): ResNet-50 (2 classes) fit for 2 steps at batch 8 with a
    checkpoint every step, then InferenceModel().load_zoo(a fresh
    classifier).load_checkpoint(dir): its predict bitwise the fitted
    estimator's at the same batch."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.learn.trigger import SeveralIteration
    path = os.path.join(P18_DIR, "ckpt")
    x, y = p17_data(np, P18_FIT_ROWS, seed=8)
    clf = p17_classifier(np, "float32")
    clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                device=dev)
    est = clf.model.estimator
    est.model_dir = path
    est.fit((x, y), epochs=1, batch_size=P18_FIT_BATCH,
            checkpoint_trigger=SeveralIteration(1))
    want = est.predict(x, batch_size=P18_FIT_BATCH)
    fresh = p17_classifier(np, "float32", seed=SEED + 19)
    t0 = time.perf_counter()
    im = InferenceModel(device=dev).load_zoo(fresh).load_checkpoint(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    got = im.predict(x, batch_size=P18_FIT_BATCH)
    rep = dict(steps=est._py_step, bitwise=bool(np.array_equal(got, want)),
               load_ms=load_ms, versions=sorted(
                   v for v in os.listdir(path) if v.startswith("ckpt-")))
    log(f"phase 18(f) a ResNet-50 fit of {rep['steps']} steps at batch "
        f"{P18_FIT_BATCH} on {kind}, snapshots {rep['versions']}; "
        f"InferenceModel.load_checkpoint into a fresh classifier "
        f"({load_ms:.1f} ms, host): predict bitwise the fitted estimator's "
        f"{rep['bitwise']}")
    if not (rep["bitwise"] and rep["steps"] == P18_FIT_ROWS // P18_FIT_BATCH):
        raise AssertionError(f"18(f): {rep}")
    return rep


def phase_image_path(torch, np, api, kind, dev="cuda"):
    """Phase 18: image classification from images to answers (ROADMAP
    A15's remainder, A11's image part, A16's load_checkpoint) on the
    card; the directory it writes is removed after. No kernel of queue B
    runs on these paths (cuDNN's convolutions, cuBLAS's and cuBLASLt's
    products; JAX runs them outside Pallas)."""
    import shutil
    from analytics_zoo_tpu_torch.ops import _build
    shutil.rmtree(P18_DIR, ignore_errors=True)
    os.makedirs(P18_DIR)
    t0 = time.perf_counter()
    rep = {}
    _build.reset_launch_counts()
    try:
        rep["a"] = p18_archs(torch, np, kind, dev)
        rep["b"], keep = p18_import(torch, np, kind, dev)
        rep["c"], x = p18_image_set(torch, np, keep["clf"], keep["twin"],
                                    kind, dev)
        rep["d"] = p18_serving(torch, np, api, keep["clf"], x, kind, dev)
        del keep
        rep["e"] = p18_int8(torch, np, kind, dev)
        rep["f"] = p18_snapshot(torch, np, kind, dev)
    finally:
        shutil.rmtree(P18_DIR, ignore_errors=True)
    rep["launches"] = _build.launch_counts()
    rep["seconds"] = time.perf_counter() - t0
    return rep


def p19_texts(np, n, seed=SEED + 19):
    """``n`` texts over a seeded word list of P19_WORDS words drawn by a
    Zipf law (rank r with weight 1 / (r + 1)), each of a length uniform in
    P19_TEXT_TOKENS tokens, with a capital and a full stop; and a label of
    P19_TC's classes each."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    sizes = rng.integers(2, 10, P19_WORDS)
    words = np.array(["".join(rng.choice(letters, k)) for k in sizes])
    weights = 1.0 / np.arange(1, P19_WORDS + 1)
    weights /= weights.sum()
    lo, hi = P19_TEXT_TOKENS
    texts = []
    for length in rng.integers(lo, hi + 1, n):
        text = " ".join(words[rng.choice(P19_WORDS, length, p=weights)])
        texts.append(text[0].upper() + text[1:] + ".")
    labels = rng.integers(0, P19_TC["class_num"], n).astype(np.int32)
    return texts, labels


def p19_pipeline(texts, labels, num_shards):
    """The reference app's TextSet path: tokenize, normalize, word2idx
    (the app's max_words_num), shape_sequence, generate_sample; (the
    TextSet, its ids, its labels)."""
    import numpy as np
    from analytics_zoo_tpu_torch.feature.text import TextSet
    ts = (TextSet.from_texts(texts, labels, num_shards=num_shards)
          .tokenize().normalize().word2idx(max_words_num=P19_VOCAB)
          .shape_sequence(P19_TC["sequence_length"]).generate_sample())
    parts = ts.to_dataset().collect()
    return (ts, np.concatenate([p["x"] for p in parts]),
            np.concatenate([p["y"] for p in parts]))


def p19_text_set(torch, np, kind):
    """19(a): P19_TEXTS texts to samples on the host, timed; the ids of
    four shards bitwise those of one."""
    texts, labels = p19_texts(np, P19_TEXTS)
    t0 = time.perf_counter()
    ts, ids, ys = p19_pipeline(texts, labels, 4)
    ms = (time.perf_counter() - t0) * 1e3 * 1000 / P19_TEXTS
    _, ids1, ys1 = p19_pipeline(texts, labels, 1)
    vocab = ts.get_word_index()
    rep = dict(ms_per_1000_texts=ms, texts=P19_TEXTS, vocab=len(vocab),
               tokens=int(sum(len(t.split()) for t in texts)),
               shards_bitwise=bool(np.array_equal(ids, ids1)
                                   and np.array_equal(ys, ys1)),
               pad_share=float(np.mean(ids == 0)))
    log(f"phase 19(a) on the host of {kind}: {P19_TEXTS} texts "
        f"({rep['tokens']} tokens) to samples of "
        f"{P19_TC['sequence_length']} ids in {ms:.1f} ms per 1000 texts; "
        f"vocabulary {len(vocab)}; {rep['pad_share']:.1%} padding; four "
        f"shards bitwise one: {rep['shards_bitwise']}")
    if not (rep["shards_bitwise"] and len(vocab) == P19_VOCAB
            and ids.dtype == np.int32 and ids.shape == (
                P19_TEXTS, P19_TC["sequence_length"])
            and 0 <= ids.min() and ids.max() <= P19_VOCAB):
        raise AssertionError(f"19(a): {rep}, ids {ids.shape} {ids.dtype}")
    return rep, (ts, ids, ys)


def p19_no_dropout(zoo):
    """Every Dropout of ``zoo``'s graph at rate 0 (a step compared across
    devices: dropout's draws differ between them)."""
    seen, stack = set(), list(zoo.model._graph()[1])
    while stack:
        node = stack.pop()
        if id(node) not in seen:
            seen.add(id(node))
            if type(node.layer).__name__ == "Dropout":
                node.layer.p = 0.0
            stack.extend(node.inputs)


def p19_model(np, what, dtype="float32", state=None):
    """The TextClassifier of ``what`` (an encoder) or KNRM, built under
    ``dtype``'s policy, with weights from the numpy seed or ``state``."""
    from analytics_zoo_tpu_torch.keras import policy
    from analytics_zoo_tpu_torch.models import KNRM, TextClassifier
    with policy.policy_scope(dtype):
        m = KNRM(**P19_KNRM) if what == "knrm" else TextClassifier(
            vocab_size=P19_VOCAB, encoder=what, **P19_TC)
    if state is None:
        seeded_weights(m.model.module, SEED)
        if what == "knrm":
            # random kernel features reach tens, so a glorot head would
            # saturate the sigmoid (logits near -20) and the step would
            # have no gradient; scaled, its logits are of order 1
            import torch
            with torch.no_grad():
                m.model.module.dense_1.weight.mul_(P19_KNRM_HEAD_SCALE)
    else:
        m.model.module.load_state_dict(state)
    return m


class p19_rnn_dtypes:
    """``with p19_rnn_dtypes() as seen:`` the dtype of every recurrent
    layer's outputs inside the block (``keras.layers.run_cell``, which
    the keras layers and Zouwu's nets call)."""

    def __enter__(self):
        from analytics_zoo_tpu_torch.keras import layers
        from analytics_zoo_tpu_torch.zouwu.model import nets
        self.mods, self.orig, seen = (layers, nets), layers.run_cell, []

        def spy(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            seen.append(out.dtype)
            return out
        for mod in self.mods:
            mod.run_cell = spy
        return seen

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.run_cell = self.orig


def p19_step(torch, np, what, x, y, device, dtype="float32", state=None,
             f64=False):
    """One training step of ``what`` on ``x, y`` (dropout off; in float64
    with ``f64``): the loss, the logits (the last Dense's output before
    its activation), the head's gradient, the recurrent outputs' dtypes."""
    from analytics_zoo_tpu_torch.common.flax_compat import Dense
    m = p19_model(np, what, dtype, state)
    p19_no_dropout(m)
    mod = m.model.module
    if f64:
        mod.double()
    loss = "binary_crossentropy" if what == "knrm" else \
        "sparse_categorical_crossentropy"
    m.compile(optimizer="adam", loss=loss, device=device)
    dense = [d for d in mod.modules() if isinstance(d, Dense)][-1]
    seen = {}

    def keep(_mod, _args, out):
        # returns None: a hook's return value would replace the output
        seen.setdefault("logits", out.detach().double().cpu())
    hook = dense.register_forward_hook(keep)
    try:
        with p19_rnn_dtypes() as rnn:
            value, grads = p17_grads(m.model.estimator, x, y)
    finally:
        hook.remove()
    head = "dense_1.weight" if what == "knrm" else "dense_2.weight"
    return dict(loss=value, logits=seen["logits"], head=grads[head],
                rnn_dtypes=sorted({str(d) for d in rnn}))


def p19_against_f64(run, ref):
    return (abs(run["loss"] - ref["loss"]), p17_rel(run["logits"],
                                                    ref["logits"]),
            p17_rel(run["head"], ref["head"]))


def p19_window(torch, est, xs, ys, timed) -> float:
    """ms a step: P19_WARMUP steps, then ``timed`` on the host clock
    between two syncs (bench.py's _measure_step_time)."""
    for _ in range(P19_WARMUP):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / timed * 1e3


def p19_launch_calls(torch, fn) -> int:
    """The kernel launches the CUDA runtime took during ``fn()`` (the
    profiler's host-side launch calls). The CUDA activity alone records
    them: the CPU activity's operator events add nothing to the count and
    took a recurrent TextClassifier step's count from 7.2-7.7 s to
    18.1-19.9 s (dev/launch_count_probe.py)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if "LaunchKernel" in e.key))


def p19_classifiers(torch, np, ids, ys, kind, dev="cuda"):
    """19(b): each encoder in fp32 (TF32 off) and mixed_bfloat16: a fit
    step's ms and samples/s (the batch on the card), predict ms (CUDA
    events), the launches a step, and one step on P19_CHECK_ROWS rows
    against float64 on the CPU. The ids reach the card bitwise."""
    x, y = ids[:P19_BATCH], ys[:P19_BATCH]
    xc, yc = x[:P19_CHECK_ROWS], y[:P19_CHECK_ROWS]
    rep = {}
    with p17_tf32(torch, False):
        for enc in P19_ENCODERS:
            state = p19_model(np, enc).model.module.state_dict()
            ref = p19_step(torch, np, enc, xc, yc, "cpu", state=state,
                           f64=True)
            row = {}
            for dtype in ("float32", "mixed_bfloat16"):
                t0 = time.perf_counter()
                m = p19_model(np, enc, dtype, state)
                m.compile(optimizer="adam",
                          loss="sparse_categorical_crossentropy",
                          device=dev)
                est = m.model.estimator
                xs, ys_ = est._tensors(x), est._tensors(y)
                if not np.array_equal(xs.cpu().numpy(), x):
                    raise AssertionError("19(b): the ids on the card differ")
                ms = p19_window(torch, est, xs, ys_, P19_TIMED[enc])
                # the recurrent encoders' ~20 000 launches a step are
                # profiled once, in fp32 (bf16 adds its casts)
                launches = p19_launch_calls(
                    torch, lambda: est._train_step(xs, ys_)) \
                    if enc == "cnn" or dtype == "float32" else None
                mod = m.model.module.eval()
                with torch.inference_mode():
                    probs = mod(xs)
                    pms = cuda_ms(lambda: mod(xs),
                                  iters=P19_PREDICT_REPS[enc], warmup=1)
                run = p19_step(torch, np, enc, xc, yc, dev, dtype, state)
                dist = p19_against_f64(run, ref)
                limits = (P19_FP32_LIMITS if dtype == "float32"
                          else P19_BF16_LIMITS)[enc]
                row[dtype] = dict(
                    step_ms=ms, samples_per_s=P19_BATCH / ms * 1e3,
                    timed_steps=P19_TIMED[enc], predict_ms=pms,
                    launches_per_step=launches,
                    loss_diff=dist[0], logits_rel=dist[1],
                    head_grad_rel=dist[2], limits=limits,
                    rnn_dtypes=run["rnn_dtypes"],
                    probs_finite=bool(torch.isfinite(probs).all()),
                    seconds=time.perf_counter() - t0)
                log(f"phase 19(b) TextClassifier {enc} {dtype} on {kind}: "
                    f"a fit step of {P19_BATCH} x "
                    f"{P19_TC['sequence_length']} {ms:.3f} ms "
                    f"({P19_BATCH / ms * 1e3:.1f} samples/s, "
                    f"{P19_TIMED[enc]} timed), "
                    f"{'not profiled:' if launches is None else launches} "
                    f"kernel launches "
                    f"a step; predict {pms:.3f} ms (CUDA events); a step "
                    f"on {P19_CHECK_ROWS} rows against float64: loss "
                    f"{dist[0]:.3g}, logits {dist[1]:.3g}, head gradient "
                    f"{dist[2]:.3g} (limits {limits}); recurrent outputs "
                    f"{run['rnn_dtypes']}")
                bad = [d > lim for d, lim in zip(dist, limits)]
                rnn_ok = enc == "cnn" or run["rnn_dtypes"] == [
                    "torch.float32"]
                if any(bad) or not rnn_ok or not row[dtype]["probs_finite"]:
                    raise AssertionError(f"19(b) {enc} {dtype}: {row}")
                del m, est, mod
            rep[enc] = row
    return rep


def p19_twin_served(torch, np, api, ids, kind, dev="cuda"):
    """19(c): the cnn TextClassifier imported from its torch twin
    (models/migration.py) against the twin on the card, then served as
    id records on the native broker: every answer bitwise the predict at
    batch P19_BATCH."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import TextClassifier, migration
    Broker, ClusterServing, InputQueue, OutputQueue = api
    torch.manual_seed(SEED)
    twin = migration.make_torch_text_classifier(
        P19_TC["class_num"], P19_VOCAB, P19_TC["token_length"],
        P19_TC["encoder_output_dim"])
    tc = TextClassifier(vocab_size=P19_VOCAB, encoder="cnn", **P19_TC)
    migration.import_text_classifier_from_torch(tc, twin)
    x = ids[:P19_BATCH].astype(np.float32)
    rep = {}
    with p17_tf32(torch, False):
        twin = twin.to(dev).eval()
        with torch.inference_mode():
            want = twin(torch.as_tensor(x, device=dev)).cpu().numpy()
        im = InferenceModel(device=dev).load_zoo(tc)
        refs = im.predict(x, batch_size=P19_BATCH)
        rep["max_abs_diff"] = float(np.abs(refs - want).max())
        rep["top1_equal"] = bool((refs.argmax(-1) == want.argmax(-1)).all())
        with Broker.launch(backend="native") as b, \
                ClusterServing(im, b.port, batch_size=P19_BATCH,
                               max_batch_size=P19_BATCH,
                               warmup=False) as eng:
            iq, oq = InputQueue(port=b.port), OutputQueue(port=b.port)
            t0 = time.perf_counter()
            uris = iq.enqueue_batch((f"p19t{i}", {"x": x[i]})
                                    for i in range(len(x)))
            got = oq.query_many(uris, timeout=120, poll_interval=0.002)
            served_s = time.perf_counter() - t0
            metrics = eng.metrics()
            iq.close()
            oq.close()
    bad = [i for i in range(len(x)) if got.get(f"p19t{i}") is None
           or not np.array_equal(got[f"p19t{i}"], refs[i])]
    rep.update(records=len(x), records_per_s=len(x) / served_s,
               not_bitwise=len(bad), batches=metrics["batches"])
    log(f"phase 19(c) the cnn TextClassifier imported from its torch twin "
        f"on {kind}: max |port - twin| {rep['max_abs_diff']:.3g} (atol "
        f"{P19_TWIN_ATOL}), top-1 equal {rep['top1_equal']}; {len(x)} id "
        f"records served at {rep['records_per_s']:.1f} records/s, not "
        f"bitwise the predict at batch {P19_BATCH}: {len(bad)}")
    if rep["max_abs_diff"] > P19_TWIN_ATOL or not rep["top1_equal"] or bad:
        raise AssertionError(f"19(c): {rep}")
    return rep


def p19_knrm_data(np, n, seed):
    """``n`` rows of query (text1_length) and document (text2_length) ids
    over KNRM's vocabulary; each document repeats some of its query's
    words (the exact-match kernel's work); labels 0/1."""
    rng = np.random.default_rng(seed)
    t1, t2 = P19_KNRM["text1_length"], P19_KNRM["text2_length"]
    q = rng.integers(1, P19_KNRM["vocab_size"] + 1, (n, t1))
    d = rng.integers(1, P19_KNRM["vocab_size"] + 1, (n, t2))
    for i in range(n):
        k = int(rng.integers(0, t1 + 1))
        d[i, rng.choice(t2, k, replace=False)] = q[i, rng.choice(t1, k)]
    x = np.concatenate([q, d], 1).astype(np.float32)
    return x, rng.integers(0, 2, (n, 1)).astype(np.float32)


def p19_knrm(torch, np, kind, dev="cuda"):
    """19(d): KNRM's fit ms a step and predict ms; NDCG@3 and MAP over
    P19_QUERIES queries of P19_CANDIDATES candidates from the card's
    scores equal to those from the CPU's; one step against float64."""
    from analytics_zoo_tpu_torch.models.textmatching import (evaluate_map,
                                                             evaluate_ndcg)
    x, y = p19_knrm_data(np, P19_KNRM_BATCH, SEED + 20)
    rep = {}
    with p17_tf32(torch, False):
        m = p19_model(np, "knrm")
        state = m.model.module.state_dict()
        m.compile(optimizer="adam", loss="binary_crossentropy", device=dev)
        est = m.model.estimator
        xs, ys = est._tensors(x), est._tensors(y)
        rep["step_ms"] = p19_window(torch, est, xs, ys, P19_TIMED["cnn"])
        mod = m.model.module.eval()
        with torch.inference_mode():
            rep["predict_ms"] = cuda_ms(lambda: mod(xs), iters=20, warmup=2)
        xq, _ = p19_knrm_data(np, P19_QUERIES * P19_CANDIDATES, SEED + 21)
        labels = np.random.default_rng(SEED + 22).integers(
            0, 3, (P19_QUERIES, P19_CANDIDATES))
        card = m.predict(xq, batch_size=len(xq)).reshape(labels.shape)
        cpu = p19_model(np, "knrm", state=mod.state_dict()).predict(
            xq, batch_size=len(xq), device="cpu").reshape(labels.shape)
        metrics = {}
        for name, scores in (("card", card), ("cpu", cpu)):
            metrics[name] = (
                [evaluate_ndcg(labels[i], scores[i], k=3)
                 for i in range(P19_QUERIES)],
                [evaluate_map(labels[i], scores[i])
                 for i in range(P19_QUERIES)])
        xc, yc = x[:P19_CHECK_ROWS], y[:P19_CHECK_ROWS]
        ref = p19_step(torch, np, "knrm", xc, yc, "cpu", state=state,
                       f64=True)
        run = p19_step(torch, np, "knrm", xc, yc, dev, state=state)
    dist = p19_against_f64(run, ref)
    rep.update(ndcg3=float(np.mean(metrics["card"][0])),
               map=float(np.mean(metrics["card"][1])),
               metrics_equal=metrics["card"] == metrics["cpu"],
               score_diff=float(np.abs(card - cpu).max()),
               loss_diff=dist[0], logits_rel=dist[1], head_grad_rel=dist[2],
               limits=P19_FP32_LIMITS["knrm"])
    log(f"phase 19(d) KNRM on {kind} (batch {P19_KNRM_BATCH}, "
        f"{P19_KNRM['text1_length']} x {P19_KNRM['text2_length']} ids, "
        f"{P19_KNRM['embed_dim']}-d, {P19_KNRM['kernel_num']} kernels): a "
        f"fit step {rep['step_ms']:.3f} ms, predict {rep['predict_ms']:.3f}"
        f" ms (CUDA events); NDCG@3 {rep['ndcg3']:.4f}, MAP "
        f"{rep['map']:.4f} over {P19_QUERIES} queries, equal to the CPU's: "
        f"{rep['metrics_equal']} (scores within {rep['score_diff']:.3g}); "
        f"a step against float64: loss {dist[0]:.3g}, logits {dist[1]:.3g},"
        f" head gradient {dist[2]:.3g} (limits {rep['limits']})")
    if not rep["metrics_equal"] or any(
            d > lim for d, lim in zip(dist, P19_FP32_LIMITS["knrm"])):
        raise AssertionError(f"19(d): {rep}")
    return rep


def p19_glove(torch, np, ts, ids, ys, kind, dev="cuda"):
    """19(e): a frozen WordEmbedding.from_glove over a GloVe-format file
    of (a)'s vocabulary (P19_GLOVE_DIM-d, seeded) under the cnn encoder:
    after 2 fit steps its table is bitwise what the file gave, and it has
    no parameter, gradient or optimizer state."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as zl
    vocab = ts.get_word_index()
    rng = np.random.default_rng(SEED + 23)
    vecs = [[f"{v:.6f}" for v in row] for row in rng.normal(
        0, 0.3, (len(vocab), P19_GLOVE_DIM))]
    path = os.path.join(P19_DIR, "glove.txt")
    with open(path, "w") as fh:
        for (word, _), vec in zip(sorted(vocab.items(), key=lambda w: w[1]),
                                  vecs):
            fh.write(word + " " + " ".join(vec) + "\n")
    inp = Input(shape=(P19_TC["sequence_length"],))
    emb = zl.WordEmbedding.from_glove(path, vocab, P19_GLOVE_DIM,
                                      name="glove")
    h = zl.Conv1D(P19_TC["encoder_output_dim"], 5, activation="relu")(
        emb(inp))
    out = zl.Dense(P19_TC["class_num"], activation="softmax")(
        zl.GlobalMaxPooling1D()(h))
    model = Model(input=inp, output=out)
    seeded_weights(model.module, SEED)
    table = model.module.glove.table.clone()
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device=dev)
    hist = model.fit(ids[:2 * P19_BATCH], ys[:2 * P19_BATCH],
                     batch_size=P19_BATCH, nb_epoch=1)
    est = model.estimator
    rep = dict(
        table_bitwise=bool(torch.equal(model.module.glove.table.cpu(),
                                       table)),
        from_file=bool(np.array_equal(table.numpy()[1:],
                                      np.asarray(vecs, np.float32))),
        trainable=est._names, loss=hist["loss"][0],
        table_is_parameter=any(p is model.module.glove.table
                               for p in model.module.parameters()))
    opt = est._ensure_opt_state()
    rep["opt_state_leaves"] = sum(len(v) for v in opt.values()
                                  if isinstance(v, list))
    log(f"phase 19(e) a frozen WordEmbedding.from_glove ({len(vocab)} x "
        f"{P19_GLOVE_DIM}) on {kind}: after 2 steps the table is bitwise "
        f"the file's {rep['table_bitwise'] and rep['from_file']}; trained "
        f"{rep['trainable']}; optimizer state leaves "
        f"{rep['opt_state_leaves']}; loss {rep['loss']:.4f}")
    if not (rep["table_bitwise"] and rep["from_file"]
            and not rep["table_is_parameter"]
            and not any(n.startswith("glove") for n in est._names)
            and np.isfinite(rep["loss"])):
        raise AssertionError(f"19(e): {rep}")
    return rep


def p19_hf_state(np, cfg):
    """A HuggingFace ``BertModel`` state dict with BERT-Base, Uncased's
    names and shapes, from numpy seed 0 (normal(0, 0.02); the norms'
    scales about 1)."""
    import torch
    rng = np.random.default_rng(SEED)
    H, inter = cfg.hidden_size, cfg.intermediate_size
    shapes = {"embeddings.word_embeddings.weight": (cfg.vocab, H),
              "embeddings.position_embeddings.weight":
                  (cfg.max_position_len, H),
              "embeddings.token_type_embeddings.weight": (cfg.type_vocab, H),
              "embeddings.LayerNorm.weight": (H,),
              "embeddings.LayerNorm.bias": (H,),
              "pooler.dense.weight": (H, H), "pooler.dense.bias": (H,)}
    for i in range(cfg.n_block):
        p = f"encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            shapes.update({f"{p}.{name}.weight": (H, H),
                           f"{p}.{name}.bias": (H,)})
        shapes.update({
            f"{p}.attention.output.LayerNorm.weight": (H,),
            f"{p}.attention.output.LayerNorm.bias": (H,),
            f"{p}.intermediate.dense.weight": (inter, H),
            f"{p}.intermediate.dense.bias": (inter,),
            f"{p}.output.dense.weight": (H, inter),
            f"{p}.output.dense.bias": (H,),
            f"{p}.output.LayerNorm.weight": (H,),
            f"{p}.output.LayerNorm.bias": (H,)})
    sd = {}
    for key, shape in shapes.items():
        arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if key.endswith("LayerNorm.weight"):
            arr += np.float32(1.0)
        sd[key] = torch.from_numpy(arr)
    return sd


def p19_hf_flax(np, sd, cfg):
    """The same dict as the JAX package's flax tree (its hf_bert_params:
    q/k/v kernels [hidden, heads, dim], the output [heads, dim, hidden],
    Dense kernels transposed), for ``convert.flax_to_state_dict``."""
    h, d, H = cfg.n_head, cfg.head_dim, cfg.hidden_size

    def arr(key):
        return sd[key].numpy()

    def dense(p):
        return {"kernel": arr(f"{p}.weight").T, "bias": arr(f"{p}.bias")}

    def norm(p):
        return {"scale": arr(f"{p}.weight"), "bias": arr(f"{p}.bias")}

    def qkv(p):
        return {"kernel": arr(f"{p}.weight").T.reshape(H, h, d),
                "bias": arr(f"{p}.bias").reshape(h, d)}
    tree = {
        "word_embeddings": {"embedding": arr(
            "embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": arr(
            "embeddings.position_embeddings.weight")},
        "token_type_embeddings": {"embedding": arr(
            "embeddings.token_type_embeddings.weight")},
        "embed_norm": norm("embeddings.LayerNorm"),
        "pooler": dense("pooler.dense")}
    for i in range(cfg.n_block):
        p = f"encoder.layer.{i}"
        tree[f"block_{i}"] = {
            "attention": {
                "query": qkv(f"{p}.attention.self.query"),
                "key": qkv(f"{p}.attention.self.key"),
                "value": qkv(f"{p}.attention.self.value"),
                "out": {"kernel": arr(f"{p}.attention.output.dense.weight"
                                      ).T.reshape(h, d, H),
                        "bias": arr(f"{p}.attention.output.dense.bias")}},
            "attn_norm": norm(f"{p}.attention.output.LayerNorm"),
            "intermediate": dense(f"{p}.intermediate.dense"),
            "output": dense(f"{p}.output.dense"),
            "ffn_norm": norm(f"{p}.output.LayerNorm")}
    return tree


def p19_bert(torch, np, kind, dev="cuda"):
    """19(f): a HuggingFace-layout BERT-Base dict through load_hf_bert into
    a bf16 BERTClassifier(2) that has taken one fine-tuning step (the
    fine-tuning flow, and the step's flop count out of the way): the
    encoder bitwise the dict, the head unchanged, the step and epoch 0;
    predict of 32 x 512 against the same weights loaded through convert
    (phase 6's limit), one flash forward a block (12); then 2 fine-tuning
    steps at 32 x 128, each launching 12 flash forwards and 12 of each
    backward. The inputs carry no mask, so attention takes the flash path
    (an all-ones mask, as BERTClassifier.fit and predict pass, takes the
    einsum chain)."""
    from analytics_zoo_tpu_torch.convert import flax_to_state_dict
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.text import (BERTClassifier, BertConfig,
                                              hf_bert_params)
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    cfg = BertConfig(use_flash=True, dtype=torch.bfloat16)
    sd = p19_hf_state(np, cfg)
    rep = {}
    rng = np.random.RandomState(SEED + 24)
    b, s = P19_BERT_PREDICT
    ids = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    seg = (np.arange(s)[None] >= rng.randint(1, s, (b, 1))).astype(np.int32)
    bt, st = P19_BERT_TRAIN
    tid = rng.randint(0, cfg.vocab, (bt * (P19_BERT_STEPS + 1), st)
                      ).astype(np.int32)
    tseg = np.zeros_like(tid)
    lab = rng.randint(0, BERT_CLASSES, len(tid)).astype(np.int32)
    with p17_tf32(torch, False):
        clf = BERTClassifier(BERT_CLASSES, seq_len=s, device=dev,
                             config=cfg)
        est, model = clf.estimator, clf.estimator.model
        est.fit(((tid[:bt], tseg[:bt]), lab[:bt]), epochs=1, batch_size=bt)
        head = {k: v.detach().clone() for k, v in
                model.classifier.state_dict().items()}
        t0 = time.perf_counter()
        clf.load_hf(sd)
        rep["load_ms"] = (time.perf_counter() - t0) * 1e3
        got = model.bert.state_dict()
        mapped = hf_bert_params(sd, cfg)
        rep["encoder_bitwise"] = all(torch.equal(got[k].cpu(), v)
                                     for k, v in mapped.items())
        rep["encoder_leaves"] = len(mapped)
        rep["head_unchanged"] = all(
            torch.equal(v, head[k])
            for k, v in model.classifier.state_dict().items())
        rep["step_after_load"] = (est._py_step, est._epoch)
        _build.reset_launch_counts()
        y16 = est.predict((ids, seg), batch_size=b)
        rep["predict_flash_launches"] = _build.launch_counts().get(
            "flash_attention_fwd", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.predict((ids, seg), batch_size=b)
        rep["bf16_predict_ms"] = (time.perf_counter() - t0) * 1e3
        with torch.device(dev):
            # made on the card (torch's default init, overwritten next)
            ref = _ClassifierModule(cfg, BERT_CLASSES)
        ref.bert.load_state_dict(flax_to_state_dict(p19_hf_flax(np, sd,
                                                                cfg)))
        ref.classifier.load_state_dict(model.classifier.state_dict())
        with torch.inference_mode():
            y_conv = ref.eval()(torch.as_tensor(ids, device=dev),
                                torch.as_tensor(seg, device=dev))
        rep["bf16_diff_convert"] = float(np.abs(
            y16 - y_conv.float().cpu().numpy()).max())
        del ref
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        hist = est.fit(((tid[bt:], tseg[bt:]), lab[bt:]), epochs=1,
                       batch_size=bt)
        rep["step_ms"] = (time.perf_counter() - t0) / P19_BERT_STEPS * 1e3
        counts = _build.launch_counts()
        rep["loss"] = hist["loss"][0]
        rep["step_after_fit"] = (est._py_step, est._epoch)
        del clf, est, model
        torch.cuda.empty_cache()
    per_step = {n: counts.get(n, 0) / P19_BERT_STEPS for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}
    rep["train_launches_per_step"] = per_step
    log(f"phase 19(f) load_hf_bert of a HuggingFace-layout BERT-Base dict "
        f"into a bf16 BERTClassifier on {kind}: {rep['encoder_leaves']} "
        f"encoder tensors bitwise {rep['encoder_bitwise']}, head unchanged "
        f"{rep['head_unchanged']}, step and epoch after it "
        f"{rep['step_after_load']}, loaded in {rep['load_ms']:.1f} ms; "
        f"predict {b} x {s} {rep['bf16_predict_ms']:.3f} ms (host clock), "
        f"{rep['predict_flash_launches']} flash forwards, max |load_hf - "
        f"convert| {rep['bf16_diff_convert']:.3g} (atol {BERT_BF16_ATOL}); "
        f"fine-tuning {bt} x {st}: {rep['step_ms']:.3f} ms a step, loss "
        f"{rep['loss']:.4f}, flash launches a step {per_step}")
    if not (rep["encoder_bitwise"] and rep["head_unchanged"]
            and rep["step_after_load"] == (0, 0)
            and rep["step_after_fit"] == (P19_BERT_STEPS, 1)
            and rep["predict_flash_launches"] == cfg.n_block
            and rep["bf16_diff_convert"] <= BERT_BF16_ATOL
            and all(v == cfg.n_block for v in per_step.values())
            and np.isfinite(rep["loss"])):
        raise AssertionError(f"19(f): {rep}")
    return rep


def p19_forecasters(torch, np, kind, dev="cuda"):
    """19(g): LSTMForecaster and Seq2SeqForecaster at bench.py's TCN batch
    in fp32 (TF32 off) and mixed_bfloat16 from the same weights: ms a
    step (the batch on the card), predict's distance from the fp32 net
    in float64 on the CPU, the recurrent outputs' dtype."""
    import copy
    from analytics_zoo_tpu_torch.zouwu.model.forecast import (
        LSTMForecaster, Seq2SeqForecaster,
    )
    x, y = tcn_bench_data(np)
    rep = {}
    with p17_tf32(torch, False):
        for name, make in (("lstm", LSTMForecaster),
                           ("seq2seq", Seq2SeqForecaster)):
            row, ref = {}, None
            for dtype in ("float32", "mixed_bfloat16"):
                f = make(dtype=dtype, device=dev)
                est = f._ensure_est(x)
                seeded_weights(est.model, SEED)
                if ref is None:
                    net = copy.deepcopy(est.model).cpu().double().eval()
                    with torch.no_grad():
                        ref = net(torch.from_numpy(x.astype(np.float64)))
                xs, ys = est._tensors(x), est._tensors(y)
                ms = p19_window(torch, est, xs, ys, P19_FC_TIMED)
                seeded_weights(est.model, SEED)
                with p19_rnn_dtypes() as seen:
                    pred = f.predict(x, batch_size=len(x))
                rel = p17_rel(torch.from_numpy(pred), ref)
                row[dtype] = dict(step_ms=ms, predict_rel_f64=rel,
                                  limit=P19_FC_RTOL[dtype],
                                  rnn_dtypes=sorted({str(d) for d in seen}))
                log(f"phase 19(g) {name} forecaster {dtype} on {kind}: a "
                    f"step of {TCN_BATCH} x {TCN_LOOKBACK} x {TCN_FEATURES} "
                    f"{ms:.3f} ms; predict against float64 {rel:.3g} "
                    f"(limit {P19_FC_RTOL[dtype]}); recurrent outputs "
                    f"{row[dtype]['rnn_dtypes']}")
                if rel > P19_FC_RTOL[dtype] or \
                        row[dtype]["rnn_dtypes"] != ["torch.float32"]:
                    raise AssertionError(f"19(g) {name}: {row}")
                del f, est
            rep[name] = row
    return rep


def p19_ncf_from_keras(torch, np, x, y, kind):
    """19(h): NeuralCF at MovieLens-1M width through Estimator.from_keras
    (Adam, batch BATCH): a warm-up step, then P19_NCF_STEPS steps with 2
    lookups and 4 scatter-adds each; loss and parameters bitwise the same
    model through compile and fit."""
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    n = BATCH * P19_NCF_STEPS
    a, b = train_model("ncf"), train_model("ncf")
    est = Estimator.from_keras(keras_model=a,
                               loss="sparse_categorical_crossentropy",
                               optimizer=Adam(NCF_LR))
    b.compile(optimizer=Adam(NCF_LR), loss="sparse_categorical_crossentropy")
    est.fit((x[:BATCH], y[:BATCH]), epochs=1, batch_size=BATCH)
    b.fit(x[:BATCH], y[:BATCH], batch_size=BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    got, launches, fit_s = counted(torch, lambda: est.fit(
        (x[:n], y[:n]), epochs=1, batch_size=BATCH, shuffle=False))
    want = b.fit(x[:n], y[:n], batch_size=BATCH, nb_epoch=1, shuffle=False)
    same = all(torch.equal(p, q) for p, q in zip(
        a.module.state_dict().values(), b.module.state_dict().values()))
    per_step = {k: v / P19_NCF_STEPS for k, v in launches.items() if v}
    rep = dict(step_ms=fit_s / P19_NCF_STEPS * 1e3, loss=got["loss"][0],
               loss_bitwise=got["loss"] == want["loss"],
               step_losses_bitwise=est.step_losses[-P19_NCF_STEPS:]
               == b.estimator.step_losses[-P19_NCF_STEPS:],
               params_bitwise=same, launches=launches,
               launches_per_step=per_step, same_estimator=a.estimator is est)
    log(f"phase 19(h) NeuralCF through Estimator.from_keras on {kind}: "
        f"{P19_NCF_STEPS} steps of {BATCH} at {rep['step_ms']:.3f} ms/step,"
        f" loss {rep['loss']:.5f}; loss and parameters bitwise compile/fit:"
        f" {rep['loss_bitwise'] and rep['step_losses_bitwise']}, "
        f"{same}; launches a step {per_step}")
    if not (rep["loss_bitwise"] and rep["step_losses_bitwise"] and same
            and rep["same_estimator"]
            and launches.get("fused_embedding_lookup") == 2 * P19_NCF_STEPS
            and launches.get("embedding_scatter_add") == 4 * P19_NCF_STEPS):
        raise AssertionError(f"19(h): {rep}")
    return rep


def p19_part(rep, key, fn, no_queue_b=False, phase=19):
    """Run one part of phase 19 (or ``phase``) with the launch counts set
    to 0 just before it and read just after; ``no_queue_b``: the part
    fails if any kernel of queue B launched."""
    from analytics_zoo_tpu_torch.ops import _build
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    rep.setdefault("part_seconds", {})[key] = time.perf_counter() - t0
    rep.setdefault("launches", {})[key] = counts
    if no_queue_b and counts:
        raise AssertionError(f"{phase}({key}) launched kernels of queue B: "
                             f"{counts}")
    return out


def phase_text(torch, np, api, kind, dev="cuda"):
    """Phase 19: text from words to answers (ROADMAP A16's rest, A8, A11's
    text part) on the card; the directory it writes is removed after.
    The counts are zeroed before each of (b)-(h) and read after it: (b)-(e)
    and (g) launch no kernel of queue B (cuBLAS, cuDNN and PyTorch's
    kernels, the lookups plain ``embedding_lookup``, as JAX's are jnp.take),
    (f) launches B3-B5 and (h) B1 and B1b."""
    import shutil
    shutil.rmtree(P19_DIR, ignore_errors=True)
    os.makedirs(P19_DIR)
    t0 = time.perf_counter()
    rep = {}
    try:
        rep["a"], (ts, ids, ys) = p19_text_set(torch, np, kind)
        rep["b"] = p19_part(rep, "b", lambda: p19_classifiers(
            torch, np, ids, ys, kind, dev), no_queue_b=True)
        rep["c"] = p19_part(rep, "c", lambda: p19_twin_served(
            torch, np, api, ids, kind, dev), no_queue_b=True)
        rep["d"] = p19_part(rep, "d", lambda: p19_knrm(torch, np, kind, dev),
                            no_queue_b=True)
        rep["e"] = p19_part(rep, "e", lambda: p19_glove(
            torch, np, ts, ids, ys, kind, dev), no_queue_b=True)
        rep["f"] = p19_part(rep, "f", lambda: p19_bert(torch, np, kind, dev))
        rep["g"] = p19_part(rep, "g", lambda: p19_forecasters(
            torch, np, kind, dev), no_queue_b=True)
        x, y, _ = ncf_train_data(np)
        rep["h"] = p19_part(rep, "h", lambda: p19_ncf_from_keras(
            torch, np, x, y, kind))
    finally:
        shutil.rmtree(P19_DIR, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t0
    log(f"phase 19: no kernel of queue B in (b)-(e) and (g); launches by "
        f"part {rep['launches']}; seconds by part "
        f"{ {k: round(v, 1) for k, v in rep['part_seconds'].items()} }")
    return rep


# ---------------------------------------------------------------------------
# phase 20: Zouwu's AutoTS (ROADMAP A11's Zouwu and AutoML half): from a
# time series to a searched, saved and reloaded forecaster, the population
# search, MTNet, TCMF at the electricity panel's width and the anomaly
# detectors. No kernel of queue B is on these paths.

P20_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "phase20")
# NAB realKnownCause/nyc_taxi.csv: 10 320 half-hourly rows from
# 2014-07-01, one value column, daily and weekly seasonality; split 80/10/10
# in time
P20_ROWS = 10_320
P20_SPLIT = (8256, 1032)            # train, validation; the rest is test
# cuts to keep phase 20 under 90 s (its first run took 134 s on the H100,
# a later one 92.0 s on a slower host): GridRandomRecipe's 2 epochs to 1
# in (a) (the LSTM trial took 34 s of it), the serial search beside the
# population to 1 epoch of the first 4 of its 16 configs in (d) (compared
# by the ms of a member-epoch; 8 before (d) ran its deterministic twin),
# TCNGridRandomRecipe's 4 draws to 2 in (e) (4 trials, not 8); no width is
# cut
P20_GRID_EPOCHS = 1
P20_POP_K = 16                      # (d): the population
P20_POP_EPOCHS = 1                  # 2 until slice 26 (129 steps an epoch)
P20_SERIAL_K = 4
P20_SERIAL_EPOCHS = 1
P20_POP_BATCH = 64
P20_POP_TCN = dict(num_channels=(30, 30, 30), kernel_size=3)
P20_POP_LR = (1e-4, 3e-2)
P20_PAR_SAMPLES = 2                 # (e): TCNGridRandomRecipe, 2 x 2 trials
P20_HIST_RTOL = 1e-6                # (e): n_parallel 4 against 1
P20_PRED_RTOL = 1e-5                # (b), (h): the card against the CPU
P20_MEMBER_ATOL = 1e-5              # (d): a member against itself alone
# (d): one step of every member against a plain AdamWeightDecay step, on
# the parameters whose plain gradient is at least P20_FIRST_GRAD_FLOOR
# (100 eps). Adam's first update is g / (|g| + eps): where |g| is near eps
# the gradients' rounding moves it by up to lr (1.8e-3 on the CPU at lr
# 3e-2). Elsewhere the two agree to 1.2e-7 on the CPU (96% of the
# parameters); a decay left out moves a parameter by lr·wd·|p| (3.8e-4 on
# the CPU), one added before scale_by_adam by 5.9e-2
P20_FIRST_GRAD_FLOOR = 1e-6
P20_FIRST_ATOL = 1e-6
# MTNetGridRandomRecipe's widest: 4 memories of 8 steps (40 back)
P20_MTNET = dict(long_num=4, time_step=8, cnn_height=3, cnn_hid_size=32,
                 rnn_hid_sizes=(16, 32), ar_window=4, cnn_dropout=0.0,
                 rnn_dropout=0.0)
P20_MTNET_BATCH = 64
P20_TIMED = 5                       # (f): 2 warm-up steps, 5 timed
P20_CHECK_ROWS = 8
# (f): one MTNet step on 8 rows against float64 on the CPU, as (loss,
# output, head gradient): the loss's absolute difference, the output's
# and the head gradient's distance over float64's norm. Basis: python3
# dev/estimate_zouwu_limits.py (the same step on the CPU; its readings in
# the comments); fp32 (TF32 off) 10x to 50x past them, bf16 about 4x
# (a development machine's CPU; the H100 machine's CPU):
P20_MTNET_FP32_LIMITS = (1e-5, 5e-6, 5e-6)   # 2.06e-9, 1.82e-7, 6.73e-8;
#                                              2.68e-9, 7.09e-8, 4.78e-7
P20_MTNET_BF16_LIMITS = (1e-3, 0.025, 0.03)  # 1.94e-4, 5.62e-3, 3.53e-3;
#                                              1.34e-6, 8.70e-4, 7.05e-3
# DeepGLO's electricity panel (Table 1 of the DeepGLO paper): 370 series
# x 25 968 hourly steps; TCMFForecaster's default rank 64
P20_TCMF = (370, 25_968)
P20_TCMF_RANK = 64
P20_TCMF_STEPS = 300
P20_TCMF_INCR = 24
P20_TCMF_LOCAL_COLS = 256           # use_local=True: a cut, named (512
#                                     until slice 26)
P20_TCMF_PROFILED = 10              # steps under the profiler
# (g): F and X from the SVD start against the same 300 steps in float64,
# as the largest difference, and the final mse, relative: P20_TCMF_FACTOR times the CPU's own fp32
# distance (dev/estimate_zouwu_limits.py --part tcmf at the full width,
# on the H100 machine's CPU: F 0.0150, X 0.00923, mse 2.8e-8 relative),
# the factor two fp32 routes stood apart on the CPU
# (tests/test_torch_tcmf.py: 1.8x) with room
P20_TCMF_CPU_FX = (0.0150, 0.00923)
P20_TCMF_CPU_MSE = 2.8e-8           # the final mse's, relative
P20_TCMF_FACTOR = 3.0
P20_AE = dict(roll_len=24, hidden=(16, 8))


def p20_frames(np):
    """A seeded series of nyc_taxi's length and shape: half-hourly from
    2014-07-01, a daily and a weekly cycle and noise around 15 000, split
    80/10/10 in time."""
    import pandas as pd
    rng = np.random.default_rng(SEED + 30)
    t = np.arange(P20_ROWS)
    v = (15_000 + 7_000 * np.sin(2 * np.pi * t / 48 - 1.9)
         + 2_500 * np.sin(2 * np.pi * t / 336)
         + rng.normal(0, 900, P20_ROWS))
    df = pd.DataFrame({"timestamp": pd.date_range(
        "2014-07-01", periods=P20_ROWS, freq="30min"), "value": v})
    a, b = P20_SPLIT
    return df, df.iloc[:a], df.iloc[a:a + b], df.iloc[a + b:]


def p20_panel(np, cols):
    """A seeded panel of the electricity data's shape: 370 hourly series,
    each a loading of daily, weekly and slow cycles plus its own level
    and noise, ``cols`` steps (float32)."""
    rng = np.random.default_rng(SEED + 31)
    t = np.arange(cols)
    basis = [np.sin(2 * np.pi * k * t / p + ph) for p, ks in
             ((24, (1, 2, 3)), (168, (1, 2)), (8766, (1,)))
             for k in ks for ph in (0.0, 1.3)]
    basis = np.stack(basis)
    n = P20_TCMF[0]
    load = rng.gamma(2.0, 1.0, (n, len(basis)))
    y = load @ basis + rng.uniform(2, 10, (n, 1)) \
        + rng.normal(0, 0.3, (n, cols))
    return y.astype(np.float32)


def p20_part(rep, key, fn):
    """One part of phase 20: no kernel of queue B may launch in it."""
    return p19_part(rep, key, fn, no_queue_b=True, phase=20)


def p20_trials_ok(trials, part):
    """Every trial ends done (or stopped by a scheduler), never in error:
    a CUDA failure inside a trial must fail the phase."""
    bad = [(t.trial_id, t.status, t.error) for t in trials
           if t.status not in ("done", "stopped")]
    if bad:
        raise AssertionError(f"20({part}) trials did not finish: {bad}")


def p20_trial_rows(trials):
    return [dict(id=t.trial_id, config={k: str(v) for k, v in
                                        t.config.items()},
                 history=t.metric_history, status=t.status,
                 wall_s=t.wall_s) for t in trials]


def p20_autots(torch, np, frames, kind, dev="cuda"):
    """20(a): AutoTSTrainer with GridRandomRecipe() at its defaults
    (VanillaLSTM and TCN x 1 draw, look_back 24) but for its epochs
    (P20_GRID_EPOCHS, a cut) on the series;
    each trial's config, metric history, status and seconds, the best
    trial; the pipeline's predict ms, evaluate (mse, smape), an
    incremental fit; save -> TSPipeline.load predicts bitwise the same;
    each trial's fit step (ms, 2 warm-up and 5 timed at its batch on the
    card) and its kernel launches (profiler)."""
    from analytics_zoo_tpu_torch.zouwu.autots import (AutoTSTrainer,
                                                      TSPipeline)
    from analytics_zoo_tpu_torch.zouwu.config import GridRandomRecipe
    _, train, val, test = frames
    rep = {}
    t0 = time.perf_counter()
    trainer = AutoTSTrainer(dt_col="timestamp", target_col="value",
                            horizon=1, logs_dir=P20_DIR, name="grid",
                            device=dev)
    ts = trainer.fit(train, val, recipe=GridRandomRecipe(
        epochs=P20_GRID_EPOCHS), metric="mse")
    rep["fit_s"] = time.perf_counter() - t0
    trials = trainer.engine.trials
    p20_trials_ok(trials, "a")
    rep["trials"] = p20_trial_rows(trials)
    for row in rep["trials"]:
        log(f"phase 20(a) trial {row['id']} {row['config']}: history "
            f"{row['history']}, {row['status']}, {row['wall_s']:.2f} s")
    best = trainer.engine.get_best_trial()
    rep["best"] = dict(id=best.trial_id, metric=best.best_metric)
    pred = ts.predict(test)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred = ts.predict(test)
    torch.cuda.synchronize()
    rep["predict_ms"] = (time.perf_counter() - t1) * 1e3
    rep["evaluate"] = ts.evaluate(test, metrics=["mse", "smape"])
    t1 = time.perf_counter()
    ts.fit(val, epochs=1)
    rep["incremental_fit_s"] = time.perf_counter() - t1
    rep["evaluate_after_incremental"] = ts.evaluate(test,
                                                    metrics=["mse", "smape"])
    path = os.path.join(P20_DIR, "pipeline")
    ts.save(path)
    pred = ts.predict(test)
    loaded = TSPipeline.load(path, device=dev)
    rep["reload_bitwise"] = bool(np.array_equal(loaded.predict(test), pred))
    # each trial's step: its model rebuilt, a batch on the card
    steps = {}
    for t in trials:
        m = trainer.builder.build(t.config)
        x, y = m.transformer.fit_transform(train)
        est = m.forecaster._ensure_est(x)
        bs = int(t.config.get("batch_size", 32))
        xs, ys = est._tensors(x[:bs]), est._tensors(y[:bs])
        ms = p19_window(torch, est, xs, ys, P20_TIMED)
        calls = p19_launch_calls(torch, lambda: est._train_step(xs, ys))
        steps[t.trial_id] = dict(model=t.config["model"], batch=bs,
                                 step_ms=ms, launches=calls)
    rep["steps"] = steps
    log(f"phase 20(a) AutoTS GridRandomRecipe on {kind}: {len(trials)} "
        f"trials in {rep['fit_s']:.1f} s, best {rep['best']}; predict "
        f"{len(pred)} windows {rep['predict_ms']:.1f} ms; evaluate "
        f"{rep['evaluate']}; incremental fit {rep['incremental_fit_s']:.2f} "
        f"s, then {rep['evaluate_after_incremental']}; reload bitwise "
        f"{rep['reload_bitwise']}; a fit step by trial {steps}")
    if not rep["reload_bitwise"]:
        raise AssertionError("20(a): the reloaded pipeline predicts "
                             "otherwise")
    for v in list(rep["evaluate"].values()) + \
            list(rep["evaluate_after_incremental"].values()):
        if not np.isfinite(v):
            raise AssertionError(f"20(a): evaluate {rep['evaluate']}")
    return rep, path, pred


def p20_card_vs_cpu(np, frames, path, pred, kind):
    """20(b): the saved pipeline loaded on the CPU predicts within
    P20_PRED_RTOL of the card (relative to the largest forecast; TF32
    off)."""
    from analytics_zoo_tpu_torch.zouwu.autots import TSPipeline
    cpu = TSPipeline.load(path, device="cpu").predict(frames[3])
    rel = float(np.abs(cpu - pred).max() / np.abs(cpu).max())
    log(f"phase 20(b) the best pipeline on {kind} against the CPU: "
        f"{rel:.3g} of the largest forecast (limit {P20_PRED_RTOL})")
    if rel > P20_PRED_RTOL:
        raise AssertionError(f"20(b): card against CPU {rel}")
    return dict(rel=rel)


def p20_bayes(np, frames, kind, dev="cuda"):
    """20(c): BayesRecipe(num_samples=3, epochs=1), sequential; each config
    the one the CPU's BayesSearcher proposes from the same observed
    metrics."""
    from analytics_zoo_tpu_torch.automl.search import BayesSearcher
    from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config import BayesRecipe
    _, train, val, _ = frames
    recipe = BayesRecipe(num_samples=3, epochs=1)
    trainer = AutoTSTrainer(dt_col="timestamp", target_col="value",
                            horizon=1, logs_dir=P20_DIR, name="bayes",
                            device=dev)
    t0 = time.perf_counter()
    trainer.fit(train, val, recipe=recipe)
    secs = time.perf_counter() - t0
    trials = trainer.engine.trials
    p20_trials_ok(trials, "c")
    searcher = BayesSearcher(recipe.search_space(), "min",
                             seed=trainer.engine.seed)
    same = []
    for t in trials:
        same.append(searcher.suggest() == t.config)
        searcher.observe(t.config, t.best_metric)
    rows = p20_trial_rows(trials)
    log(f"phase 20(c) BayesRecipe on {kind}: {secs:.1f} s; trials {rows}; "
        f"configs as the CPU's searcher proposes {same}")
    if not all(same):
        raise AssertionError(f"20(c): configs differ from the searcher's "
                             f"{same}")
    return dict(seconds=secs, trials=rows, same_configs=same)


class p20_deterministic:
    """``with p20_deterministic(torch):`` cuDNN's deterministic algorithms,
    the flag put back after."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.saved = self.cudnn.deterministic
        self.cudnn.deterministic = True

    def __exit__(self, *exc):
        self.cudnn.deterministic = self.saved


def p20_first_step(torch, np, creator, x, y, dev):
    """One step of P20_POP_K members on one batch (lr and weight decay
    drawn per member) against each member's plain step: its module's mse
    on the same batch through autograd, then learn.optimizers'
    AdamWeightDecay (optax's adamw) with the member's rate and decay.
    Returns the largest parameter difference where the plain gradient is
    at least P20_FIRST_GRAD_FLOOR, and the share of parameters held."""
    from analytics_zoo_tpu_torch.automl import PopulationSearchEngine, hp
    from analytics_zoo_tpu_torch.automl.model_builder import build_module
    from analytics_zoo_tpu_torch.learn.optimizers import AdamWeightDecay
    xb, yb = x[:P20_POP_BATCH], y[:P20_POP_BATCH]
    pop = PopulationSearchEngine(creator, logs_dir=P20_DIR, name="first",
                                 seed=SEED, device=dev)
    pop.compile((xb, yb), {"lr": hp.loguniform(*P20_POP_LR),
                           "weight_decay": hp.uniform(0.0, 1e-2)},
                n_sampling=P20_POP_K, batch_size=P20_POP_BATCH)
    pop.run()
    p20_trials_ok(pop.trials, "d")
    xs, ys = (torch.from_numpy(np.asarray(a)).to(dev) for a in (xb, yb))
    errs, kept = [], [0, 0]
    for k, t in enumerate(pop.trials):
        module = build_module(creator, t.config).to(dev).eval()
        names = [n for n, _ in module.named_parameters()]
        params = [p for _, p in module.named_parameters()]
        loss = torch.mean((module(xs, train=False) - ys) ** 2)
        grads = list(torch.autograd.grad(loss, params))
        opt = AdamWeightDecay(float(t.config["lr"]),
                              float(t.config["weight_decay"]),
                              epsilon=1e-8)
        with torch.no_grad():
            opt.step(params, grads, opt.init(params), 0)
        got = pop.member_state_dict(k)
        for n, p, g in zip(names, params, grads):
            keep = (g.abs() >= P20_FIRST_GRAD_FLOOR).cpu()
            d = (got[n] - p.detach().cpu()).abs()
            errs.append(float(d[keep].max()) if keep.any() else 0.0)
            kept[0] += int(keep.sum())
            kept[1] += keep.numel()
    return max(errs), kept[0] / kept[1]


def p20_population(torch, np, frames, kind, dev="cuda"):
    """20(d): PopulationSearchEngine over P20_POP_K TemporalConvNets at the
    recipes' widest TCN on the training windows (batch 64, 1 epoch, lr
    log-uniform), LocalSearchEngine training the same configs serially
    from the same initial weights (P20_SERIAL_K of them for
    P20_SERIAL_EPOCHS, a cut: they compare by the ms of a member-epoch);
    one member against the same member trained alone from the same start
    (both under cudnn.deterministic, the population once more), and one
    step of every member against a plain AdamWeightDecay step
    (p20_first_step)."""
    from analytics_zoo_tpu_torch.automl import (LocalSearchEngine,
                                                PopulationSearchEngine, hp)
    from analytics_zoo_tpu_torch.automl.model_builder import (
        TorchModelBuilder)
    from analytics_zoo_tpu_torch.zouwu.feature import (
        TimeSequenceFeatureTransformer)
    from analytics_zoo_tpu_torch.zouwu.model.nets import TemporalConvNet
    _, train, val, _ = frames
    tf = TimeSequenceFeatureTransformer(past_seq_len=24, dt_col="timestamp",
                                        target_col="value")
    x, y = tf.fit_transform(train)
    vxy = tf.transform(val)
    feats = x.shape[-1]

    def creator(config):
        return TemporalConvNet(feats, future_seq_len=1, dropout=0.2,
                               **P20_POP_TCN)

    space = {"lr": hp.loguniform(*P20_POP_LR)}
    # torch.func's first vmap imports torch._dynamo and sympy (seconds,
    # once a process): a one-step run pays it before the clock starts
    first_err, first_share = p20_first_step(torch, np, creator, x, y, dev)
    pop = PopulationSearchEngine(creator, logs_dir=P20_DIR, name="pop",
                                 seed=SEED, device=dev)
    pop.compile((x, y), space, n_sampling=P20_POP_K, epochs=P20_POP_EPOCHS,
                validation_data=vxy, metric="mse", batch_size=P20_POP_BATCH)
    t0 = time.perf_counter()
    pop.run()
    pop_s = time.perf_counter() - t0
    p20_trials_ok(pop.trials, "d")
    member_ms = sum(pop.epoch_seconds) * 1e3 / (P20_POP_K * P20_POP_EPOCHS)
    serial = LocalSearchEngine(TorchModelBuilder(creator, device=dev),
                               logs_dir=P20_DIR, name="serial", seed=SEED,
                               device=dev)
    serial.compile((x, y), dict(space, batch_size=P20_POP_BATCH),
                   n_sampling=P20_SERIAL_K, epochs=P20_SERIAL_EPOCHS,
                   validation_data=vxy, metric="mse")
    for s, p in zip(serial.trials, pop.trials):
        s.config = dict(p.config, batch_size=P20_POP_BATCH)
    t0 = time.perf_counter()
    serial.run()
    serial_s = time.perf_counter() - t0
    p20_trials_ok(serial.trials, "d")
    k = pop.get_best_trial().trial_id
    # member k against itself alone, both under cudnn.deterministic: with
    # cuDNN's default weight-gradient engine (atomics) one run in five
    # branches to another outcome (PERF.md, Open questions); the
    # population as users run it is printed against its deterministic twin
    with p20_deterministic(torch):
        twin = PopulationSearchEngine(creator, logs_dir=P20_DIR,
                                      name="twin", seed=SEED, device=dev)
        twin.compile((x, y), space, n_sampling=P20_POP_K,
                     epochs=P20_POP_EPOCHS, validation_data=vxy,
                     metric="mse", batch_size=P20_POP_BATCH)
        twin.run()
        p20_trials_ok(twin.trials, "d")
        alone = PopulationSearchEngine(creator, logs_dir=P20_DIR,
                                       name="alone", seed=SEED, device=dev)
        # the same start: member k is built from its config's seed
        alone.compile((x, y), {"lr": pop.trials[k].config["lr"],
                               "seed": pop.trials[k].config["seed"]},
                      n_sampling=1, epochs=P20_POP_EPOCHS,
                      validation_data=vxy, metric="mse",
                      batch_size=P20_POP_BATCH)
        alone.run()
    a, b = twin.member_state_dict(k), alone.member_state_dict(0)
    member_err = max(float((a[n] - b[n]).abs().max()) for n in a)
    d = pop.member_state_dict(k)
    default_err = max(float((d[n] - a[n]).abs().max()) for n in a)
    rep = dict(pop_s=pop_s, serial_s=serial_s,
               ms_per_member_epoch=member_ms,
               serial_ms_per_member_epoch=serial_s * 1e3
               / (P20_SERIAL_K * P20_SERIAL_EPOCHS),
               best=k,
               best_metric=pop.trials[k].best_metric,
               serial_best=serial.get_best_trial().best_metric,
               member_err=member_err, default_err=default_err,
               first_step_err=first_err, first_step_share=first_share,
               histories=[t.metric_history for t in pop.trials])
    rep["speedup"] = rep["serial_ms_per_member_epoch"] / member_ms
    log(f"phase 20(d) population of {P20_POP_K} TCNs {P20_POP_TCN} on "
        f"{len(x)} windows on {kind}: {pop_s:.2f} s "
        f"({member_ms:.1f} ms a member-epoch), serial {serial_s:.2f} s "
        f"for {P20_SERIAL_EPOCHS} epoch of {P20_SERIAL_K} configs "
        f"({rep['serial_ms_per_member_epoch']:.1f} ms a member-epoch), "
        f"speedup a member-epoch {rep['speedup']:.2f}x; best member {k} "
        f"{rep['best_metric']:.5g}; member {k} against itself alone, "
        f"deterministic, {member_err:.3g} (limit {P20_MEMBER_ATOL}); the "
        f"population with cuDNN's defaults against it deterministic "
        f"{default_err:.3g} (not held); a first step of "
        f"each member against a plain AdamWeightDecay {first_err:.3g} "
        f"(limit {P20_FIRST_ATOL}) on the {first_share:.1%} of parameters "
        f"whose gradient is at least {P20_FIRST_GRAD_FLOOR}")
    if member_err > P20_MEMBER_ATOL:
        raise AssertionError(f"20(d): member against alone {member_err}")
    if first_err > P20_FIRST_ATOL:
        raise AssertionError(f"20(d): first step against a plain "
                             f"AdamWeightDecay {first_err}")
    return rep


def p20_parallel(torch, np, frames, kind, dev="cuda"):
    """20(e): TCNGridRandomRecipe(num_rand_samples=P20_PAR_SAMPLES,
    epochs=1): 4 trials (8 with 4 draws, a cut), with
    n_parallel=4 (four threads on the card, each on its own stream)
    and n_parallel=1: wall seconds of each, the metric histories within
    P20_HIST_RTOL relative, and whether they are bitwise, both under
    cudnn.deterministic; then n_parallel=4 with cuDNN's defaults, as users
    run it, printed against them. cuDNN's default weight-gradient engine
    sums with atomics: runs differ by 1e-7 a step, and now and then a
    trial branches to another outcome (4.88e-2 apart; PERF.md, Open
    questions; dev/zouwu_path_torch.py --determinism and --population)."""
    from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config import TCNGridRandomRecipe
    _, train, val, _ = frames
    runs = {}

    def search(n_par, name):
        trainer = AutoTSTrainer(dt_col="timestamp", target_col="value",
                                horizon=1, logs_dir=P20_DIR,
                                name=name, device=dev, n_parallel=n_par)
        t0 = time.perf_counter()
        trainer.fit(train, val, recipe=TCNGridRandomRecipe(
            num_rand_samples=P20_PAR_SAMPLES, epochs=1))
        secs = time.perf_counter() - t0
        p20_trials_ok(trainer.engine.trials, "e")
        return dict(seconds=secs, histories=[
            t.metric_history for t in trainer.engine.trials])

    with p20_deterministic(torch):
        for n_par in (1, 4):
            runs[n_par] = search(n_par, f"par{n_par}")
    runs["default"] = search(4, "default")
    h1, h4, hd = (np.asarray(runs[n]["histories"], np.float64)
                  for n in (1, 4, "default"))
    rel = float((np.abs(h4 - h1) / np.abs(h1)).max())
    rel_default = float((np.abs(hd - h1) / np.abs(h1)).max())
    bitwise = bool(np.array_equal(h1, h4))
    log(f"phase 20(e) {len(h1)} TCN trials on {kind}, deterministic: "
        f"n_parallel=1 {runs[1]['seconds']:.2f} s, n_parallel=4 "
        f"{runs[4]['seconds']:.2f} s; histories {rel:.3g} apart relative "
        f"(limit {P20_HIST_RTOL}), bitwise {bitwise}; n_parallel=4 with "
        f"cuDNN's defaults {runs['default']['seconds']:.2f} s, "
        f"{rel_default:.3g} from n_parallel=1 deterministic (not held)")
    if rel > P20_HIST_RTOL:
        raise AssertionError(f"20(e): histories {runs}")
    return dict(runs=runs, rel=rel, bitwise=bitwise,
                rel_default=rel_default)


def p20_mtnet_step(torch, module, x, y, dev, f64=False):
    """One MTNet step's loss, output and the head's gradient (train=False,
    mse), on ``dev``; ``f64``: the module and data in float64."""
    dt = torch.float64 if f64 else torch.float32
    module = module.to(dev)
    xs = torch.from_numpy(x).to(dev, dt)
    ys = torch.from_numpy(y).to(dev, dt)
    out = module(xs, train=False)
    loss = torch.mean((out.to(dt) - ys) ** 2)
    (grad,) = torch.autograd.grad(loss, [module.head.weight])
    return dict(loss=float(loss.detach()),
                logits=out.detach().double().cpu(),
                head=grad.detach().double().cpu())


def p20_mtnet(torch, np, frames, kind, dev="cuda"):
    """20(f): MTNet at MTNetGridRandomRecipe's widest, batch 64, in fp32
    (TF32 off) and mixed_bfloat16 from the same weights: a fit step's ms
    (2 warm-up, 5 timed) and launches, predict ms (CUDA events), and one
    step on 8 rows against float64 on the CPU (loss, output, head
    gradient) at P20_MTNET_*_LIMITS."""
    import copy
    from analytics_zoo_tpu_torch.zouwu.feature import (
        TimeSequenceFeatureTransformer)
    from analytics_zoo_tpu_torch.zouwu.model.forecast import MTNetForecaster
    _, train, _, _ = frames
    back = (P20_MTNET["long_num"] + 1) * P20_MTNET["time_step"]
    x, y = TimeSequenceFeatureTransformer(
        past_seq_len=back, dt_col="timestamp",
        target_col="value").fit_transform(train)
    xc, yc = x[:P20_CHECK_ROWS], y[:P20_CHECK_ROWS]
    rep, ref, state = {}, None, None
    for dtype in ("float32", "mixed_bfloat16"):
        f = MTNetForecaster(future_seq_len=1, dtype=dtype, device=dev,
                            **P20_MTNET)
        est = f._ensure_est(x)
        if state is None:
            state = copy.deepcopy(est.model.state_dict())
            net = copy.deepcopy(est.model).cpu().double()
            ref = p20_mtnet_step(torch, net, xc, yc, "cpu", f64=True)
        est.model.load_state_dict(state)
        run = p20_mtnet_step(torch, est.model, xc, yc, dev)
        got = p19_against_f64(run, ref)
        xs = est._tensors(x[:P20_MTNET_BATCH])
        ys = est._tensors(y[:P20_MTNET_BATCH])
        ms = p19_window(torch, est, xs, ys, P20_TIMED)
        calls = p19_launch_calls(torch, lambda: est._train_step(xs, ys))
        xp = x[:1024]
        pred_ms = cuda_ms(lambda: f.predict(xp, batch_size=1024), iters=3,
                          warmup=1)
        limits = (P20_MTNET_FP32_LIMITS if dtype == "float32"
                  else P20_MTNET_BF16_LIMITS)
        rep[dtype] = dict(step_ms=ms, launches=calls, predict_ms=pred_ms,
                          against_f64=got, limits=limits)
        log(f"phase 20(f) MTNet {dtype} on {kind}: a step of "
            f"{P20_MTNET_BATCH} x {back} x {x.shape[-1]} {ms:.2f} ms, "
            f"{calls} launches; predict 1024 rows {pred_ms:.2f} ms; a step "
            f"on {P20_CHECK_ROWS} rows against float64 (loss, output, head "
            f"gradient) {tuple(f'{v:.3g}' for v in got)}, limits {limits}")
        if any(g > lim for g, lim in zip(got, limits)):
            raise AssertionError(f"20(f) MTNet {dtype}: {got} > {limits}")
    return rep


def p20_tcmf_profile(torch, m, y, f0, x0):
    """Launches a factorization step and the device's busy share over
    P20_TCMF_PROFILED steps (the profiler's launch calls and the device
    time of what ran)."""
    m._init_factors = lambda _: (f0.copy(), x0.copy())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        m._run_factorization(y, P20_TCMF_PROFILED, None)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    calls = sum(e.count for e in ka if "LaunchKernel" in e.key)
    busy_us = sum(e.self_device_time_total for e in ka)
    return calls / P20_TCMF_PROFILED, busy_us * 1e-6 / wall


def p20_tcmf(torch, np, kind, dev="cuda"):
    """20(g): TCMFForecaster(rank=64, svd=True) at the electricity panel's
    width: fit(num_steps=300) seconds, ms a factorization step (host
    clock), launches a step and the device's busy share (profiler), the
    final mse, predict(24) ms, fit_incremental of 24 columns, save/load
    bitwise; F, X and the final mse against the same steps in float64 on
    the card from the same SVD start; use_local=True on the first 256 columns with
    max_TCN_epoch=1 (a cut)."""
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster
    n, t = P20_TCMF
    panel = p20_panel(np, t + P20_TCMF_INCR)
    y = panel[:, :t]
    m = TCMFForecaster(rank=P20_TCMF_RANK, svd=True, device=dev)
    kept = {}
    svd_init = m._init_factors

    def keep(yy):
        kept["fx"] = svd_init(yy)
        return tuple(a.copy() for a in kept["fx"])

    m._init_factors = keep
    t0 = time.perf_counter()
    mse = m.fit(y, num_steps=P20_TCMF_STEPS)
    fit_s = time.perf_counter() - t0
    f0, x0 = kept["fx"]
    timed = TCMFForecaster(rank=P20_TCMF_RANK, device=dev)
    timed._init_factors = lambda _: (f0.copy(), x0.copy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed._run_factorization(y, P20_TCMF_STEPS, None)
    step_ms = (time.perf_counter() - t0) * 1e3 / P20_TCMF_STEPS
    launches, busy = p20_tcmf_profile(torch, timed, y, f0, x0)
    ref = TCMFForecaster(rank=P20_TCMF_RANK, device=dev)
    ref._init_factors = lambda _: (f0.astype(np.float64),
                                   x0.astype(np.float64))
    mse64 = ref._run_factorization(y.astype(np.float64), P20_TCMF_STEPS,
                                   None)
    fx = (float(np.abs(m.F - ref.F).max()), float(np.abs(m.X - ref.X).max()))
    limits = tuple(P20_TCMF_FACTOR * c for c in P20_TCMF_CPU_FX)
    mse_rel = abs(mse - mse64) / abs(mse64)
    mse_limit = P20_TCMF_FACTOR * P20_TCMF_CPU_MSE
    t0 = time.perf_counter()
    pred = m.predict(24)
    predict_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    m.fit_incremental(panel[:, t:])
    incr_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(P20_DIR, "tcmf")
    m.save(path)
    back = TCMFForecaster.load(path, device=dev)
    reload_bitwise = bool(np.array_equal(back.predict(24), m.predict(24)))
    t0 = time.perf_counter()
    local = TCMFForecaster(rank=P20_TCMF_RANK, svd=True, use_local=True,
                           device=dev)
    local.fit(y[:, :P20_TCMF_LOCAL_COLS], num_steps=P20_TCMF_STEPS,
              max_TCN_epoch=1)
    local_pred = local.predict(24)
    local_s = time.perf_counter() - t0
    rep = dict(fit_s=fit_s, step_ms=step_ms, launches_per_step=launches,
               device_busy_share=busy, mse=mse, predict_ms=predict_ms,
               incremental_ms=incr_ms, fx_against_f64=fx, limits=limits,
               mse_f64=mse64, mse_rel=mse_rel, mse_limit=mse_limit,
               reload_bitwise=reload_bitwise, local_s=local_s,
               local_finite=bool(np.isfinite(local_pred).all()),
               devices_used=m.fit_report["devices_used"])
    log(f"phase 20(g) TCMF {n} x {t} rank {P20_TCMF_RANK} on {kind}: fit "
        f"{fit_s:.2f} s ({P20_TCMF_STEPS} steps, the SVD start on the "
        f"host), {step_ms:.3f} ms a step, {launches:.1f} launches a step, "
        f"device busy {busy:.1%}; mse {mse:.5g} (float64 {mse64:.5g}, "
        f"{mse_rel:.3g} relative, limit {mse_limit:.3g}); predict(24) "
        f"{predict_ms:.1f} ms; fit_incremental({P20_TCMF_INCR}) "
        f"{incr_ms:.1f} ms; F, X against float64 {fx} (limits {limits}); "
        f"reload bitwise {reload_bitwise}; use_local on the first "
        f"{P20_TCMF_LOCAL_COLS} columns (a cut) with max_TCN_epoch=1 "
        f"{local_s:.2f} s")
    if not (reload_bitwise and rep["local_finite"] and np.isfinite(mse)
            and np.isfinite(pred).all()):
        raise AssertionError(f"20(g): {rep}")
    if fx[0] > limits[0] or fx[1] > limits[1]:
        raise AssertionError(f"20(g): F, X against float64 {fx} > {limits}")
    if mse_rel > mse_limit:
        raise AssertionError(f"20(g): mse against float64 {mse_rel} > "
                             f"{mse_limit}")
    return rep


def p20_anomaly(torch, np, frames, kind, dev="cuda"):
    """20(h): AEDetector (roll_len 24, hidden (16, 8)) on the 10 320-step
    series: fit ms; scores within P20_PRED_RTOL of the CPU's from the same
    weights (relative to the largest score) and the same anomaly indexes;
    ThresholdDetector over the scores alike; DBScanDetector raises
    ModuleNotFoundError naming scikit-learn where it is absent."""
    import copy
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.zouwu.model.anomaly import (
        AEDetector, DBScanDetector, ThresholdDetector)
    series = frames[0]["value"].to_numpy()
    det = AEDetector(device=dev, **P20_AE)
    t0 = time.perf_counter()
    det.fit(series)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = det.epochs * ((len(series) - det.roll_len + 1) // det.batch_size)
    card = det.score(series)
    cpu = AEDetector(device="cpu", **P20_AE)
    cpu._mu, cpu._sigma = det._mu, det._sigma
    cpu._est = Estimator.from_torch(model=copy.deepcopy(det._est.model).cpu(),
                                    loss="mse", device="cpu")
    host = cpu.score(series)
    rel = float(np.abs(card - host).max() / np.abs(host).max())
    same_idx = bool(np.array_equal(det.anomaly_indexes(series),
                                   cpu.anomaly_indexes(series)))
    th_card = ThresholdDetector(ratio=3.0).fit(card)
    th_host = ThresholdDetector(ratio=3.0).fit(host)
    same_th = bool(np.array_equal(th_card.anomaly_indexes(card),
                                  th_host.anomaly_indexes(host)))
    try:
        DBScanDetector().anomaly_indexes(series[:500])
        dbscan = "scikit-learn present: ran"
    except ModuleNotFoundError as e:
        if "scikit-learn" not in str(e):
            raise
        dbscan = f"raises {type(e).__name__}: {e}"
    rep = dict(fit_s=fit_s, fit_ms_per_step=fit_s * 1e3 / steps,
               rel=rel, same_indexes=same_idx, same_threshold=same_th,
               dbscan=dbscan)
    log(f"phase 20(h) AEDetector on {kind}: fit {fit_s:.2f} s "
        f"({rep['fit_ms_per_step']:.3f} ms a step); scores against the "
        f"CPU {rel:.3g} (limit {P20_PRED_RTOL}); anomaly indexes equal "
        f"{same_idx}, ThresholdDetector's {same_th}; DBScanDetector "
        f"{dbscan}")
    if rel > P20_PRED_RTOL or not same_idx or not same_th:
        raise AssertionError(f"20(h): {rep}")
    return rep


def phase_zouwu(torch, np, kind, dev="cuda"):
    """Phase 20: Zouwu's AutoTS on the card (ROADMAP A11's Zouwu and AutoML
    half), TF32 off; the directory it writes is removed after. The counts
    are zeroed before each of (a)-(h) and read after it: none launches a
    kernel of queue B (cuBLAS, cuDNN and PyTorch's own kernels)."""
    import shutil
    from analytics_zoo_tpu_torch.learn import estimator
    shutil.rmtree(P20_DIR, ignore_errors=True)
    os.makedirs(P20_DIR)
    log_dir = estimator.DEFAULT_LOG_DIR
    estimator.DEFAULT_LOG_DIR = os.path.join(P20_DIR, "tb")
    t0 = time.perf_counter()
    rep = {}
    frames = p20_frames(np)
    try:
        with p17_tf32(torch, False):
            rep["a"], path, pred = p20_part(rep, "a", lambda: p20_autots(
                torch, np, frames, kind, dev))
            rep["b"] = p20_part(rep, "b", lambda: p20_card_vs_cpu(
                np, frames, path, pred, kind))
            rep["c"] = p20_part(rep, "c", lambda: p20_bayes(
                np, frames, kind, dev))
            rep["d"] = p20_part(rep, "d", lambda: p20_population(
                torch, np, frames, kind, dev))
            rep["e"] = p20_part(rep, "e", lambda: p20_parallel(
                torch, np, frames, kind, dev))
            rep["f"] = p20_part(rep, "f", lambda: p20_mtnet(
                torch, np, frames, kind, dev))
            rep["g"] = p20_part(rep, "g", lambda: p20_tcmf(
                torch, np, kind, dev))
            rep["h"] = p20_part(rep, "h", lambda: p20_anomaly(
                torch, np, frames, kind, dev))
    finally:
        estimator.DEFAULT_LOG_DIR = log_dir
        shutil.rmtree(P20_DIR, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t0
    log(f"phase 20: no kernel of queue B in (a)-(h); seconds by part "
        f"{ {k: round(v, 1) for k, v in rep['part_seconds'].items()} }")
    return rep


# ---------------------------------------------------------------- phase 21
P21_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "phase21")
P21_CLASSES = 20                    # PASCAL VOC's classes (+ background)
P21_BATCH = 32
P21_WARMUP = 2
P21_TIMED = 5
P21_FIT_STEPS = 4                   # a fit under the step profiler
P21_LR, P21_MOMENTUM = 1e-3, 0.9    # ssd.pytorch's train.py defaults
P21_FLOPS_MARGIN = 0.03
P21_CONVS = 35                      # SSD300-VGG's convolutions
P21_CHECK_ROWS = 1                  # (a): the card against the CPU
P21_F64_LOSS_RTOL = 1e-9            # float64, card against CPU
P21_F64_HEAD_RTOL = 1e-8            # the heads' gradient, of its norm
P21_FP32_OVER_CPU = 1.5             # fp32 card: within 1.5x the CPU fp32's
P21_FP32_FLOOR = 1e-6               # own distance from float64, or this
#                                     (H100: loss 7.46e-8, heads 6.86e-7;
#                                     the CPU's 2.14e-7, 6.61e-7)
# bf16 on the card against float64, about 4x its readings (H100: 2.49e-3,
# 7.84e-3; the CPU's bf16 2.19e-3, 8.01e-3). Basis: python3
# dev/estimate_detection_limits.py (the CPU's fp32 and bf16 step)
P21_BF16_LOSS_RTOL = 0.01
P21_BF16_HEAD_RTOL = 0.03
P21_IMAGES = 32                     # (b): ObjectDetector.predict
P21_PREDICT_REPS = 5
P21_TWIN_STD = 0.02                 # the twin's kernels, as JAX's test tames
P21_TWIN_RTOL = 1e-3                # JAX tests/test_migration_image.py:157
P21_CONF = 0.4                      # (b): 35-36 rows an image, under
#                                     keep_top_k (at 0.3 every image fills
#                                     its 100 and the cut splits near-ties)
P21_ROW_ATOL = 1e-5                 # (b): card rows against the CPU's
P21_FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "detection")
P21_OVERFIT_EPOCHS = 400            # (c): JAX tests/test_model_zoo.py:446
P21_OVERFIT_REPEAT = 8
P21_OVERFIT_BATCH = 16
P21_OVERFIT_LR = 3e-3
P21_OVERFIT_LOOP = 8
P21_MAP = 0.99
P21_HOOK_ROWS = 64                  # (d): the hooks' fit, SSDLite(1, 64 px)
P21_HOOK_BATCH = 16
P21_INT8_ROWS = 128                 # (e): phase 19's GRU TextClassifier
P21_INT8_CALIB = 2                  # calibration batches of P21_INT8_ROWS
P21_INT8_REPS = 3
P21_INT8_AGREE = 0.9                # argmax agreement with fp32
P21_INT8_ATOL = 0.05                # of the softmax outputs
P21_LAYER_ATOL = 1e-5               # (e): the new layers, card vs CPU
P21_RECORDS = 8                     # (f): records of each kind
P21_RECORD_ATOL = 1e-5              # (f): served against the direct predict


def p21_images(np, n, seed=SEED + 21):
    """``n`` images uniform in [0, 1) and 1-5 ground-truth boxes each
    (centres in [0.2, 0.8], sides in [0.1, 0.4], labels 1..20)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 300, 300, 3)).astype(np.float32)
    boxes, labels = [], []
    for _ in range(n):
        g = int(rng.integers(1, 6))
        c = rng.uniform(0.2, 0.8, (g, 2))
        wh = rng.uniform(0.1, 0.4, (g, 2))
        boxes.append(np.clip(np.concatenate([c - wh / 2, c + wh / 2], 1),
                             0, 1).astype(np.float32))
        labels.append(rng.integers(1, P21_CLASSES + 1, g))
    return x, boxes, labels


def p21_weights(np, module, seed):
    """SSD300-VGG's weights from a numpy seed: each convolution He-normal
    over its fan-in, the biases 0, the L2Norm's scale 20 (its init)."""
    import torch
    rng = np.random.RandomState(seed)
    state = {}
    for key, val in module.state_dict().items():
        shape = tuple(val.shape)
        if key.endswith(".weight") and len(shape) == 2:
            arr = rng.standard_normal(shape) * np.sqrt(2.0 / shape[1])
        elif key.endswith(".weight"):
            arr = np.full(shape, 20.0)
        else:
            arr = np.zeros(shape)
        state[key] = torch.from_numpy(arr.astype(np.float32))
    module.load_state_dict(state)


def p21_ssd(np, dtype="float32", state=None, seed=SEED + 21):
    """SSD300VGG(20), built under ``dtype``'s policy, its weights from
    the numpy seed or ``state``."""
    from analytics_zoo_tpu_torch.keras import policy
    from analytics_zoo_tpu_torch.models import SSD300VGG
    with policy.policy_scope(dtype):
        ssd = SSD300VGG(P21_CLASSES)
    if state is None:
        p21_weights(np, ssd.model.module, seed)
    else:
        ssd.model.module.load_state_dict(state)
    return ssd


def p21_compile(ssd, device=None):
    from analytics_zoo_tpu_torch.learn.optimizers import SGD
    ssd.compile(optimizer=SGD(learningrate=P21_LR, momentum=P21_MOMENTUM),
                loss=ssd.loss(), device=device)
    return ssd.model.estimator


def p21_window(torch, est, xs, ys) -> float:
    for _ in range(P21_WARMUP):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P21_TIMED):
        est._train_step(xs, ys)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / P21_TIMED * 1e3


def p21_profile(torch, fn, label):
    """One call of ``fn`` under the profiler (after a call outside it):
    its kernels, device-busy ms, host wall ms, the idle share and the
    device ms of the sorts (the loss's mining) and of the convolutions."""
    import re
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(label):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(P21_DIR, f"{label}.pt.trace.json")
    prof.export_chrome_trace(path)
    events = trace_events(path)
    host = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == label]
    if not host:
        raise AssertionError(f"21: {label}'s range is not in the trace")
    lo, hi = host[0]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    end = max((e["ts"] + e.get("dur", 0) for e in kernels), default=hi)
    wall = (max(hi, end) - lo) / 1e3
    conv = re.compile(P17_CONV_KERNEL)
    sort_ms = sum(e.get("dur", 0) for e in kernels
                  if re.search(r"(?i)sort|radix", e["name"])) / 1e3
    conv_ms = sum(e.get("dur", 0) for e in kernels
                  if conv.search(e["name"])) / 1e3
    return dict(kernels=len(kernels), device_busy_ms=busy, wall_ms=wall,
                busy_share=busy / wall if wall else None,
                idle_share=max(0.0, 1 - busy / wall) if wall else None,
                sort_ms=sort_ms, conv_ms=conv_ms)


def p21_train(torch, np, kind):
    """21(a) the path: SSD300-VGG(20) at batch 32 x 300 x 300 through
    compile(SGD, ssd.loss()) in fp32 (TF32 off) and mixed_bfloat16: the
    step window, launches a step, the profiled step's busy share, peak
    memory, and a fit under the step profiler (zoo_step_flops against the
    hand count, zoo_mfu)."""
    from analytics_zoo_tpu_torch.common import telemetry
    x, boxes, labels = p21_images(np, P21_BATCH)
    rep = {}
    states = {}
    for dtype in ("float32", "mixed_bfloat16"):
        label = "fp32" if dtype == "float32" else "bf16"
        ssd = p21_ssd(np, dtype)
        states[label] = {k: v.clone() for k, v in
                         ssd.model.module.state_dict().items()}
        y = ssd.encode_ground_truth(boxes, labels)
        est = p21_compile(ssd)
        xs, ys = est._tensors(x), est._tensors(y)
        torch.cuda.reset_peak_memory_stats()
        r = dict(step_ms=p21_window(torch, est, xs, ys))
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        r["samples_per_sec"] = P21_BATCH / r["step_ms"] * 1e3
        r["launches_per_step"] = p19_launch_calls(
            torch, lambda: est._train_step(xs, ys))
        r["profile"] = p21_profile(torch, lambda: est._train_step(xs, ys),
                                   f"p21_{label}_step")
        xf = np.concatenate([x] * P21_FIT_STEPS)
        yf = np.concatenate([y] * P21_FIT_STEPS)
        telemetry.reset_for_tests()
        t0 = time.perf_counter()
        hist = ssd.fit(xf, yf, batch_size=P21_BATCH, nb_epoch=1,
                       shuffle=False)
        torch.cuda.synchronize()
        r["fit_ms_per_step"] = (time.perf_counter() - t0) / P21_FIT_STEPS \
            * 1e3
        snap = telemetry.snapshot()
        r["step_flops"] = snap.get("zoo_step_flops")
        r["mfu"] = snap.get("zoo_mfu")
        r["fit_loss"] = hist["loss"][-1]
        telemetry.reset_for_tests()
        if label == "fp32":
            rep["hand"] = p17_hand_flops(torch, ssd.model.module, xs)
        hand = rep["hand"]["step"]
        r["hand_tflops_per_s"] = hand / r["step_ms"] / 1e9
        rep[label] = r
        ok = (hand <= (r["step_flops"] or 0) <= hand * (1 + P21_FLOPS_MARGIN)
              and r["mfu"] is not None and 0 < r["mfu"] <= 1
              and np.isfinite(r["fit_loss"])
              and rep["hand"]["convs"] == P21_CONVS)
        log(f"phase 21(a) SSD300-VGG({P21_CLASSES}) {label} training on "
            f"{kind}, batch {P21_BATCH} x 300 px, SGD(lr {P21_LR}, momentum "
            f"{P21_MOMENTUM}), {P21_WARMUP} warm-up and {P21_TIMED} timed "
            f"steps: {r['step_ms']:.3f} ms a step "
            f"({r['samples_per_sec']:.1f} samples/s, "
            f"{r['hand_tflops_per_s']:.1f} TFLOP/s of the hand count "
            f"{hand / 1e12:.3f} TFLOP), {r['launches_per_step']} launches a "
            f"step, profiled step: {r['profile']['device_busy_ms']:.3f} ms "
            f"busy of {r['profile']['wall_ms']:.3f} (busy share "
            f"{r['profile']['busy_share']:.3f}; convolutions "
            f"{r['profile']['conv_ms']:.3f} ms, the mining's sorts "
            f"{r['profile']['sort_ms']:.3f} ms), peak memory "
            f"{r['peak_gib']:.2f} GiB; a {P21_FIT_STEPS}-step fit "
            f"{r['fit_ms_per_step']:.3f} ms a step, zoo_step_flops "
            f"{r['step_flops']} (over the hand count "
            f"{(r['step_flops'] or 0) / hand:.5f}), zoo_mfu {r['mfu']}")
        if not ok:
            raise AssertionError(f"21(a): {r}")
        del ssd, est, xs, ys
        torch.cuda.empty_cache()
    return states, rep


def p21_step(torch, np, state, x, y, device, dtype="float32", f64=False):
    """One training step's loss and the heads' (loc/conf) gradients."""
    from analytics_zoo_tpu_torch.common.flax_compat import Conv
    ssd = p21_ssd(np, dtype, state=state)
    mod = ssd.model.module
    if f64:
        mod.double()
    est = p21_compile(ssd, device)
    loss, grads = p17_grads(est, x, y)
    c1 = P21_CLASSES + 1
    heads = {name for name, m in mod.named_modules() if isinstance(m, Conv)
             and m.out_features in (4 * 4, 6 * 4, 4 * c1, 6 * c1)}
    return loss, {n: g for n, g in grads.items()
                  if n.rsplit(".", 1)[0] in heads}


def p21_correctness(torch, np, state, kind):
    """21(a)'s check: one step on P21_CHECK_ROWS rows from the same
    weights. float64 on the card (cudnn.deterministic) against float64 on
    the CPU; fp32 (TF32 off) on the card within P21_FP32_OVER_CPU of the
    CPU fp32's own distance from float64 (or P21_FP32_FLOOR); bf16 on the
    card against float64 at P21_BF16_*. The heads' gradients are the 12
    loc/conf convolutions' (12 kernels and 12 biases)."""
    x, boxes, labels = p21_images(np, P21_CHECK_ROWS, seed=SEED + 210)
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        bbox_util,
    )
    anchors = bbox_util.ssd_pytorch_priors()
    y = np.stack([bbox_util.encode_targets(b, lab, anchors)
                  for b, lab in zip(boxes, labels)])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref_loss, ref = p21_step(torch, np, state["fp32"], x, y, "cpu",
                                 f64=True)
        l64, g64 = p21_step(torch, np, state["fp32"], x, y, "cuda",
                            f64=True)
    finally:
        torch.backends.cudnn.deterministic = det
    cpu_loss, g_cpu = p21_step(torch, np, state["fp32"], x, y, "cpu")
    l32, g32 = p21_step(torch, np, state["fp32"], x, y, "cuda")
    lbf, gbf = p21_step(torch, np, state["fp32"], x, y, "cuda",
                        dtype="mixed_bfloat16")
    if len(ref) != 24:
        raise AssertionError(f"21(a): {len(ref)} head gradients, not 24")
    rep = dict(
        rows=P21_CHECK_ROWS, loss=ref_loss,
        f64_loss_rel=abs(l64 - ref_loss) / abs(ref_loss),
        f64_head_rel=p17_norm_rel(g64, ref),
        cpu_fp32_loss_rel=abs(cpu_loss - ref_loss) / abs(ref_loss),
        cpu_fp32_head_rel=p17_norm_rel(g_cpu, ref),
        fp32_loss_rel=abs(l32 - ref_loss) / abs(ref_loss),
        fp32_head_rel=p17_norm_rel(g32, ref),
        bf16_loss_rel=abs(lbf - ref_loss) / abs(ref_loss),
        bf16_head_rel=p17_norm_rel(gbf, ref))
    lim_loss = max(P21_FP32_OVER_CPU * rep["cpu_fp32_loss_rel"],
                   P21_FP32_FLOOR)
    lim_head = max(P21_FP32_OVER_CPU * rep["cpu_fp32_head_rel"],
                   P21_FP32_FLOOR)
    log(f"phase 21(a) one step on {P21_CHECK_ROWS} row(s) against the "
        f"CPU's float64 step (loss {ref_loss:.6f}; the heads' 24 "
        f"gradients, distance over their norm): card float64 under "
        f"cudnn.deterministic loss {rep['f64_loss_rel']:.3g} (limit "
        f"{P21_F64_LOSS_RTOL}), heads {rep['f64_head_rel']:.3g} (limit "
        f"{P21_F64_HEAD_RTOL}); CPU fp32 loss "
        f"{rep['cpu_fp32_loss_rel']:.3g}, heads "
        f"{rep['cpu_fp32_head_rel']:.3g}; card fp32 (TF32 off) loss "
        f"{rep['fp32_loss_rel']:.3g} (limit {lim_loss:.3g}), heads "
        f"{rep['fp32_head_rel']:.3g} (limit {lim_head:.3g}); card bf16 "
        f"loss {rep['bf16_loss_rel']:.3g} (limit {P21_BF16_LOSS_RTOL}), "
        f"heads {rep['bf16_head_rel']:.3g} (limit {P21_BF16_HEAD_RTOL}) "
        f"on {kind}")
    if not (rep["f64_loss_rel"] <= P21_F64_LOSS_RTOL
            and rep["f64_head_rel"] <= P21_F64_HEAD_RTOL
            and rep["fp32_loss_rel"] <= lim_loss
            and rep["fp32_head_rel"] <= lim_head
            and rep["bf16_loss_rel"] <= P21_BF16_LOSS_RTOL
            and rep["bf16_head_rel"] <= P21_BF16_HEAD_RTOL):
        raise AssertionError(f"21(a) correctness: {rep}")
    return rep


def p21_twin(torch, seed=SEED + 22):
    """ssd.pytorch's SSD300 (the port's twin), seeded: every convolution's
    kernel normal with std P21_TWIN_STD, biases as torch makes them."""
    from analytics_zoo_tpu_torch.models.migration_image import (
        make_torch_ssd300,
    )
    torch.manual_seed(seed)
    twin = make_torch_ssd300(P21_CLASSES).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in twin.parameters():
            if p.dim() == 4:
                p.normal_(0.0, P21_TWIN_STD, generator=gen)
    return twin


def p21_predict(torch, np, kind):
    """21(b): ObjectDetector.predict of 32 images at 300 px with weights
    imported from the seeded twin: device forward ms apart from the host's
    decode + NMS ms; the twin on the card within P21_TWIN_RTOL of the
    imported model; the rows equal the same model's on the CPU (labels and
    count exactly, scores and boxes within P21_ROW_ATOL:
    ``p21_rows_match``)."""
    from analytics_zoo_tpu_torch.models import ObjectDetector, SSD300VGG
    from analytics_zoo_tpu_torch.models.migration_image import (
        import_ssd300_from_torch,
    )
    twin = p21_twin(torch)
    ssd = import_ssd300_from_torch(SSD300VGG(P21_CLASSES), twin)
    x, _, _ = p21_images(np, P21_IMAGES, seed=SEED + 211)
    det = ObjectDetector(ssd, conf_threshold=P21_CONF, device="cuda")
    raw = det.forward(x, batch_size=P21_IMAGES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P21_PREDICT_REPS):
        raw = det.forward(x, batch_size=P21_IMAGES)
    forward_ms = (time.perf_counter() - t0) / P21_PREDICT_REPS * 1e3
    mod = ssd.model.module
    xd = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: mod(xd), iters=P21_PREDICT_REPS,
                            warmup=1)
    t0 = time.perf_counter()
    rows = det.post_process(raw)
    host_ms = (time.perf_counter() - t0) * 1e3
    twin = twin.cuda()
    with torch.inference_mode():
        want = twin(xd.permute(0, 3, 1, 2).contiguous()).cpu().numpy()
        twin_ms = cuda_ms(lambda: twin(xd.permute(0, 3, 1, 2)),
                          iters=P21_PREDICT_REPS, warmup=1)
    twin_rel = float(np.abs(raw - want).max() / np.abs(want).max())
    del twin, xd
    torch.cuda.empty_cache()
    cpu_rows = ObjectDetector(ssd, conf_threshold=P21_CONF,
                              device="cpu").predict(x, batch_size=P21_IMAGES)
    n_rows = [len(r) for r in rows]
    matched = [p21_rows_match(np, a, b, P21_ROW_ATOL)
               for a, b in zip(rows, cpu_rows)]
    same = all(m is not None for m in matched)
    worst = max((m for m in matched if m is not None), default=0.0)
    rep = dict(images=P21_IMAGES, forward_ms=forward_ms,
               device_forward_ms=device_ms, host_post_ms=host_ms,
               host_post_ms_per_image=host_ms / P21_IMAGES,
               host_share=host_ms / (host_ms + forward_ms),
               twin_device_ms=twin_ms, twin_rel=twin_rel,
               rows=int(sum(n_rows)), rows_min=min(n_rows),
               rows_max=max(n_rows), rows_equal=bool(same),
               row_max_abs=float(worst))
    log(f"phase 21(b) ObjectDetector(conf {P21_CONF}).predict of "
        f"{P21_IMAGES} images at 300 px on {kind} (weights imported from "
        f"the seeded twin): device forward {device_ms:.3f} ms (CUDA "
        f"events; the twin's own {twin_ms:.3f} ms), forward with its "
        f"copies {forward_ms:.3f} ms, the host's decode + NMS "
        f"{host_ms:.1f} ms ({rep['host_post_ms_per_image']:.2f} ms an "
        f"image, {rep['host_share']:.3f} of predict); {rep['rows']} rows "
        f"({rep['rows_min']}-{rep['rows_max']} an image); each image's "
        f"rows are the CPU's (labels and count exactly, score and box "
        f"within {P21_ROW_ATOL}, rows whose scores agree within it in "
        f"either order): {same}, worst {worst:.3g}; twin against the "
        f"imported model {twin_rel:.3g} of its largest output (limit "
        f"{P21_TWIN_RTOL})")
    if not (same and rep["rows"] > 0 and twin_rel <= P21_TWIN_RTOL
            and np.isfinite(raw).all()):
        raise AssertionError(f"21(b): {rep}")
    return rep


def p21_rows_match(np, a, b, atol):
    """The largest score or box distance of rows ``a`` (one image's
    detections) from ``b`` when each row of ``a`` pairs with a row of
    ``b`` of its label within ``atol`` in score and box (the same count,
    each row of ``b`` used once); None where they do not pair. Two rows
    whose scores agree within ``atol`` may come in either order."""
    if a.shape != b.shape or (np.sort(a[:, 0]) != np.sort(b[:, 0])).any():
        return None
    used = np.zeros(len(b), bool)
    worst = 0.0
    for row in a:
        d = np.abs(b[:, 1:] - row[1:]).max(1)
        cand = np.where((b[:, 0] == row[0]) & ~used & (d <= atol))[0]
        if not len(cand):
            return None
        j = cand[np.argmin(d[cand])]
        used[j] = True
        worst = max(worst, float(d[j]))
    return worst


def p21_fixtures(np):
    """The two checked-in fixture images in [0, 1] and their boxes."""
    from PIL import Image
    with open(os.path.join(P21_FIX, "ground_truth.json")) as fh:
        gt = json.load(fh)
    names = sorted(gt)
    imgs = np.stack([np.asarray(Image.open(os.path.join(P21_FIX, n)))
                     for n in names]).astype(np.float32) / 255.0
    gtb = [np.array([g["box"] for g in gt[n]], np.float32) for n in names]
    gtl = [np.array([g["label"] for g in gt[n]]) for n in names]
    return imgs, gtb, gtl


def p21_overfit(torch, np, kind, dev="cuda"):
    """21(c) (JAX tests/test_model_zoo.py:446-470): SSDLite(1, 64 px) fit
    on the two fixture images on the card, then ObjectDetector and
    mean_average_precision: mAP@0.5 at least P21_MAP."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import ObjectDetector, SSDLite
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        mean_average_precision,
    )
    imgs, gtb, gtl = p21_fixtures(np)
    torch.manual_seed(SEED + 23)
    ssd = SSDLite(class_num=1, image_size=64)
    y = ssd.encode_ground_truth(gtb, gtl)
    ssd.compile(optimizer=Adam(learningrate=P21_OVERFIT_LR),
                loss=ssd.loss(), device=dev)
    t0 = time.perf_counter()
    h = ssd.fit(np.repeat(imgs, P21_OVERFIT_REPEAT, axis=0),
                np.repeat(y, P21_OVERFIT_REPEAT, axis=0),
                batch_size=P21_OVERFIT_BATCH, nb_epoch=P21_OVERFIT_EPOCHS,
                shuffle=False, steps_per_loop=P21_OVERFIT_LOOP)
    fit_s = time.perf_counter() - t0
    res = ObjectDetector(ssd, conf_threshold=0.5).predict(imgs)
    scores = mean_average_precision(res, gtb, gtl, n_classes=1)
    rep = dict(fit_s=fit_s, final_loss=h["loss"][-1], mAP=scores["mAP"],
               detections=sum(len(r) for r in res),
               positives=int((y[..., 4] > 0).sum()))
    log(f"phase 21(c) SSDLite(1, 64 px) overfit on the two fixture images "
        f"on {kind}: {P21_OVERFIT_EPOCHS} epochs of "
        f"{len(imgs) * P21_OVERFIT_REPEAT} rows (Adam {P21_OVERFIT_LR}, "
        f"steps_per_loop {P21_OVERFIT_LOOP}) in {fit_s:.1f} s, final loss "
        f"{rep['final_loss']:.4f}; {rep['detections']} detections at "
        f"conf 0.5, mAP@0.5 {rep['mAP']:.4f} (limit {P21_MAP})")
    if rep["mAP"] < P21_MAP or rep["detections"] < 3:
        raise AssertionError(f"21(c): {rep}")
    return rep


def p21_hooks(torch, np, kind, dev="cuda"):
    """21(d): the backend supervisor on the card (its probe reads ok; two
    reported failures drive suspect -> wedged, one flight-recorder dump,
    the gauge at 2; /healthz carries the block and no failover key; two
    healthy probes bring it back to ok) and the four hooks over a fit
    (an SSDLite fit of 2 epochs, a cached epoch, a predict): recompiles,
    transfer bytes and a timed block."""
    import json as _json
    import urllib.error
    import urllib.request

    from analytics_zoo_tpu_torch.common import resilience, telemetry
    from analytics_zoo_tpu_torch.models import SSDLite
    from analytics_zoo_tpu_torch.serving import Broker, FrontEnd
    flight = os.path.join(P21_DIR, "flight")
    os.environ["ZOO_FLIGHT_RECORDER_DIR"] = flight
    telemetry.reset_for_tests()
    rep = {}
    try:
        sup = resilience.get_supervisor()
        probe = sup.probe_once()
        rep["probe"] = probe
        states = [sup.state]
        for _ in range(2):
            sup.report_failure(RuntimeError("CUDA error: device lost "
                                            "(reported by phase 21)"))
            states.append(sup.state)
        snap = telemetry.snapshot()
        rep["gauge_wedged"] = snap["zoo_backend_state"]
        rep["failovers"] = snap["zoo_backend_failovers_total"]
        rep["dumps"] = len([p for p in os.listdir(flight)
                            if p.startswith("flightrec")])
        with Broker.launch(backend="python") as b, FrontEnd(b.port) as fe:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{fe.port}/healthz",
                        timeout=30) as r:
                    hz = _json.loads(r.read().decode())
            except urllib.error.HTTPError as e:
                hz = _json.loads(e.read().decode())
        rep["healthz_block"] = hz.get("backend_supervisor")
        rep["healthz_failover_key"] = "failover" in hz
        for _ in range(2):
            sup.probe_once()
            states.append(sup.state)
        rep["states"] = states
        rep["gauge_after"] = telemetry.snapshot()["zoo_backend_state"]
        # the hooks over a fit on the card
        telemetry.reset_for_tests()
        torch.manual_seed(SEED + 24)
        lite = SSDLite(class_num=1, image_size=64)
        rng = np.random.default_rng(SEED + 24)
        x = rng.uniform(0, 1, (P21_HOOK_ROWS, 64, 64, 3)).astype(np.float32)
        y = lite.encode_ground_truth(
            [np.array([[0.2, 0.2, 0.6, 0.7]], np.float32)] * P21_HOOK_ROWS,
            [np.array([1])] * P21_HOOK_ROWS)
        lite.compile(optimizer="adam", loss=lite.loss(), device=dev)
        lite.fit(x, y, batch_size=P21_HOOK_BATCH, nb_epoch=2, shuffle=False)
        lite.fit(x, y, batch_size=P21_HOOK_BATCH, nb_epoch=1,
                 cache="device", shuffle=False)
        lite.predict(x[:20], batch_size=P21_HOOK_BATCH)
        telemetry.timed_block_until_ready(
            telemetry.traced_device_put(x[:1], dev), site="phase21")
        snap = telemetry.snapshot()
        rep["hooks"] = {k: snap.get(k) for k in (
            "zoo_jit_calls_total", "zoo_jit_cache_misses_total",
            "zoo_device_transfer_bytes_total")}
        rep["block_count"] = snap["zoo_device_block_seconds"][
            "site=phase21"]["count"]
    finally:
        resilience.reset_for_tests()
        telemetry.reset_for_tests()
        del os.environ["ZOO_FLIGHT_RECORDER_DIR"]
    steps = P21_HOOK_ROWS // P21_HOOK_BATCH
    calls, misses = (rep["hooks"]["zoo_jit_calls_total"],
                     rep["hooks"]["zoo_jit_cache_misses_total"])
    moved = rep["hooks"]["zoo_device_transfer_bytes_total"]
    cached = x.nbytes + y.nbytes
    ok = (probe.get("status") == "ok" and probe.get("platform") == "gpu"
          and states == ["ok", "suspect", "wedged", "recovering", "ok"]
          and rep["gauge_wedged"] == 2 and rep["failovers"] == 1
          and rep["dumps"] == 1 and rep["gauge_after"] == 0
          and (rep["healthz_block"] or {}).get("state") == "wedged"
          and not rep["healthz_failover_key"]
          and calls["fn=estimator_train_step"] == 2 * steps
          and misses["fn=estimator_train_step"] == 1
          and calls["fn=estimator_epoch_cached"] == 1
          and calls["fn=estimator_predict"] == 2
          and misses["fn=estimator_predict"] == 1
          and moved["direction=h2d"] == cached + x[:1].nbytes
          and moved["direction=d2h"] > 0 and rep["block_count"] == 1)
    log(f"phase 21(d) the runtime hooks on {kind}: the supervisor's torch."
        f"cuda probe {probe.get('status')} ({probe.get('device_kind')}); "
        f"states {states} (two reported failures, then two healthy "
        f"probes), zoo_backend_state 2 then {rep['gauge_after']}, "
        f"zoo_backend_failovers_total {rep['failovers']}, "
        f"{rep['dumps']} flight-recorder dump, /healthz block "
        f"{rep['healthz_block']}, a failover key: "
        f"{rep['healthz_failover_key']}; an SSDLite fit of 2 x {steps} "
        f"steps, a cached epoch and a predict of 20 rows: calls {calls}, "
        f"recompiles {misses}, bytes {moved} (the cached epoch's x and y "
        f"{cached}), one timed block")
    if not ok:
        raise AssertionError(f"21(d): {rep}")
    return rep


def p21_int8(torch, np, kind, dev="cuda"):
    """21(e): a calibrated int8 GRU TextClassifier at phase 19's widths
    against its fp32 self (argmax agreement, the largest difference, ms
    a predict of 128 rows), and ConvLSTM2D and LocallyConnected2D on the
    card against the CPU from the same weights."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as zl
    clf = p19_model(np, "gru")
    rng = np.random.RandomState(SEED + 25)
    x = rng.randint(1, P19_VOCAB, (P21_INT8_ROWS * (P21_INT8_CALIB + 1),
                                   P19_TC["sequence_length"])).astype(
        np.float32)
    test, calib = x[:P21_INT8_ROWS], x[P21_INT8_ROWS:]
    im = InferenceModel(device=dev).load_zoo(clf)
    want = im.predict(test, batch_size=P21_INT8_ROWS)

    def timed(model):
        model.predict(test, batch_size=P21_INT8_ROWS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(P21_INT8_REPS):
            model.predict(test, batch_size=P21_INT8_ROWS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / P21_INT8_REPS * 1e3

    fp32_ms = timed(im)
    t0 = time.perf_counter()
    im.quantize(min_elems=1024, mode="int8", calibration_data=[
        calib[i * P21_INT8_ROWS:(i + 1) * P21_INT8_ROWS]
        for i in range(P21_INT8_CALIB)])
    calib_s = time.perf_counter() - t0
    got = im.predict(test, batch_size=P21_INT8_ROWS)
    int8_ms = timed(im)
    cell_paths = sorted(k for k in im._act_ranges if "Cell" in k)
    rep = dict(rows=P21_INT8_ROWS, fp32_ms=fp32_ms, int8_ms=int8_ms,
               calibration_s=calib_s, cell_denses=len(cell_paths),
               agree=float((got.argmax(-1) == want.argmax(-1)).mean()),
               max_abs=float(np.abs(got - want).max()))
    # the new layers: the card against the CPU, the same weights
    layers = {}
    for name, make, shape in (
            ("ConvLSTM2D", lambda: zl.ConvLSTM2D(16, 3,
                                                return_sequences=True),
             (8, 10, 16, 16, 8)),
            ("LocallyConnected2D", lambda: zl.LocallyConnected2D(
                16, 3, 3, activation="relu"), (32, 24, 24, 8))):
        inp = Input(shape=shape[1:])
        m = Model(input=inp, output=make()(inp))
        seeded_weights(m.module, SEED + 26)
        xs = np.random.RandomState(SEED + 27).randn(*shape).astype(
            np.float32)
        cpu = InferenceModel(device="cpu").load_zoo(m).predict(xs)
        card = InferenceModel(device=dev).load_zoo(m)
        out = card.predict(xs)
        layers[name] = dict(max_abs=float(np.abs(out - cpu).max()),
                            ms=cuda_ms(lambda: card.predict(xs), iters=3,
                                       warmup=1))
    rep["layers"] = layers
    log(f"phase 21(e) calibrated int8 GRU TextClassifier (phase 19's widths: "
        f"{P19_TC['sequence_length']} steps, {P19_TC['encoder_output_dim']} "
        f"units, 20 classes) on {kind}: {rep['cell_denses']} cell Denses "
        f"calibrated in {calib_s:.1f} s, predict of {P21_INT8_ROWS} rows "
        f"fp32 {fp32_ms:.1f} ms, int8 {int8_ms:.1f} ms; argmax agreement "
        f"{rep['agree']:.3f} (limit {P21_INT8_AGREE}), largest difference "
        f"{rep['max_abs']:.3g} (limit {P21_INT8_ATOL}); the card against "
        f"the CPU: " + ", ".join(
            f"{n} {v['max_abs']:.3g} ({v['ms']:.2f} ms)"
            for n, v in layers.items()) + f" (limit {P21_LAYER_ATOL})")
    if not (rep["cell_denses"] == 6 and rep["agree"] >= P21_INT8_AGREE
            and rep["max_abs"] <= P21_INT8_ATOL
            and all(v["max_abs"] <= P21_LAYER_ATOL
                    for v in layers.values())):
        raise AssertionError(f"21(e): {rep}")
    return rep


def p21_records(torch, np, api, kind, dev="cuda"):
    """21(f): Arrow and encrypted records through ClusterServing on the
    card, each answer the direct predict's; where the card's machine lacks
    pyarrow or cryptography, the typed error naming the package."""
    import importlib.util

    from analytics_zoo_tpu_torch.common import encryption
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import schema
    Broker, ClusterServing, InputQueue, OutputQueue = api
    have = {pkg: importlib.util.find_spec(pkg) is not None
            for pkg in ("pyarrow", "cryptography")}
    clf = p19_model(np, "cnn")
    im = InferenceModel(device=dev).load_zoo(clf)
    rng = np.random.RandomState(SEED + 28)
    x = rng.randint(1, P19_VOCAB, (P21_RECORDS, P19_TC["sequence_length"])
                    ).astype(np.float32)
    want = np.stack([im.predict(x[i:i + 1], batch_size=1)[0]
                     for i in range(P21_RECORDS)])
    rep = dict(have=have)
    with Broker.launch(backend="python") as b:
        with ClusterServing(im, b.port, batch_size=1, max_batch_size=1,
                            warmup=False):
            oq = OutputQueue(port=b.port)
            if have["pyarrow"]:
                iq = InputQueue(port=b.port, arrow=True)
                uris = [iq.enqueue(f"arrow{i}", x=x[i])
                        for i in range(P21_RECORDS)]
                got = np.stack([oq.query(u, timeout=60.0) for u in uris])
                rep["arrow_max_abs"] = float(np.abs(got - want).max())
                iq.close()
            else:
                c = b.client()
                c.xadd("serving_stream", base64_record(
                    {"uri": "arrow0", "data": "QVJST1c="}))
                try:
                    oq.query("arrow0", timeout=60.0)
                    rep["arrow_error"] = None
                except schema.ServingError as e:
                    rep["arrow_error"] = str(e)
            oq.close()
        if have["cryptography"]:
            cipher = encryption.make_cipher("phase21")
            with ClusterServing(im, b.port, batch_size=1, max_batch_size=1,
                                warmup=False, cipher=cipher):
                iq = InputQueue(port=b.port, cipher=cipher)
                oq = OutputQueue(port=b.port, cipher=cipher)
                uris = [iq.enqueue(f"enc{i}", x=x[i])
                        for i in range(P21_RECORDS)]
                got = np.stack([oq.query(u, timeout=60.0) for u in uris])
                rep["encrypted_max_abs"] = float(np.abs(got - want).max())
                iq.close()
                oq.close()
        else:
            try:
                encryption.make_cipher("phase21")
                rep["encrypted_error"] = None
            except ImportError as e:
                rep["encrypted_error"] = str(e)
    log(f"phase 21(f) records through ClusterServing on {kind} (the cnn "
        f"TextClassifier, {P21_RECORDS} records of each kind): the card's "
        f"machine has pyarrow {have['pyarrow']}, cryptography "
        f"{have['cryptography']}; Arrow records "
        + (f"answered, {rep['arrow_max_abs']:.3g} from the direct predict"
           if have["pyarrow"] else
           f"answered with the typed error {rep['arrow_error']!r}")
        + "; encrypted records "
        + (f"answered, {rep['encrypted_max_abs']:.3g} from the direct "
           "predict" if have["cryptography"] else
           f"refused: {rep['encrypted_error']!r}")
        + f" (limit {P21_RECORD_ATOL})")
    ok = (rep["arrow_max_abs"] <= P21_RECORD_ATOL if have["pyarrow"]
          else "pyarrow" in (rep["arrow_error"] or "")) and \
        (rep["encrypted_max_abs"] <= P21_RECORD_ATOL if have["cryptography"]
         else "cryptography" in (rep["encrypted_error"] or ""))
    if not ok:
        raise AssertionError(f"21(f): {rep}")
    return rep


def base64_record(obj) -> str:
    """A record payload as the broker carries it: JSON, base64."""
    import base64
    return base64.b64encode(json.dumps(obj).encode()).decode()


def phase_detection(torch, np, api, kind, dev="cuda"):
    """Phase 21: object detection on the card (ROADMAP A10 and A11's
    first part), TF32 off: (a) SSD300-VGG training at batch 32 x 300 px in
    fp32 and bf16 and its step against the CPU, (b) ObjectDetector's
    predict of 32 images, (c) the fixture overfit, (d) the backend
    supervisor and the four hooks, (e) int8 recurrent cells and the new
    layers, (f) Arrow and encrypted records. The counts are zeroed
    before each part and read after it: none launches a kernel of queue B
    (cuDNN's convolutions and PyTorch's own kernels; JAX computes these
    with XLA, outside any Pallas kernel). The directory it writes is
    removed after."""
    import shutil
    from analytics_zoo_tpu_torch.learn import estimator
    shutil.rmtree(P21_DIR, ignore_errors=True)
    os.makedirs(P21_DIR)
    log_dir = estimator.DEFAULT_LOG_DIR
    estimator.DEFAULT_LOG_DIR = os.path.join(P21_DIR, "tb")
    t0 = time.perf_counter()
    rep = {}
    try:
        with p17_tf32(torch, False):
            states, rep["a"] = p21_part(rep, "a", lambda: p21_train(
                torch, np, kind))
            rep["a_check"] = p21_part(rep, "a_check", lambda: p21_correctness(
                torch, np, states, kind))
            rep["b"] = p21_part(rep, "b", lambda: p21_predict(
                torch, np, kind))
            rep["c"] = p21_part(rep, "c", lambda: p21_overfit(
                torch, np, kind, dev))
            rep["d"] = p21_part(rep, "d", lambda: p21_hooks(
                torch, np, kind, dev))
            rep["e"] = p21_part(rep, "e", lambda: p21_int8(
                torch, np, kind, dev))
            rep["f"] = p21_part(rep, "f", lambda: p21_records(
                torch, np, api, kind, dev))
    finally:
        estimator.DEFAULT_LOG_DIR = log_dir
        shutil.rmtree(P21_DIR, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t0
    log(f"phase 21: no kernel of queue B in any part (cuDNN's convolutions "
        f"and PyTorch's own kernels); seconds by part "
        f"{ {k: round(v, 1) for k, v in rep['part_seconds'].items()} }")
    return rep


def p21_part(rep, key, fn):
    """One part of phase 21: no kernel of queue B may launch in it."""
    return p19_part(rep, key, fn, no_queue_b=True, phase=21)


# ---------------------------------------------------------------- phase 22
# the run's own verdict file (ZOO_AUTOTUNE_CACHE), made empty at the start
AUTOTUNE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_autotune")
# bench.py:1374-1375, measure_flash_attention's shape
FA_BATCH, FA_SEQ, FA_HEADS, FA_DIM = 4, 2048, 8, 64
FA_ITERS = 20
# bench.py:1614-1620, measure_recsys_pipeline's sizes
RECSYS_ROWS = 40_000
RECSYS_SHARDS = 8
RECSYS_USERS = 600
RECSYS_ITEMS = 300
RECSYS_SEQ = 8
RECSYS_BATCH = 1024
RECSYS_EPOCHS = 1
RECSYS_NCF = dict(user_count=RECSYS_USERS, item_count=RECSYS_ITEMS,
                  class_num=2, user_embed=16, item_embed=16,
                  hidden_layers=(32, 16), include_mf=True, mf_embed=16)
RECSYS_LR = 1e-3
# MovieLens-1M's shape (users.dat's and movies.dat's ids in use),
# synthetic and seeded; a sixteenth of ratings.dat's 1 000 209 rows since
# phase 25 joined the run (a quarter since phase 23: each phase's depth
# cut so the whole run stays near its length before; 22(g) took 80-105 s
# at the full count, 45-76 s at a quarter)
ML1M_ROWS, ML1M_USERS, ML1M_ITEMS = 1_000_209 // 16, 6040, 3706
ML1M_NCF = dict(user_count=ML1M_USERS, item_count=ML1M_ITEMS, class_num=2,
                user_embed=20, item_embed=20, hidden_layers=(40, 20, 10),
                include_mf=True, mf_embed=20)
ML1M_BATCH = 8000
P22_CHECK_STEPS = 5                 # card-vs-CPU steps of (f)
P22_FIT_ATOL = 1e-5
P22_PREDICT_ROWS = 80_000           # (h)
P22_WINDOWS = (1, 2, 4)
P22_BERT_QUEUE_BATCH = 16           # (d): a BERT batch no phase tuned


def autotune_mode(mode):
    """A context manager: ``ZOO_AUTOTUNE=mode`` inside, the previous value
    after."""
    from contextlib import contextmanager

    @contextmanager
    def scope():
        prev = os.environ.get("ZOO_AUTOTUNE")
        os.environ["ZOO_AUTOTUNE"] = mode
        try:
            yield
        finally:
            if prev is None:
                os.environ.pop("ZOO_AUTOTUNE", None)
            else:
                os.environ["ZOO_AUTOTUNE"] = prev
    return scope()


def build_step_verdicts(sched, enc_shape, dim: int, max_new: int):
    """A decode scheduler's paged-or-gather verdict at every step shape a
    generation of ``max_new`` tokens can reach (every batch rung of 1 to
    ``max_batch`` sequences, every seq rung up to the last one), through
    ``tune_paged`` (persisted; ``paged="auto"`` reads them). Built before
    the first step of phases 9(f), 15(g) and 22(e), so that no step shape
    misses. Returns ``{"b<rung>s<seq rung>": use_kernel}``."""
    top = sched._seq_ladder.rung_for(max_new + 1 + sched.spec_k)
    out = {}
    with autotune_mode("sync"):
        for r in sorted({sched._batch_rung(n)
                         for n in range(1, sched.max_batch + 1)}):
            for s in sched._seq_ladder.rungs:
                if s > top:
                    break
                rec = sched.tune_paged(batch_rung=r, seq_rung=s,
                                       enc_shape=enc_shape, dim=dim)
                out[f"b{r}s{s}"] = bool(rec["use_kernel"])
    return out


def p22_check_record(rec, what: str) -> None:
    """A measurement on the card: every candidate ran (a candidate that
    raised is a kernel that did not build or launch)."""
    if rec is None or rec["errors"] or rec["best"] is None:
        raise AssertionError(f"22 {what}: a candidate failed: {rec}")


def p22_verdict_line(rec) -> str:
    return (f"best {rec['best']} {rec['best_ms']} ms, reference "
            f"{rec['reference_ms']} ms, speedup {rec['speedup']}, use_kernel "
            f"{rec['use_kernel']}, errors {rec['errors'] or 'none'}")


def p22_attention_verdicts(torch, np, kind):
    """22(a): the flash verdicts at BERT serving's shape in bf16 and fp32
    (TF32 off) beside the einsum chain's time, then BERT-Base at
    ``BertConfig()``'s ``use_flash=None`` under ``sync``: the route follows
    the verdict (12 flash launches a forward, or none and the einsum
    chain), the output within phase 6's limits of the ``use_flash=True``
    model's."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _build, autotune
    from analytics_zoo_tpu_torch.ops import attention as att
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    b, s, h, d = BERT_BATCH, BERT_LEN, 12, 64
    rep = {}
    gen = torch.Generator().manual_seed(SEED)
    x = bert_inputs(np.random.RandomState(SEED), BERT_BATCH)
    sample = tuple(a[:BERT_CPU_ROWS] for a in x)
    state = bert_classifier(None, use_flash=True).state_dict()
    for dname, dtype, atol in (("float32", torch.float32, BERT_ATOL),
                               ("bfloat16", torch.bfloat16, BERT_BF16_ATOL)):
        with autotune_mode("sync"):
            rec = autotune.tune_attention(b, s, h, d, dtype=dtype)
        p22_check_record(rec, f"(a) {dname}")
        q, k, v = (torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
                   for _ in range(3))
        chain_ms = cuda_ms(lambda: att._reference_attention(q, k, v),
                           iters=20)
        kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters=20)
        cfg = {} if dtype == torch.float32 else dict(dtype=dtype)
        with autotune_mode("sync"):
            im = InferenceModel(device="cuda").load_torch(
                bert_classifier(state, **cfg), sample)
            im.predict(x, batch_size=BERT_BATCH)            # warm up
            before = _build.launch_counts().get("flash_attention_fwd", 0)
            y, fwd_ms = timed_predict(im, x, reps=3)
            per_fwd = (_build.launch_counts().get("flash_attention_fwd", 0)
                       - before) / 4
        y_flash = InferenceModel(device="cuda").load_torch(
            bert_classifier(state, use_flash=True, **cfg), sample).predict(
            x, batch_size=BERT_BATCH)
        diff = float(np.abs(y - y_flash).max())
        want = 12 if rec["use_kernel"] else 0
        rep[dname] = dict(record=rec, einsum_chain_ms=chain_ms,
                          kernel_ms=kernel_ms, predict_ms=fwd_ms,
                          flash_launches_per_forward=per_fwd,
                          max_abs_diff_flash_model=diff)
        log(f"22(a) flash verdict {dname} {b}x{s}x{h}x{d}: "
            f"{p22_verdict_line(rec)}; einsum chain {chain_ms:.4f} ms, "
            f"kernel {kernel_ms:.4f} ms (CUDA events, {kind})")
        log(f"22(a) BERT-Base use_flash=None {dname} predict "
            f"{b}x{s}: {fwd_ms:.3f} ms/call, {per_fwd:.0f} flash launches a "
            f"forward (the verdict says {want}); max |y - use_flash=True| "
            f"{diff:.3g} (atol {atol})")
        if per_fwd != want or not np.isfinite(y).all() or diff > atol:
            raise AssertionError(f"22(a) {dname}: route or output: "
                                 f"{rep[dname]}")
        if not rec["use_kernel"]:
            log(f"22(a) QUEUE B FINDING: the flash kernel lost its "
                f"measurement in {dname} at {b}x{s}: {p22_verdict_line(rec)}")
    return rep


def p22_flash_bench(torch, kind):
    """22(b): bench.py's ``measure_flash_attention`` on the card: causal
    bf16 at 4 x 2048, 8 heads, d 64, FA_ITERS chained calls (each call's
    q the last output) for blockwise_attention, the kernel alone and the
    ``auto_flash_attention`` route after ``tune_attention``."""
    from analytics_zoo_tpu_torch.ops import autotune
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn((FA_BATCH, FA_SEQ, FA_HEADS, FA_DIM),
                           generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))

    def timed(fn):
        with torch.inference_mode():
            fn(q, k, v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = q
            for _ in range(FA_ITERS):
                out = fn(out, k, v)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / FA_ITERS * 1e3

    block_ms = timed(lambda a, b, c: fa.blockwise_attention(a, b, c,
                                                            causal=True))
    kernel_ms = timed(lambda a, b, c: fa.flash_attention(a, b, c,
                                                         causal=True))
    rec = autotune.tune_attention(FA_BATCH, FA_SEQ, FA_HEADS, FA_DIM,
                                  dtype=torch.bfloat16, causal=True,
                                  iters=FA_ITERS)
    p22_check_record(rec, "(b)")
    auto_ms = timed(lambda a, b, c: autotune.auto_flash_attention(
        a, b, c, causal=True))
    rep = dict(blockwise_attn_seq_ms=block_ms, flash_kernel_ms=kernel_ms,
               auto_ms=auto_ms, record=rec,
               flash_kernel_raw_speedup=rec["speedup"],
               flash_vs_blockwise_speedup=block_ms / auto_ms)
    log(f"22(b) measure_flash_attention on {kind} (causal bf16 "
        f"{FA_BATCH}x{FA_SEQ}x{FA_HEADS}x{FA_DIM}, {FA_ITERS} chained "
        f"calls, host clock): blockwise {block_ms:.4f} ms, kernel "
        f"{kernel_ms:.4f} ms, auto_flash_attention {auto_ms:.4f} ms; "
        f"flash_vs_blockwise_speedup {rep['flash_vs_blockwise_speedup']:.3f}"
        f", flash_kernel_raw_speedup {rec['speedup']}; verdict "
        f"{p22_verdict_line(rec)}")
    if not rec["use_kernel"]:
        log(f"22(b) QUEUE B FINDING: the flash kernel lost to blockwise at "
            f"bench.py's shape: {p22_verdict_line(rec)}")
    return rep


def p22_kernel_verdicts(torch, np, kind):
    """22(c): the lookup's, the bag's and the paged kernels' verdicts (the
    kernel against its plain version on the card) at NCF's tables (batch
    8000, concat), the history column (8000 x 8, d 20, mean) and decode's
    shape (measure_decode: batch 8, page size 8); each persisted, read
    back by a fresh tuner; then one public call of each adds exactly one
    launch to its kernel's count whatever the verdict."""
    from analytics_zoo_tpu_torch.inference import decode_scheduler, generation
    from analytics_zoo_tpu_torch.ops import _build, autotune
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb
    from analytics_zoo_tpu_torch.ops import paged_attention as pa
    users, items = NCF["user_count"] + 1, NCF["item_count"] + 1
    tables = [(users, NCF["user_embed"]), (items, NCF["item_embed"])]
    dim = DECODE["output_dim"]
    n_pages = decode_scheduler.default_pool_pages(
        DECODE_BATCH, DECODE_STEPS, spec_k=0, page_size=PAGE_SIZE)
    top = generation.seq_ladder(DECODE_STEPS + 1,
                                min_rung=PAGE_SIZE).rung_for(DECODE_STEPS + 1)
    width = -(-top // PAGE_SIZE)
    recs = {
        eb._shapes_key("fused", tables, f"concat.b{BATCH}", torch.float32):
            eb.tune_fused_lookup(tables, BATCH, "concat"),
        eb._shapes_key("bag", [(items, NCF["item_embed"])],
                       f"mean.b{BATCH}l{HIST_LEN}", torch.float32):
            eb.tune_bag(items, NCF["item_embed"], BATCH, HIST_LEN, "mean"),
        pa.gather_key(DECODE_BATCH, width, PAGE_SIZE, dim, n_pages,
                      torch.float32):
            pa.tune_paged_gather(DECODE_BATCH, width, PAGE_SIZE, dim,
                                 n_pages),
        pa.attn_key(DECODE_BATCH, width, PAGE_SIZE, dim, n_pages,
                    torch.float32):
            pa.tune_paged_attention(DECODE_BATCH, width, PAGE_SIZE, dim,
                                    n_pages),
    }
    autotune.reset_tuner()
    rep = {"records": recs}
    for key, rec in recs.items():
        p22_check_record(rec, f"(c) {key}")
        back = autotune.get_tuner().lookup(key)
        if back != rec:
            raise AssertionError(f"22(c) {key} not read back: {back}")
        log(f"22(c) {key}: {p22_verdict_line(rec)}")
        if not rec["use_kernel"]:
            log(f"22(c) QUEUE B FINDING: {rec['kernel']} lost to its plain "
                f"version at {key}")
    rng = np.random.default_rng(SEED)
    tabs = [torch.randn(shape, device="cuda") for shape in tables]
    ids = torch.from_numpy(np.stack(
        [rng.integers(0, users, BATCH), rng.integers(0, items, BATCH)],
        1).astype(np.int32)).to("cuda")
    bag_ids = torch.from_numpy(rng.integers(
        0, items, (BATCH, HIST_LEN)).astype(np.int32)).to("cuda")
    pool, table, lengths, _ = pa._synth_args(DECODE_BATCH, width, PAGE_SIZE,
                                             dim, n_pages, torch.float32)
    q = torch.randn((DECODE_BATCH, dim), device="cuda")
    calls = {"fused_embedding_lookup": lambda: eb.fused_embedding_lookup(
                 tabs, ids, "concat"),
             "embedding_bag": lambda: eb.embedding_bag(tabs[1], bag_ids,
                                                       mode="mean"),
             "paged_gather": lambda: pa.paged_gather(pool, table, lengths),
             "paged_attention": lambda: pa.paged_attention(
                 q, pool, pool, table, lengths)}
    rep["public_launches"] = {}
    with torch.inference_mode():
        for name, call in calls.items():
            before = _build.launch_counts()
            call()
            torch.cuda.synchronize()
            n = _build.launch_counts().get(name, 0) - before.get(name, 0)
            rep["public_launches"][name] = n
            if n != 1:
                raise AssertionError(f"22(c) one public {name} made {n} "
                                     f"launches")
    log(f"22(c) one public call each after the verdicts: "
        f"{rep['public_launches']} (kernel on the card whatever the "
        f"verdict, {kind})")
    return rep


def p22_queue(torch, np, kind):
    """22(d): in ``on`` mode a BERT-Base predict at a batch no verdict
    covers queues its shape and takes the 2 GiB heuristic (the einsum
    chain); ``warm_up(block=True)`` drains the queue: nothing pending,
    the verdict on disk, and the next predict follows it. The
    ``zoo_autotune_*`` values are read off the registry."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _build, autotune
    n = P22_BERT_QUEUE_BATCH
    from analytics_zoo_tpu_torch.ops.attention import AttentionModule
    x = bert_inputs(np.random.RandomState(SEED + 1), n)
    sample = tuple(a[:BERT_CPU_ROWS] for a in x)
    model = bert_classifier(None)
    attn = next(m for m in model.modules() if isinstance(m, AttentionModule))
    key = autotune.attention_key(n, BERT_LEN, BERT_LEN, attn.num_heads,
                                 attn.head_dim, torch.float32, False)
    with autotune_mode("on"):
        im = InferenceModel(device="cuda").load_torch(model, sample)
        _build.reset_launch_counts()
        y0 = im.predict(x, batch_size=n)
        before = _build.launch_counts().get("flash_attention_fwd", 0)
        pending = autotune.pending_count()
        if autotune.get_tuner().lookup(key) is not None or pending < 1 \
                or before != 0:
            raise AssertionError(f"22(d) a miss should queue and take the "
                                 f"einsum chain: pending {pending}, flash "
                                 f"launches {before}")
        im.warm_up(block=True)
        left = autotune.pending_count()
        with open(autotune.get_tuner().path) as fh:
            on_disk = json.load(fh).get(key)
        if left or on_disk is None:
            raise AssertionError(f"22(d) warm_up left {left} pending; "
                                 f"verdict on disk: {on_disk}")
        p22_check_record(on_disk, "(d)")
        _build.reset_launch_counts()
        y1 = im.predict(x, batch_size=n)
        after = _build.launch_counts().get("flash_attention_fwd", 0)
    if after != (12 if on_disk["use_kernel"] else 0):
        raise AssertionError(f"22(d) after the drain: {after} flash "
                             f"launches, verdict {on_disk}")
    diff = float(np.abs(y1 - y0).max())
    if diff > BERT_ATOL:
        raise AssertionError(f"22(d) the routes' outputs differ by {diff}")
    snap = telemetry.snapshot()
    metrics = {name: snap.get(f"zoo_autotune_{name}", {}) for name in (
        "runs_total", "cache_hits_total", "fallbacks_total", "pending",
        "best_ms", "speedup")}
    log(f"22(d) on {kind}: a BERT predict of {n}x{BERT_LEN} queued "
        f"{pending}; warm_up(block=True) drained it (pending {left}); "
        f"verdict {p22_verdict_line(on_disk)}; flash launches before "
        f"{before}, after {after}; max |after - before| {diff:.3g}; "
        f"registry {metrics}")
    return dict(pending_before=pending, pending_after=left,
                record=on_disk, launches_before=before,
                launches_after=after, max_abs_diff=diff, metrics=metrics)


def p22_decode(torch, np, kind):
    """22(e): decode (measure_decode's model and shape) through a
    DecodeScheduler with ``paged="auto"`` under ``sync``: ``tune_paged``'s
    verdict persisted at the top rung, every other step shape measured at
    its first step; the route each step took, gathers equal to paged
    steps, tokens bitwise greedy generate."""
    from analytics_zoo_tpu_torch.common.compile_ahead import BucketLadder
    from analytics_zoo_tpu_torch.inference import (InferenceModel,
                                                   decode_scheduler,
                                                   generation)
    from analytics_zoo_tpu_torch.models import Seq2Seq
    from analytics_zoo_tpu_torch.ops import _build, autotune
    from analytics_zoo_tpu_torch.ops import paged_attention as pa
    b, steps = DECODE_BATCH, DECODE_STEPS
    m = Seq2Seq(**DECODE)
    seeded_weights(m.model.module, SEED)
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((b, 8, DECODE["input_dim"])).astype(np.float32)
    start = np.zeros((b, DECODE["output_dim"]), np.float32)
    im = InferenceModel(device="cuda").load_zoo(m)
    im.set_ladder(BucketLadder(b, b))
    greedy = im.generate(enc, start, steps)
    sched = decode_scheduler.DecodeScheduler(
        im.decode_step_fn(), max_batch=b, max_seq=steps, spec_k=0,
        batch_ladder=BucketLadder(b, b),
        paged_step_fn=im.paged_decode_step_fn(), paged="auto")
    seqs = [sched.admit(enc[i], start[i], steps, mode="greedy")
            for i in range(b)]
    top = generation.seq_ladder(steps + 1, min_rung=PAGE_SIZE).rung_for(
        steps + 1)
    verdicts = build_step_verdicts(sched, enc[0].shape, DECODE["output_dim"],
                                   steps)
    key = pa.step_key(b, top, PAGE_SIZE, DECODE["output_dim"],
                      sched.allocator.n_pages, sched.allocator.kv_dtype,
                      enc[0].shape)
    autotune.reset_tuner()
    rec = autotune.get_tuner().lookup(key)
    with autotune_mode("sync"):
        _build.reset_launch_counts()
        sched.drain()
        gathers = _build.launch_counts().get("paged_gather", 0)
    for i, s in enumerate(seqs):
        if not np.array_equal(s.result, greedy[i]):
            raise AssertionError(f"22(e) sequence {i} differs from greedy")
    if gathers != sched.paged_steps or rec is None:
        raise AssertionError(f"22(e) {gathers} gathers for "
                             f"{sched.paged_steps} paged steps; the top "
                             f"shape's verdict {rec}")
    log(f"22(e) decode paged='auto' (sync) on {kind}: tune_paged's "
        f"persisted verdicts {verdicts}, read back at b{b}s{top}: "
        f"{p22_verdict_line(rec)}; {sched.paged_steps} paged steps, "
        f"{sched.paged_fallbacks} host-gather steps, {gathers} gathers; "
        f"tokens bitwise greedy generate")
    return dict(tune_paged=rec, key=key, verdicts=verdicts,
                paged_steps=sched.paged_steps,
                gather_steps=sched.paged_fallbacks, gathers=gathers)


def recsys_raw_df(rows, users, items):
    """bench.py's ``_recsys_raw_df`` (bench.py:1624) at ``rows``, ``users``
    and ``items``: string codes, a time stamp, numpy seed 11."""
    import numpy as np
    import pandas as pd
    rng = np.random.default_rng(11)
    u = rng.integers(0, users, rows)
    i = rng.integers(0, items, rows)
    return pd.DataFrame({
        "user_code": np.char.add("u", u.astype(str)),
        "item_code": np.char.add("i", i.astype(str)),
        "time": rng.integers(0, 100_000, rows),
    })


def recsys_transforms(df, items):
    """bench.py's ``_recsys_transforms`` (bench.py:1636)."""
    from analytics_zoo_tpu_torch.friesian.feature import FeatureTable
    t = FeatureTable.from_pandas(df, RECSYS_SHARDS)
    indices = t.gen_string_idx(["user_code", "item_code"])
    t = t.encode_string(["user_code", "item_code"], indices)
    t = t.rename({"user_code": "user", "item_code": "item"})
    t = t.add_hist_seq("user", ["item"], sort_col="time",
                       min_len=1, max_len=RECSYS_SEQ)
    t = t.add_negative_samples(item_size=items, item_col="item",
                               neg_num=1)
    t = t.cross_columns([["user", "item"]], [100])
    t = t.mask_pad(padding_cols=["item_hist_seq"],
                   mask_cols=["item_hist_seq"], seq_len=RECSYS_SEQ)
    t = t.add_length("item_hist_seq")
    return t.merge_cols(["user", "item"], "features")


def p22_data_env(**env):
    """A context manager setting the data plane's env knobs."""
    from contextlib import contextmanager

    @contextmanager
    def scope():
        prev = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            yield
        finally:
            for k, v in prev.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return scope()


def p22_ncf(config, device):
    """NeuralCF of ``config`` with weights from the numpy seed, compiled
    with Adam(1e-3) on ``device``; returns (the model, its estimator)."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import NeuralCF
    ncf = NeuralCF(**config)
    seeded_weights(ncf.model.module, SEED)
    ncf.compile(optimizer=Adam(RECSYS_LR),
                loss="sparse_categorical_crossentropy", device=device)
    return ncf, ncf.model._ensure_estimator(for_training=True)


def table_arrays(np, table):
    """A feed-ready table's columns as arrays: list cells stacked."""
    df = table.to_pandas()
    out = {}
    for c in df.columns:
        col = df[c]
        out[c] = np.stack(col.to_numpy()) if col.dtype == object \
            else col.to_numpy()
    return out


def p22_recsys(torch, np, kind):
    """22(f): bench.py's measure_recsys_pipeline at its size: the transform
    chain legacy (ZOO_DATA_VECTORIZE=0 ZOO_DATA_WORKERS=0) and vectorized,
    the faster feeding the streaming dataset of an NCF fit on the card;
    the positive rows of the two tables equal (their negatives are drawn
    from other shards, by design); the first steps on the card against
    the CPU."""
    from analytics_zoo_tpu_torch.data.dataset import ShardedDataset
    from analytics_zoo_tpu_torch.ops import _build
    df = recsys_raw_df(RECSYS_ROWS, RECSYS_USERS, RECSYS_ITEMS)
    with p22_data_env(ZOO_DATA_VECTORIZE="0", ZOO_DATA_WORKERS="0"):
        t0 = time.perf_counter()
        legacy = recsys_transforms(df, RECSYS_ITEMS)
        t_legacy = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = recsys_transforms(df, RECSYS_ITEMS)
    t_fast = time.perf_counter() - t0
    use_fast = t_fast <= t_legacy
    t_chosen = min(t_fast, t_legacy)
    table = fast if use_fast else legacy
    a_fast, a_legacy = table_arrays(np, fast), table_arrays(np, legacy)

    def positives(a):
        keep = a["label"] == 1
        rows = np.concatenate([a[c][keep].reshape(int(keep.sum()), -1)
                               for c in sorted(a)], 1)
        return rows[np.lexsort(rows.T[::-1])]

    same_pos = np.array_equal(positives(a_fast), positives(a_legacy))
    if not same_pos or len(a_fast["label"]) != len(a_legacy["label"]):
        raise AssertionError("22(f) legacy and vectorized tables differ "
                             "beyond their negatives")
    ds = table.to_streaming_dataset(["features"], "label", prefetch_depth=2)
    ncf, est = p22_ncf(RECSYS_NCF, "cuda")
    fit, launches, dt_fit = counted(torch, lambda: est.fit(
        ds, epochs=RECSYS_EPOCHS, batch_size=RECSYS_BATCH))
    steps = ds.n // RECSYS_BATCH
    samples = ds.n * RECSYS_EPOCHS
    per_step = {k: v / steps for k, v in launches.items() if v}
    # card against CPU: the first steps from the same start on the same
    # rows in the same order
    n = P22_CHECK_STEPS * RECSYS_BATCH
    check = ShardedDataset(a_fast["features"][:n], a_fast["label"][:n]) \
        if use_fast else ShardedDataset(a_legacy["features"][:n],
                                        a_legacy["label"][:n])
    runs = {}
    for dev in ("cuda", "cpu"):
        m, e = p22_ncf(RECSYS_NCF, dev)
        e.fit(check, epochs=1, batch_size=RECSYS_BATCH)
        runs[dev] = (list(e.step_losses), {
            k: v.detach().cpu() for k, v in m.model.module.state_dict()
            .items()})
    loss_diff = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                               runs["cpu"][0]))
    param_diff = max(float((runs["cuda"][1][k] - v).abs().max())
                     for k, v in runs["cpu"][1].items())
    rep = dict(
        recsys_pipeline_samples_per_sec=samples / (t_chosen + dt_fit),
        friesian_transform_speedup=t_legacy / t_chosen,
        recsys_transform_mode="vectorized-parallel" if use_fast
        else "legacy-serial",
        recsys_transform_seconds=t_chosen,
        recsys_transform_legacy_seconds=t_legacy,
        recsys_transform_vectorized_seconds=t_fast,
        recsys_pipeline_rows=int(ds.n), fit_seconds=dt_fit,
        fit_step_ms=dt_fit / steps * 1e3, launches=launches,
        launches_per_step=per_step, epoch_loss=fit["loss"][0],
        check_loss_max_abs_diff=loss_diff,
        check_param_max_abs_diff=param_diff)
    log(f"22(f) recsys pipeline on {kind}: transforms legacy "
        f"{t_legacy:.3f} s, vectorized {t_fast:.3f} s "
        f"(friesian_transform_speedup {rep['friesian_transform_speedup']:.3f}"
        f", {rep['recsys_transform_mode']}); {ds.n} rows fit in "
        f"{dt_fit:.3f} s ({rep['fit_step_ms']:.3f} ms a step of "
        f"{RECSYS_BATCH}); recsys_pipeline_samples_per_sec "
        f"{rep['recsys_pipeline_samples_per_sec']:.1f}; launches a step "
        f"{per_step}; positive rows equal across modes; first "
        f"{P22_CHECK_STEPS} steps card vs CPU: loss {loss_diff:.3g}, "
        f"parameters {param_diff:.3g} (atol {P22_FIT_ATOL})")
    for name in ("fused_embedding_lookup", "embedding_scatter_add"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"22(f) the fit launched no {name}")
    if loss_diff > P22_FIT_ATOL or param_diff > P22_FIT_ATOL \
            or not np.isfinite(fit["loss"]).all():
        raise AssertionError(f"22(f) card vs CPU: {rep}")
    return rep


def p22_ml1m(torch, np, kind):
    """22(g): the chain at MovieLens-1M's shape (vectorized) under DRAM and
    under NATIVE_4, the tables bitwise equal; NCF at ML-1M width fit one
    epoch of batch 8000 from the NATIVE_4 table's streaming feed, whose
    windows stay within the tier's bound."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    df = recsys_raw_df(ML1M_ROWS, ML1M_USERS, ML1M_ITEMS)
    prev = OrcaContext.train_data_store
    tables, secs = {}, {}
    try:
        for tier in ("DRAM", "NATIVE_4"):
            OrcaContext.train_data_store = tier
            t0 = time.perf_counter()
            tables[tier] = recsys_transforms(df, ML1M_ITEMS)
            secs[tier] = time.perf_counter() - t0
        dram, native = (table_arrays(np, tables[t])
                        for t in ("DRAM", "NATIVE_4"))
        if sorted(dram) != sorted(native) or not all(
                dram[c].dtype == native[c].dtype
                and np.array_equal(dram[c], native[c]) for c in dram):
            raise AssertionError("22(g) NATIVE_4 table differs from DRAM's")
        table = tables["NATIVE_4"]
        if table.shards.tier != "NATIVE_4":
            raise AssertionError(f"22(g) tier {table.shards.tier}")
        ds = table.to_streaming_dataset(["features"], "label",
                                        prefetch_depth=2)
        ncf, est = p22_ncf(ML1M_NCF, "cuda")
        fit, launches, dt_fit = counted(torch, lambda: est.fit(
            ds, epochs=1, batch_size=ML1M_BATCH))
    finally:
        OrcaContext.train_data_store = prev
    sizes = [len(s) for s in table.shards._iter_shards()]
    w = ds.window_shards
    bound = max(sum(sizes[i:i + w]) for i in range(0, len(sizes), w)) \
        + ML1M_BATCH
    steps = ds.n // ML1M_BATCH
    rep = dict(rows=int(ds.n), transform_seconds=secs,
               window_shards=w, peak_window_rows=ds.peak_window_rows,
               window_bound=bound, fit_seconds=dt_fit,
               fit_step_ms=dt_fit / steps * 1e3,
               samples_per_sec_with_transform=ds.n / (secs["NATIVE_4"]
                                                      + dt_fit),
               samples_per_sec_fit=ds.n / dt_fit, launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v}, epoch_loss=fit["loss"][0],
               native_stats=table.shards._store.stats)
    log(f"22(g) MovieLens-1M shape ({ML1M_ROWS} rows, {ML1M_USERS} users, "
        f"{ML1M_ITEMS} items) on {kind}: vectorized transforms DRAM "
        f"{secs['DRAM']:.3f} s, NATIVE_4 {secs['NATIVE_4']:.3f} s, tables "
        f"bitwise; {ds.n} rows, NCF (20, (40, 20, 10), GMF 20) one epoch "
        f"of {ML1M_BATCH} in {dt_fit:.3f} s ({rep['fit_step_ms']:.3f} ms a "
        f"step): {rep['samples_per_sec_with_transform']:.1f} samples/s with "
        f"the transforms, {rep['samples_per_sec_fit']:.1f} without; "
        f"peak_window_rows {ds.peak_window_rows} (bound {bound}); native "
        f"store {rep['native_stats']}")
    if not ds.peak_window_rows <= bound or not np.isfinite(
            fit["loss"]).all():
        raise AssertionError(f"22(g) {rep}")
    return rep, est


def p22_predict_windows(torch, np, est, kind):
    """22(h): C24 on the card: TorchEstimator.predict of 80 000 NCF rows
    (batch 8000) at pipeline windows 1, 2 and 4, bitwise equal."""
    rng = np.random.default_rng(SEED)
    x = np.stack([rng.integers(1, ML1M_USERS + 1, P22_PREDICT_ROWS),
                  rng.integers(1, ML1M_ITEMS + 1, P22_PREDICT_ROWS)],
                 1).astype(np.int64)
    outs, ms = {}, {}
    for w in P22_WINDOWS:
        est.predict(x, batch_size=ML1M_BATCH, pipeline_window=w)  # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[w] = est.predict(x, batch_size=ML1M_BATCH, pipeline_window=w)
        ms[w] = (time.perf_counter() - t0) * 1e3
    for w in P22_WINDOWS[1:]:
        if not np.array_equal(outs[w], outs[1]):
            raise AssertionError(f"22(h) window {w} differs from window 1")
    if outs[1].shape != (P22_PREDICT_ROWS, 2):
        raise AssertionError(f"22(h) shape {outs[1].shape}")
    log(f"22(h) TorchEstimator.predict of {P22_PREDICT_ROWS} rows on "
        f"{kind}, ms by window {ms} (host clock); windows bitwise")
    return dict(ms=ms)


def phase_autotune_friesian(torch, np, kind):
    """Phase 22: the autotuner's verdicts and the dispatch that reads them,
    and Friesian into the NCF fit (ROADMAP A9's first part, A11's second
    part, C24). TF32 off. The counts are zeroed before each part and read
    after it."""
    from analytics_zoo_tpu_torch.ops import autotune
    t0 = time.perf_counter()
    rep = {}
    with p17_tf32(torch, False):
        rep["a"] = p19_part(rep, "a", lambda: p22_attention_verdicts(
            torch, np, kind), phase=22)
        with autotune_mode("sync"):
            rep["b"] = p19_part(rep, "b", lambda: p22_flash_bench(
                torch, kind), phase=22)
        rep["c"] = p19_part(rep, "c", lambda: p22_kernel_verdicts(
            torch, np, kind), phase=22)
        rep["d"] = p19_part(rep, "d", lambda: p22_queue(torch, np, kind),
                            phase=22)
        rep["e"] = p19_part(rep, "e", lambda: p22_decode(torch, np, kind),
                            phase=22)
        rep["f"] = p19_part(rep, "f", lambda: p22_recsys(torch, np, kind),
                            phase=22)
        rep["g"], est = p19_part(rep, "g", lambda: p22_ml1m(torch, np, kind),
                                 phase=22)
        rep["h"] = p19_part(rep, "h", lambda: p22_predict_windows(
            torch, np, est, kind), phase=22)
    for part, name in (("a", "flash_attention_fwd"),
                       ("b", "flash_attention_fwd"),
                       ("d", None),
                       ("e", None),
                       ("f", "fused_embedding_lookup"),
                       ("f", "embedding_scatter_add"),
                       ("g", "fused_embedding_lookup"),
                       ("g", "embedding_scatter_add"),
                       ("h", "fused_embedding_lookup")):
        if name is not None and rep["launches"][part].get(name, 0) <= 0:
            raise AssertionError(f"22({part}) launched no {name}: "
                                 f"{rep['launches'][part]}")
    rep["seconds"] = time.perf_counter() - t0
    rep["verdict_file"] = autotune.get_tuner().path
    log(f"phase 22: seconds by part "
        f"{ {k: round(v, 1) for k, v in rep['part_seconds'].items()} }; "
        f"launches by part {rep['launches']}")
    return rep


# ------------------------------------------------- C20: cuDNN's noise
# cuDNN's deterministic algorithms (init_orca_context's default since
# ROADMAP C20) against its defaults, in turns (on, off, off, on) within
# one call: the TCN step (phase 13, fp32, TF32 off), the ResNet-50 bf16
# step (phase 17) and the SSD300-VGG bf16 step (phase 21), each at its
# phase's window; a step that slows past C20_SLOWDOWN is printed as such
# (the default stays: reproducibility is the reference's behaviour)
C20_SLOWDOWN = 1.5
C20_TURNS = (True, False, False, True)


def c20_cost(torch, np, kind, dev="cuda"):
    """ms a step with cudnn.deterministic on and off, in turns, and two
    serial AutoTS TCN searches under init_orca_context's default flags,
    held bitwise (the case that branched with cuDNN's defaults in slice
    19, dev/zouwu_path_torch.py --determinism)."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    t0 = time.perf_counter()
    rep = {}

    def tcn():
        x, y = tcn_bench_data(np)
        est = tcn_estimator(device=dev)
        return lambda: tcn_window(torch, est, x, y)

    def resnet():
        x, y = p17_data(np, P17_BATCH)
        clf = p17_classifier(np, "mixed_bfloat16")
        clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                    device=dev)
        est = clf.model.estimator
        xs, ys = est._tensors(x), est._tensors(y)
        return lambda: p17_window(torch, est, xs, ys)

    def ssd():
        x, boxes, labels = p21_images(np, P21_BATCH)
        net = p21_ssd(np, "mixed_bfloat16")
        est = p21_compile(net, device=dev)
        xs = est._tensors(x)
        ys = est._tensors(net.encode_ground_truth(boxes, labels))
        return lambda: p21_window(torch, est, xs, ys)

    try:
        cudnn.benchmark = False
        for name, make, tf32 in (("tcn_fp32", tcn, False),
                                 ("resnet50_bf16", resnet, True),
                                 ("ssd300_bf16", ssd, True)):
            with p17_tf32(torch, tf32):
                window = make()
                ms = {True: [], False: []}
                for det in C20_TURNS:
                    cudnn.deterministic = det
                    ms[det].append(window())
            on, off = float(np.mean(ms[True])), float(np.mean(ms[False]))
            rep[name] = dict(deterministic_ms=ms[True], default_ms=ms[False],
                             ratio=on / off, slower_than_limit=on / off
                             > C20_SLOWDOWN)
            log(f"C20 {name} on {kind}: {on:.3f} ms a step with "
                f"cudnn.deterministic ({ms[True]}), {off:.3f} with cuDNN's "
                f"defaults ({ms[False]}), ratio {on / off:.3f}"
                + (f" (over {C20_SLOWDOWN}x)" if on / off > C20_SLOWDOWN
                   else ""))
            del window
            if dev == "cuda":
                torch.cuda.empty_cache()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    rep["autots_bitwise"] = c20_autots(torch, np, kind, dev)
    rep["seconds"] = time.perf_counter() - t0
    return rep


def c20_autots(torch, np, kind, dev="cuda") -> bool:
    """Two serial AutoTS TCN searches (phase 20(e)'s recipe) under
    init_orca_context's flags: every trial's metric history bitwise."""
    import shutil
    from analytics_zoo_tpu_torch.common.context import (active_context,
                                                        init_orca_context,
                                                        stop_orca_context)
    from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config import TCNGridRandomRecipe
    made = active_context() is None
    if made:
        init_orca_context(device=dev)
    cudnn = torch.backends.cudnn
    _, train, val, _ = p20_frames(np)
    runs = []
    try:
        assert cudnn.deterministic and not cudnn.benchmark
        for i in range(2):
            trainer = AutoTSTrainer(dt_col="timestamp", target_col="value",
                                    horizon=1, logs_dir=P20_DIR,
                                    name=f"c20_{i}", device=dev,
                                    n_parallel=1)
            trainer.fit(train, val, recipe=TCNGridRandomRecipe(
                num_rand_samples=P20_PAR_SAMPLES, epochs=1))
            runs.append(np.asarray([t.metric_history
                                    for t in trainer.engine.trials]))
    finally:
        if made:
            stop_orca_context()
        shutil.rmtree(P20_DIR, ignore_errors=True)
    same = bool(np.array_equal(runs[0], runs[1]))
    log(f"C20 two serial AutoTS TCN searches ({runs[0].shape[0]} trials) "
        f"on {kind} under init_orca_context's cudnn.deterministic: "
        f"histories bitwise {same}")
    if not same:
        raise AssertionError(f"C20: the AutoTS searches differ: {runs}")
    return same


# ----------------------------------------- phase 23: across ranks
# Several ranks share the one card over gloo (NCCL refuses two ranks on
# one card); each rank is a process of parallel/launch.py. Phase 23 runs
# one group of 2 ranks and one of 4, each through every sub-phase, and
# one NCCL group of 1 rank through init_orca_context(cluster_mode=
# "multihost").
P23_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "phase23")
P23_TIMEOUT = 900
# (b) BERT-Base fine-tuning, BASELINE.json's fifth configuration: 32 x
# 128 tokens, Adam at BERT fine-tuning's rate, dropout 0, five steps (the
# last four timed)
P23_BERT_STEPS = 2          # 5 until phase 25 joined the run
P23_BERT_LR = 2e-5
P23_BERT = {2: ("dp", "fsdp", "dp,tp2"), 4: ("dp2,tp2",)}
P23_PARAM_ATOL = 1e-5
# (c) NCF at MovieLens-1M width, batch 8000, Adam(1e-3), 20 steps. The
# loss within P23_PARAM_ATOL at every step; every parameter within it,
# unless a ReLU input took the other side of 0 from the one-rank fit's:
# a rank's GEMMs see other shapes than one rank's (4000 rows, or half the
# columns), so an input within rounding of 0 can flip, and Adam then moves
# the rows of that sample by up to a step (under "dp2,tp2" from step 14:
# 5.5e-5 at the flip, 2.92e-4 six steps on, on 332 of 392 745 elements;
# dev/parallel_ncf_steps.py and chip_smoke.py runs, PERF.md §6).
# Then the parameters are held within P23_PARAM_ATOL on all but
# P23_NCF_FLIP_SHARE of the elements and all within P23_NCF_FLIP_ATOL
# (just above those readings), and the witness must hold: every rank
# compares each step's ReLU inputs (P23_NCF_RELU) with the one-rank fit's,
# and each input that flipped at the first step with a flip lies within
# P23_NCF_FLIP_NEAR of 0 on both sides (inputs' scale 3e-2; up to the
# flip the parameters sit within 2.5e-7 of one rank's, which moves an
# input by about 1.4e-6 at most). A fault that moves a parameter by a
# fraction of a step shows as a flip far from 0, or as no flip at all.
P23_NCF_STEPS = 20
P23_NCF_LR = 1e-3
P23_NCF_FLIP_SHARE = 2e-3
P23_NCF_FLIP_ATOL = 5e-4
P23_NCF_FLIP_NEAR = 1e-5
P23_NCF_RELU = ("dense_1", "dense_2", "dense_3")
P23_NCF = {2: ("dp", "tp2"), 4: ("dp2,tp2",)}
# (d), (e) ring and Ulysses attention at BERT-Base's heads: b, s, h, d
P23_ATTN = (2, 8192, 12, 64)
# (f) MoE at Switch-Base-8's FFN widths (google/switch-base-8: d_model
# 768, d_ff 3072, 8 experts, top-1), JAX MoEModule's capacity factor
# 1.25, 8 x 512 tokens
P23_MOE = dict(n_experts=8, d_model=768, d_hidden=3072, k=1,
               capacity_factor=1.25)
P23_MOE_TOKENS = (8, 512)
P23_MOE_LAYOUTS = {2: ("ep2",), 4: ("ep4",)}
P23_MOE_STEP = {4: "dp2,ep2"}
P23_MOE_RTOL = 1e-5


def p23_bert_inputs(np):
    return train_inputs(np.random.RandomState(SEED + 23),
                        TRAIN_BATCH * P23_BERT_STEPS)


#: BertConfig's fields over BERT-Base's defaults (none: BERT-Base)
P23_BERT_SIZE = {}


def p23_bert_config(dtype):
    return dict(P23_BERT_SIZE, use_flash=True, hidden_drop=0.0,
                attn_drop=0.0, dtype=dtype)


def p23_bert_estimator(torch, state, dtype, strategy="dp", dev="cuda"):
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.text.bert import bert_tp_rules
    return Estimator.from_torch(
        model=bert_classifier(state, **p23_bert_config(dtype)),
        loss="sparse_categorical_crossentropy_logits",
        optimizer=Adam(P23_BERT_LR), strategy=strategy,
        param_rules=bert_tp_rules(), seed=SEED, device=dev)


def p23_ncf_data(np):
    rng = np.random.RandomState(SEED + 230)
    n = BATCH * P23_NCF_STEPS
    x = np.stack([rng.randint(1, NCF["user_count"] + 1, n),
                  rng.randint(1, NCF["item_count"] + 1, n)],
                 1).astype(np.float32)
    return x, rng.randint(0, NCF["class_num"], n).astype(np.int32)


def p23_relu_hooks(est, fn):
    """Forward hooks on NCF's ReLU layers (``P23_NCF_RELU``): ``fn(layer,
    step, pre-activation)`` at each forward with a gradient; the
    handles."""
    import torch
    mods = dict(est.model.named_modules())

    def hook(name):
        def call(mod, inp, out):
            if torch.is_grad_enabled() and est._py_step < P23_NCF_STEPS:
                fn(name, est._py_step, out.detach().float().cpu())
        return call
    return [mods[n].register_forward_hook(hook(n)) for n in P23_NCF_RELU]


def p23_ncf_model(torch, state, strategy, dev="cuda"):
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import NeuralCF
    ncf = NeuralCF(**NCF)
    ncf.model.module.load_state_dict(state)
    ncf.set_strategy(strategy, param_rules=NeuralCF.tp_param_rules())
    ncf.compile(optimizer=Adam(P23_NCF_LR),
                loss="sparse_categorical_crossentropy", device=dev)
    return ncf


class P23MoENet:
    """The MoE training step's model: the MoE block and a 2-class head
    over the mean of the sequence (built inside torch's import)."""

    @staticmethod
    def make(torch):
        from analytics_zoo_tpu_torch.common.flax_compat import Dense
        from analytics_zoo_tpu_torch.ops.moe import MoEModule

        class Net(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.moe = MoEModule(**P23_MOE)
                self.Dense_0 = Dense(P23_MOE["d_model"], 2)

            def forward(self, x, train: bool = False):
                return self.Dense_0(self.moe(x, train=train).mean(1))
        net = Net()
        seeded_weights(net, SEED + 233)
        return net


def p23_moe_data(np):
    rng = np.random.RandomState(SEED + 232)
    b, s = P23_MOE_TOKENS
    x = rng.standard_normal((b, s, P23_MOE["d_model"])).astype(np.float32)
    return x, rng.randint(0, 2, b).astype(np.int32)


def p23_references(torch, np, kind, dev="cuda"):
    """The one-rank runs every rank is held to, written to P23_DIR: BERT's
    and NCF's initial weights, their one-rank fits (step losses, the fp32
    parameters after the last step), the MoE step's; and the one-rank
    flash kernel's times over the whole sequence of (d)."""
    import shutil
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    shutil.rmtree(P23_DIR, ignore_errors=True)
    os.makedirs(P23_DIR)
    rep = {}
    state = bert_classifier(None, **p23_bert_config(None)).state_dict()
    torch.save(state, os.path.join(P23_DIR, "bert_init.pt"))
    ids, labels = p23_bert_inputs(np)
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        est = p23_bert_estimator(torch, state, dtype, dev=dev)
        torch.cuda.synchronize() if dev == "cuda" else None
        t0 = time.perf_counter()
        est.fit((ids, labels), epochs=1, batch_size=TRAIN_BATCH,
                shuffle=False)
        secs = time.perf_counter() - t0
        ref = {"losses": est.step_losses, "fit_s": secs}
        if dtype is None:
            torch.save({k: v.detach().cpu() for k, v in
                        est.model.state_dict().items()},
                       os.path.join(P23_DIR, "bert_fp32_after.pt"))
        rep[f"bert_{label}"] = ref
        log(f"phase 23 reference: BERT-Base {label} one-rank fit on {kind}, "
            f"{P23_BERT_STEPS} steps of {TRAIN_BATCH}x{TRAIN_LEN}: losses "
            f"{[round(v, 6) for v in ref['losses']]} ({secs:.2f} s, the "
            "first step included)")
        del est
    from analytics_zoo_tpu_torch.models import NeuralCF
    ncf = NeuralCF(**NCF)
    seeded_weights(ncf.model.module, SEED + 23)
    nstate = {k: v.clone() for k, v in ncf.model.module.state_dict().items()}
    torch.save(nstate, os.path.join(P23_DIR, "ncf_init.pt"))
    x, y = p23_ncf_data(np)
    one = p23_ncf_model(torch, nstate, "dp", dev)
    est = one.model._ensure_estimator(for_training=True)
    relu = {n: torch.zeros((P23_NCF_STEPS, BATCH, u)) for n, u in
            zip(P23_NCF_RELU, NCF["hidden_layers"])}

    def keep(name, step, pre):
        # the step's own forward comes last (a flop-counting pass on the
        # step before's batch may come first)
        relu[name][step] = pre
    hooks = p23_relu_hooks(est, keep)
    one.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    for h in hooks:
        h.remove()
    torch.save(relu, os.path.join(P23_DIR, "ncf_relu.pt"))
    torch.save({k: v.detach().cpu() for k, v in
                est.model.state_dict().items()},
               os.path.join(P23_DIR, "ncf_after.pt"))
    rep["ncf"] = {"losses": est.step_losses}
    net = P23MoENet.make(torch)
    torch.save(net.state_dict(), os.path.join(P23_DIR, "moe_init.pt"))
    mx, my = p23_moe_data(np)
    mest = Estimator.from_torch(model=net, loss=(
        "sparse_categorical_crossentropy_logits"), optimizer="adam",
        seed=SEED, device=dev)
    mest.fit((mx, my), epochs=1, batch_size=len(mx), shuffle=False)
    torch.save({k: v.detach().cpu() for k, v in
                mest.model.state_dict().items()},
               os.path.join(P23_DIR, "moe_after.pt"))
    rep["moe_step"] = {"losses": mest.step_losses}
    with open(os.path.join(P23_DIR, "refs.json"), "w") as fh:
        json.dump(rep, fh)
    # the one-rank kernel over the whole sequence of (d)
    b, s, h, d = P23_ATTN
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(SEED + 234)
        q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device=dev)
                      .to(dtype) for _ in range(4))
        for causal in (False, True):
            fwd = cuda_ms(lambda: fa.flash_attention(q, k, v, causal),
                          iters=3, warmup=1) if dev == "cuda" else None
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))

            def both():
                out = fa.flash_attention(qq, kk, vv, causal)
                out.backward(g)
            both_ms = cuda_ms(both, iters=3, warmup=1) \
                if dev == "cuda" else None
            times[f"{str(dtype)[6:]}_{'causal' if causal else 'full'}"] = \
                dict(fwd_ms=fwd, fwd_bwd_ms=both_ms)
    rep["one_rank_flash"] = times
    log(f"phase 23 reference: the one-rank flash kernel over b {b} s {s} "
        f"h {h} d {d} on {kind}: {times}")
    return rep


def p23_rank(cfg):
    """One rank of a phase 23 group: (a) the collectives, (b) BERT-Base
    under each of the group's strategies, (c) NCF, (d) ring attention,
    (e) Ulysses, (f) MoE; each part's launch counts are its own."""
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.common.context import (OrcaContext,
                                                        init_orca_context,
                                                        stop_orca_context)
    from analytics_zoo_tpu_torch.learn import estimator
    # the phase's sizes where the caller cut them (a rehearsal)
    globals().update(cfg.get("sizes") or {})
    OrcaContext.default_matmul_precision = "float32"   # TF32 off
    init_orca_context(cluster_mode="multihost", device=cfg["device"])
    # each rank's summaries under the phase's directory (removed after)
    estimator.DEFAULT_LOG_DIR = os.path.join(
        P23_DIR, f"tb{torch.distributed.get_world_size()}_"
        f"{torch.distributed.get_rank()}")
    out = {}
    try:
        for part, fn in (("a", p23_collectives), ("b", p23_bert),
                         ("c", p23_ncf), ("d", p23_ring),
                         ("e", p23_ulysses), ("f", p23_moe)):
            if part in cfg["parts"]:
                t0 = time.perf_counter()
                out[part] = fn(torch, np, cfg)
                out[part]["seconds"] = time.perf_counter() - t0
    finally:
        stop_orca_context()
    return out


def p23_sync(torch, cfg):
    if cfg["device"].startswith("cuda"):
        torch.cuda.synchronize()


def p23_collectives(torch, np, cfg):
    """(a) each collective against the same data movement on one rank
    (every rank makes every rank's input from its seed), bitwise; the sums
    within 1 ulp a summand; the staging table."""
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.parallel import collectives as C
    from analytics_zoo_tpu_torch.parallel import mesh as M
    dev = torch.device(cfg["device"])
    world = dist.get_world_size()
    mesh = M.build_mesh((M.DATA_AXIS,), (world,))
    r = mesh.rank

    def inp(rank, shape, salt):
        gen = torch.Generator(device="cpu").manual_seed(1000 * salt + rank)
        return torch.randn(shape, generator=gen).to(dev)
    rows = 256 * world
    xs = [inp(i, (rows, 1024), 0) for i in range(world)]
    eps = torch.finfo(torch.float32).eps
    res = {}

    def timed(fn):
        p23_sync(torch, cfg)
        t0 = time.perf_counter()
        got = fn()
        p23_sync(torch, cfg)
        return got, (time.perf_counter() - t0) * 1e3
    got, ms = timed(lambda: C.all_gather(xs[r], mesh, "data", 1))
    res["all_gather"] = dict(ok=torch.equal(got, torch.cat(xs, 1)), ms=ms)
    got, ms = timed(lambda: C.all_to_all(xs[r], mesh, "data", 0, 1))
    want = torch.cat([x[r * 256:(r + 1) * 256] for x in xs], 1)
    res["all_to_all"] = dict(ok=torch.equal(got, want), ms=ms)
    got, ms = timed(lambda: C.ring_shift(xs[r], mesh, "data"))
    res["ring_shift"] = dict(ok=torch.equal(got, xs[(r - 1) % world]),
                             ms=ms)
    got, ms = timed(lambda: C.all_reduce(xs[r], mesh, "data"))
    total = sum(x.double() for x in xs)
    mag = sum(x.double().abs() for x in xs)
    # within 1 ulp a summand: world x eps x the sum of the magnitudes
    res["all_reduce"] = dict(ok=bool(((got.double() - total).abs()
                                      <= world * eps * mag).all()), ms=ms)
    if world == 2:
        # two summands: one rounding, the one-rank sum's bits
        res["all_reduce"]["bitwise"] = torch.equal(got, xs[0] + xs[1])
    got, ms = timed(lambda: C.reduce_scatter(xs[r], mesh, "data", 0))
    sl = slice(r * 256, (r + 1) * 256)
    res["reduce_scatter"] = dict(ok=bool(((got.double() - total[sl]).abs()
                                          <= world * eps * mag[sl]).all()),
                                 ms=ms)
    res["table"] = C.staging_table()
    res["world"] = world
    bad = [op for op, v in res.items() if isinstance(v, dict)
           and not v.get("ok", True)]
    if bad:
        raise AssertionError(f"23(a) rank {r}: {bad} differ: {res}")
    return res


def p23_bytes(np, est):
    """(bytes of parameters and optimizer state this rank holds, bytes of
    the whole, whether a sharded leaf is held whole anywhere)."""
    held = sum(p.numel() * p.element_size() for p in est._params)
    whole = sum(int(np.prod(s.shape)) * 4 if (s := est._shards.get(n))
                else p.numel() * p.element_size()
                for n, p in zip(est._names, est._params))
    state = est._opt_state or {}
    slots = sum(t.numel() * t.element_size() for v in state.values()
                if isinstance(v, list) for t in v
                if hasattr(t, "numel"))
    whole_leaf = any(int(np.prod(s.local_shape)) >= int(np.prod(s.shape))
                     for s in est._shards.values())
    return dict(param_bytes=held, whole_param_bytes=whole,
                opt_state_bytes=slots, sharded_leaf_whole=whole_leaf)


def p23_bert(torch, np, cfg):
    """(b) BERT-Base fine-tuning under each strategy of the group, fp32
    and bf16: the one-rank fit's losses and (fp32) parameters; bytes
    held; the flash kernels' launches a step; ms a step and the
    collectives' share."""
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.parallel import collectives as C
    with open(os.path.join(P23_DIR, "refs.json")) as fh:
        refs = json.load(fh)
    state = torch.load(os.path.join(P23_DIR, "bert_init.pt"))
    after = torch.load(os.path.join(P23_DIR, "bert_fp32_after.pt"))
    ids, labels = p23_bert_inputs(np)
    out = {}
    for strategy in cfg["bert"]:
        for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            est = p23_bert_estimator(torch, state, dtype, strategy,
                                     cfg["device"])
            blocks = est._batch_shards
            idx = est._mesh.data_index(est.strategy.batch_axes())
            rows = p23_rows(np, len(ids), TRAIN_BATCH, idx, blocks)
            _build.reset_launch_counts()
            # the first step, then the other four timed, the collectives'
            # host seconds beside (one fit of five steps, the same bits)
            first = TRAIN_BATCH // blocks
            est.fit((ids[rows][:first], labels[rows][:first]), epochs=1,
                    batch_size=TRAIN_BATCH, shuffle=False)
            C.reset_stats()
            p23_sync(torch, cfg)
            t0 = time.perf_counter()
            est.fit((ids[rows][first:], labels[rows][first:]), epochs=1,
                    batch_size=TRAIN_BATCH, shuffle=False)
            p23_sync(torch, cfg)
            secs = time.perf_counter() - t0
            counts = _build.launch_counts()
            ref = refs[f"bert_{label}"]["losses"]
            loss_err = float(np.abs(np.asarray(est.step_losses)
                                    - np.asarray(ref)).max())
            rec = dict(losses=est.step_losses, loss_err=loss_err,
                       launches={k: v for k, v in counts.items() if v},
                       step_ms=secs / (P23_BERT_STEPS - 1) * 1e3,
                       collective_share=C.stats_seconds() / secs,
                       collectives={k: list(v) for k, v in C.stats.items()},
                       **p23_bytes(np, est))
            if dtype is None:
                whole = est.gathered_state_dict()
                rec["param_err"] = max(
                    float((whole[k].float().cpu() - after[k].float())
                          .abs().max()) for k in after)
            n_head = P23_BERT_SIZE.get("n_head", 12)
            head_dim = P23_BERT_SIZE.get("hidden_size", 768) // n_head
            heads = [s.local_shape[0] // head_dim
                     for n, s in est._shards.items()
                     if n.endswith("block_0.attention.query.weight")]
            rec["heads_a_rank"] = heads[0] if heads else n_head
            out[f"{strategy}/{label}"] = rec
            del est
            if cfg["device"].startswith("cuda"):
                torch.cuda.empty_cache()
    return out


def p23_rows(np, n, batch, index, blocks):
    """The rows of block ``index`` of every global batch."""
    h = batch // blocks
    return np.arange((n // batch) * batch).reshape(-1, blocks, h)[
        :, index, :].ravel()


def p23_ncf(torch, np, cfg):
    """(c) NCF at MovieLens-1M width under each strategy of the group:
    the one-rank fit's losses and parameters; B1 and B1b launches and the
    tables' shard shapes."""
    from analytics_zoo_tpu_torch.ops import _build
    state = torch.load(os.path.join(P23_DIR, "ncf_init.pt"))
    after = torch.load(os.path.join(P23_DIR, "ncf_after.pt"))
    with open(os.path.join(P23_DIR, "refs.json")) as fh:
        ref = json.load(fh)["ncf"]["losses"]
    relu = torch.load(os.path.join(P23_DIR, "ncf_relu.pt"))
    x, y = p23_ncf_data(np)
    out = {}
    for strategy in cfg["ncf"]:
        ncf = p23_ncf_model(torch, state, strategy, cfg["device"])
        est = ncf.model._ensure_estimator(for_training=True)
        blocks = est._batch_shards
        idx = est._mesh.data_index(est.strategy.batch_axes())
        rows = p23_rows(np, len(x), BATCH, idx, blocks)
        per = BATCH // blocks
        flips = {"count": 0, "step": None, "near": 0.0, "first": []}

        def compare(name, step, pre):
            # this rank's rows of the step against the one-rank fit's
            at = rows[step * per:(step + 1) * per]
            want = relu[name][step, torch.from_numpy(at - step * BATCH)]
            r, u = ((pre > 0) != (want > 0)).nonzero(as_tuple=True)
            if not len(r):
                return
            flips["count"] += len(r)
            if flips["step"] is None or step < flips["step"]:
                flips.update(step=step, near=0.0, first=[])
            if step == flips["step"]:
                w, g = want[r, u], pre[r, u]
                flips["near"] = max(flips["near"], float(torch.maximum(
                    w.abs(), g.abs()).max()))
                flips["first"] += [
                    [name, int(at[i]), int(j), float(a), float(b)]
                    for i, j, a, b in zip(r[:4].tolist(), u[:4].tolist(),
                                          w[:4].tolist(), g[:4].tolist())]
        hooks = p23_relu_hooks(est, compare)
        _build.reset_launch_counts()
        ncf.fit(x[rows], y[rows], batch_size=BATCH, nb_epoch=1,
                shuffle=False)
        counts = _build.launch_counts()
        for h in hooks:
            h.remove()
        whole = est.gathered_state_dict()
        out[strategy] = dict(
            loss_err=float(np.abs(np.asarray(est.step_losses)
                                  - np.asarray(ref)).max()),
            param_err=max(float((whole[k].float().cpu() - after[k].float())
                                .abs().max()) for k in after),
            param_errs={k: float((whole[k].float().cpu() - after[k].float())
                                 .abs().max()) for k in after},
            past=sum(int(((whole[k].float().cpu() - after[k].float()).abs()
                          > P23_PARAM_ATOL).sum()) for k in after),
            elements=sum(v.numel() for v in after.values()),
            launches={k: v for k, v in counts.items() if v},
            shards={n: list(s.local_shape) for n, s in est._shards.items()},
            covered=sorted(set(est._shards) - set(est._gathered)),
            relu_flips=flips)
        del ncf, est
    return out


def p23_qkv(torch, dtype, dev, salt):
    b, s, h, d = P23_ATTN
    gen = torch.Generator(device=dev).manual_seed(SEED + 234 + salt)
    return [torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def p23_f64(torch, q, k, v, g, causal):
    """The float64 softmax attention and its gradients (out, dq, dk, dv
    of sum(out * g)), one (batch, head) at a time."""
    b, s, h, d = q.shape
    out, dq, dk, dv = (torch.empty((b, s, h, d), dtype=torch.float64,
                                   device=q.device) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril() \
        if causal else None
    for i in range(b):
        for j in range(h):
            qq, kk, vv, gg = (t[i, :, j].double() for t in (q, k, v, g))
            sc = qq @ kk.T * scale
            if mask is not None:
                sc = sc.masked_fill(~mask, float("-inf"))
            p = torch.softmax(sc, -1)
            out[i, :, j] = p @ vv
            dp = gg @ vv.T
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq[i, :, j] = ds @ kk * scale
            dk[i, :, j] = ds.T @ qq * scale
            dv[i, :, j] = p.T @ gg
            del sc, p, dp, ds
    return out, dq, dk, dv


def p23_attn_check(torch, got, want, dtype, q_blk, k_pre, v_pre, causal,
                   lse_blk, grads=False, blocks=1):
    """A reading of ``got`` against ``want`` under phase 3's flash limits:
    fp32 FLASH_ATOL (forward) or BWD_ATOL x the largest |want| (each
    gradient); bf16 FLASH_BF16_* with the flip term (forward) or
    BWD_BF16_ATOL x the largest |want| with FLASH_BF16_ULPS ulps
    (gradients), and where ``blocks`` partial results were each rounded
    to bf16 (the ring: each block's output and gradients leave the kernel
    in bf16 and are merged or summed) ``blocks - 1`` more bf16 ulps of
    the largest |want|. Returns (ratio to the limit, share of elements
    that differ)."""
    top = float(want.float().abs().max())
    if dtype == torch.float32:
        err = float((got.float() - want.float()).abs().max())
        return (err / (BWD_ATOL * max(top, 1e-30)) if grads
                else err / FLASH_ATOL), 0.0
    extra = (blocks - 1) * 2.0 ** -8 * top
    if grads:
        return bf16_reading(got, want, BWD_BF16_ATOL * top + extra)
    flip = bf16_flip_scale(q_blk, k_pre, v_pre, causal, lse_blk)
    return bf16_reading(got, want, FLASH_BF16_ATOL + extra, flip=flip)


def p23_attention(torch, np, cfg, kind):
    """(d) ring or (e) Ulysses attention over "sp<world>" on this rank's
    sequence block, fp32 and bf16, causal and not, the flash route (and
    the ring's plain route): the output and dq, dk, dv held against the
    one-rank flash kernel over the whole sequence (and in fp32 the
    float64 softmax); B3-B5 launches; ms forward and backward."""
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy
    dev = torch.device(cfg["device"])
    world = dist.get_world_size()
    mesh = ShardingStrategy.parse(f"sp{world}").build_mesh()
    my = mesh.coord("seq")
    b, s, h, d = P23_ATTN
    s_loc = s // world
    blk = slice(my * s_loc, (my + 1) * s_loc)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = p23_qkv(torch, dtype, dev, 0)
        for causal in (False, True):
            name = f"{str(dtype)[6:]}_{'causal' if causal else 'full'}"
            # the one-rank kernel over the whole sequence
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            ref, lse = fa.flash_attention_with_lse(qq, kk, vv, causal)
            ref.backward(g)
            want = (ref.detach()[:, blk], qq.grad[:, blk], kk.grad[:, blk],
                    vv.grad[:, blk])
            lse_blk = lse.detach().reshape(b, h, s)[:, :, blk].reshape(
                b * h, s_loc)
            del qq, kk, vv, ref
            f64 = p23_f64(torch, q, k, v, g, causal) \
                if dtype == torch.float32 else None
            # the flash route, and the ring's plain route too
            for route, flash in (("", True), ("_plain", False))[
                    :2 if kind == "ring" else 1]:
                out[name + route] = p23_route(
                    torch, cfg, kind, mesh, flash, (q, k, v, g), blk,
                    causal, want, lse_blk, f64)
            del f64
    return out


def p23_route(torch, cfg, kind, mesh, flash, qkvg, blk, causal, want,
              lse_blk, f64):
    """One route of (d) or (e) on this rank's block: its readings against
    the one-rank kernel (and float64), launches and ms."""
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops.ring_attention import (
        ring_attention_local)
    from analytics_zoo_tpu_torch.ops.ulysses import ulysses_attention_local
    q, k, v, g = qkvg
    world = dist.get_world_size()
    my = mesh.coord("seq")
    s_loc = blk.stop - blk.start
    lq, lk, lv = (t[:, blk].contiguous().requires_grad_() for t in (q, k, v))
    dist.barrier()
    _build.reset_launch_counts()
    p23_sync(torch, cfg)
    t0 = time.perf_counter()
    if kind == "ring":
        got = ring_attention_local(lq, lk, lv, mesh=mesh, causal=causal,
                                   use_flash=flash)
    else:
        got = ulysses_attention_local(lq, lk, lv, mesh=mesh, causal=causal,
                                      use_flash=flash)
    p23_sync(torch, cfg)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_counts = _build.launch_counts()
    t0 = time.perf_counter()
    got.backward(g[:, blk])
    p23_sync(torch, cfg)
    bwd_ms = (time.perf_counter() - t0) * 1e3
    counts = _build.launch_counts()
    pre = slice(0, (my + 1) * s_loc) if causal else slice(None)
    outs = (got.detach(), lq.grad, lk.grad, lv.grad)
    readings = {}
    for i, (nm, a, w) in enumerate(zip(("out", "dq", "dk", "dv"), outs,
                                       want)):
        readings[nm] = p23_attn_check(
            torch, a, w, q.dtype, lq.detach() if i == 0 else None,
            k[:, pre] if i == 0 else None, v[:, pre] if i == 0 else None,
            causal, lse_blk, grads=i > 0,
            blocks=world if kind == "ring" else 1)
    rec = dict(readings=readings, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
               fwd_launches=fwd_counts.get("flash_attention_fwd", 0),
               launches={k: v for k, v in counts.items() if v})
    if f64 is not None:
        rec["f64"] = {nm: p23_attn_check(
            torch, a, w[:, blk], torch.float32, None, None, None, causal,
            None, grads=i > 0)[0]
            for i, (nm, a, w) in enumerate(zip(("out", "dq", "dk", "dv"),
                                               outs, f64))}
    return rec


def p23_ring(torch, np, cfg):
    return p23_attention(torch, np, cfg, "ring")


def p23_ulysses(torch, np, cfg):
    return p23_attention(torch, np, cfg, "ulysses")


def p23_moe(torch, np, cfg):
    """(f) MoE at Switch-Base-8's FFN widths: the module under each expert
    layout of the group (the output, the aux loss and every gradient of
    sum(out * g) + aux against one rank's, within P23_MOE_RTOL of each
    one's largest element), the tokens a rank's experts took; and where
    the group has it the "dp2,ep2" training step with ep_param_rules
    against the one-rank step."""
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.ops import moe
    from analytics_zoo_tpu_torch.parallel import collectives as C
    from analytics_zoo_tpu_torch.parallel import mesh as M
    from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy
    dev = torch.device(cfg["device"])
    world = dist.get_world_size()
    init = torch.load(os.path.join(P23_DIR, "moe_init.pt"))
    mx, my = p23_moe_data(np)
    x = torch.from_numpy(mx).to(dev)
    g = torch.from_numpy(np.random.RandomState(SEED + 235).standard_normal(
        mx.shape).astype(np.float32)).to(dev)
    out = {}

    def run(net):
        xx = x.clone().requires_grad_()
        with moe.collect_aux_losses() as aux:
            y = net(xx)
        return y, aux[0], xx

    for layout in cfg["moe"]:
        net = moe.MoEModule(**P23_MOE).to(dev)
        net.load_state_dict({k[len("moe."):]: v for k, v in init.items()
                             if k.startswith("moe.")})
        saved = M._default_mesh
        M.set_default_mesh(None)
        y1, a1, x1 = run(net)
        ((y1 * g).sum() + a1).backward()
        ref = (y1.detach(), float(a1), x1.grad,
               {n: p.grad.clone() for n, p in net.named_parameters()})
        net.zero_grad()
        mesh = ShardingStrategy.parse(layout).build_mesh()
        ep = mesh.shape.get("expert", 1)
        y2, a2, x2 = run(net)
        # every rank holds the whole output: the ranks' sum counts it ep
        # times
        (((y2 * g).sum() + a2) / ep).backward()
        grads = {n: C.all_reduce_(p.grad.clone(), mesh, ["expert"])
                 for n, p in net.named_parameters()}
        dx = C.all_reduce_(x2.grad.clone(), mesh, ["expert"])

        def rel(a, b):
            return float((a - b).abs().max() / max(float(b.abs().max()),
                                                   1e-30))
        rec = dict(out=rel(y2.detach(), ref[0]), aux=abs(float(a2) - ref[1]),
                   dx=rel(dx, ref[2]),
                   grads={n: rel(grads[n], ref[3][n]) for n in grads},
                   dispatched=net.last_dispatch)
        out[layout] = rec
        M.set_default_mesh(saved)
    if cfg.get("moe_step"):
        layout = cfg["moe_step"]
        net = P23MoENet.make(torch)
        net.load_state_dict(init)
        est = Estimator.from_torch(
            model=net, loss="sparse_categorical_crossentropy_logits",
            optimizer="adam", strategy=layout,
            param_rules=moe.ep_param_rules(), seed=SEED, device=dev)
        blocks = est._batch_shards
        idx = est._mesh.data_index(est.strategy.batch_axes())
        rows = p23_rows(np, len(mx), len(mx), idx, blocks)
        est.fit((mx[rows], my[rows]), epochs=1, batch_size=len(mx),
                shuffle=False)
        after = torch.load(os.path.join(P23_DIR, "moe_after.pt"))
        with open(os.path.join(P23_DIR, "refs.json")) as fh:
            ref_loss = json.load(fh)["moe_step"]["losses"]
        whole = est.gathered_state_dict()
        out["step"] = dict(
            layout=layout, loss=est.step_losses,
            loss_err=float(np.abs(np.asarray(est.step_losses)
                                  - np.asarray(ref_loss)).max()),
            param_err=max(float((whole[k].float().cpu() - after[k].float())
                                .abs().max()) for k in after),
            covered=sorted(set(est._shards) - set(est._gathered)),
            dispatched=est.model.moe.last_dispatch)
    return out


def p23_nccl(cfg):
    """(a) the NCCL group of one rank: init_orca_context(cluster_mode=
    "multihost") with a coordinator; an NCF fit under it bitwise the fit
    of the same model before the group; one all_reduce through NCCL."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.common.context import (OrcaContext,
                                                        init_orca_context,
                                                        stop_orca_context)
    from analytics_zoo_tpu_torch.parallel.launch import free_port
    globals().update(cfg.get("sizes") or {})
    from analytics_zoo_tpu_torch.learn import estimator
    OrcaContext.default_matmul_precision = "float32"
    estimator.DEFAULT_LOG_DIR = os.path.join(P23_DIR, "tb_nccl")
    state = torch.load(os.path.join(P23_DIR, "ncf_init.pt"))
    x, y = p23_ncf_data(np)
    n = BATCH * 3
    ends = []
    for grouped in (False, True):
        if grouped:
            ctx = init_orca_context(
                cluster_mode="multihost",
                coordinator_address=f"127.0.0.1:{free_port()}",
                num_processes=1, process_id=0)
            backend = str(dist.get_backend())
            t = torch.arange(8, dtype=torch.float32, device="cuda")
            dist.all_reduce(t)
            reduced = bool(torch.equal(t, torch.arange(
                8, dtype=torch.float32, device="cuda")))
        ncf = p23_ncf_model(torch, state, "dp", "cuda")
        ncf.fit(x[:n], y[:n], batch_size=BATCH, nb_epoch=1, shuffle=False)
        ends.append((ncf.model.estimator.step_losses,
                     {k: v.detach().cpu() for k, v in
                      ncf.model.module.state_dict().items()}))
    devices = [str(d) for d in ctx.devices]
    stop_orca_context()
    same = ends[0][0] == ends[1][0] and all(
        torch.equal(ends[0][1][k], ends[1][1][k]) for k in ends[0][1])
    return dict(backend=backend, devices=devices, all_reduce=reduced,
                bitwise=bool(same), losses=ends[1][0])


def phase_parallel(torch, np, kind, dev="cuda", sizes=None,
                   parts="abcdef"):
    """Phase 23: the strategies across ranks, several ranks sharing the
    card over gloo (a group of 2 and one of 4) and a one-rank NCCL group.
    ``sizes``: module constants to cut (a rehearsal), in every rank too;
    ``parts``: the sub-phases the groups run (all by default).
    Returns the report; fails on any rank's failure or any reading past
    its limit."""
    import shutil
    from analytics_zoo_tpu_torch.learn import estimator
    globals().update(sizes or {})
    t0 = time.perf_counter()
    log_dir = estimator.DEFAULT_LOG_DIR
    estimator.DEFAULT_LOG_DIR = os.path.join(P23_DIR, "tb_main")
    try:
        return p23_groups(torch, np, kind, dev, sizes, parts, t0)
    finally:
        estimator.DEFAULT_LOG_DIR = log_dir
        shutil.rmtree(P23_DIR, ignore_errors=True)


def launch_side_by_side(launch, fn, jobs, device, timeout):
    """Launch the rank groups of ``jobs`` ({world: cfg}) at once, each on
    a thread of its own: ``({world: the ranks' results}, {world:
    seconds})``. A group's failure is raised once every group has ended.
    The groups share the card (and its host's cores), so their ms are
    rehearsal costs of ranks sharing one card (ROADMAP R18, R20); run in
    turn they took half of phases 23 and 24."""
    import threading
    results, secs, errors = {}, {}, {}

    def one(world, cfg):
        t1 = time.perf_counter()
        try:
            results[world] = launch(fn, world, args=(cfg,), device=device,
                                    backend="gloo", timeout=timeout)
        except BaseException as e:      # raised below, after the others
            errors[world] = e
        secs[world] = time.perf_counter() - t1

    threads = [threading.Thread(target=one, args=(w, c), name=f"ranks-{w}")
               for w, c in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for world in jobs:
        if world in errors:
            raise errors[world]
    return {w: results[w] for w in jobs}, secs


def p23_groups(torch, np, kind, dev, sizes, parts, t0):
    """phase_parallel's body: the references, the groups, the report."""
    import threading
    from analytics_zoo_tpu_torch.parallel.launch import launch
    with p17_tf32(torch, False):
        rep = {"references": p23_references(torch, np, kind, dev)}
    if dev == "cuda":
        torch.cuda.empty_cache()
    gloo_dev = "cuda:0" if dev == "cuda" else "cpu"
    nccl = {}

    def one_rank_nccl():
        t1 = time.perf_counter()
        try:
            nccl["rec"] = launch(p23_nccl, 1, args=({"sizes": sizes},),
                                 device="cuda", group=False,
                                 timeout=P23_TIMEOUT)[0]
        except BaseException as e:      # raised again below
            nccl["error"] = e
        nccl["seconds"] = time.perf_counter() - t1

    # the one-rank NCCL group runs beside the gloo groups, which run side
    # by side (its checks are bitwise within its own process; the groups'
    # ms share the card)
    runner = threading.Thread(target=one_rank_nccl, name="p23-nccl")
    if dev == "cuda":
        runner.start()
    jobs = {world: dict(device=gloo_dev, parts=parts, sizes=sizes,
                        bert=P23_BERT.get(world, ()),
                        ncf=P23_NCF.get(world, ()),
                        moe=P23_MOE_LAYOUTS.get(world, ()),
                        moe_step=P23_MOE_STEP.get(world))
            for world in (2, 4)}
    try:
        groups, secs = launch_side_by_side(launch, p23_rank, jobs, gloo_dev,
                                           P23_TIMEOUT)
    finally:
        if dev == "cuda":
            runner.join()
    for world in groups:
        log(f"phase 23: the group of {world} ranks on {kind} over gloo: "
            f"{secs[world]:.1f} s (beside the other group)")
    rep["groups"] = {str(w): r for w, r in groups.items()}
    if dev == "cuda":
        if "error" in nccl:
            raise nccl["error"]
        rep["nccl"] = nccl["rec"]
        log(f"phase 23(a) the one-rank NCCL group on {kind}: "
            f"{rep['nccl']} ({nccl['seconds']:.1f} s, beside the gloo "
            "groups)")
        if not (rep["nccl"]["bitwise"] and rep["nccl"]["all_reduce"]
                and rep["nccl"]["backend"] == "nccl"):
            raise AssertionError(f"23(a) NCCL: {rep['nccl']}")
    rep["launches"] = p23_report(rep, groups, kind)
    rep["seconds"] = time.perf_counter() - t0
    log(f"phase 23: {rep['seconds']:.1f} s")
    return rep


def p23_report(rep, groups, kind):
    """Print each reading at its worst over the ranks (every rank's is in
    chiprun_out/phase23.json), hold every rank's to its limit, and sum the
    main paths' launches by kernel and part."""
    bad = []
    launches = {}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "phase23.json"), "w") as fh:
        json.dump({str(w): r for w, r in groups.items()}, fh, indent=1)

    def add(part, counts):
        dst = launches.setdefault(part, {})
        for k, v in counts.items():
            dst[k] = dst.get(k, 0) + v

    def worst(recs, key):
        return max(r[key] for r in recs)

    for world, ranks in groups.items():
        for part in "abcdef":
            for r in ranks:
                r.setdefault(part, {"seconds": 0.0})
        a = [r["a"] for r in ranks if "table" in r["a"]]
        if a:
            log(f"23(a) {world} ranks on {kind}: staging table "
                f"{a[0]['table']}; ms a call, each rank: " + "; ".join(
                    f"{op} " + " ".join(f"{x[op]['ms']:.2f}" for x in a)
                    for op in ("all_reduce", "all_gather", "reduce_scatter",
                               "all_to_all", "ring_shift"))
                + (f"; all_reduce bitwise a + b: "
                   f"{all(x['all_reduce']['bitwise'] for x in a)}"
                   if world == 2 else ""))
            if world == 2 and not all(x["all_reduce"]["bitwise"]
                                      for x in a):
                bad.append(f"{world}/a all_reduce not bitwise")
        for key in [k for k in ranks[0]["b"] if k != "seconds"]:
            recs = [r["b"][key] for r in ranks]
            lim = 1e-5 if key.endswith("fp32") else TRAIN_BF16_LOSS_ATOL
            per_step = [{k: v / P23_BERT_STEPS for k, v in
                         rec["launches"].items()} for rec in recs]
            flash = {tuple(s.get(n, 0) for n in (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")) for s in per_step}
            r0 = recs[0]
            log(f"23(b) BERT-Base {key}, {world} ranks on {kind}: loss err "
                f"{worst(recs, 'loss_err'):.3g} (limit {lim})"
                + (f", param err {worst(recs, 'param_err'):.3g} (limit "
                   f"{P23_PARAM_ATOL})" if "param_err" in r0 else "")
                + f"; a rank holds {r0['param_bytes'] / 2 ** 20:.1f} MiB of "
                f"{r0['whole_param_bytes'] / 2 ** 20:.1f} MiB parameters "
                f"(+{r0['opt_state_bytes'] / 2 ** 20:.1f} MiB optimizer "
                f"state), a sharded leaf whole "
                f"{any(r['sharded_leaf_whole'] for r in recs)}; B3, B4, B5 "
                f"a step {sorted(flash)} on {r0['heads_a_rank']} heads; ms a "
                f"step " + " ".join(f"{r['step_ms']:.1f}" for r in recs)
                + ", collectives' share " + " ".join(
                    f"{r['collective_share']:.3f}" for r in recs))
            if worst(recs, "loss_err") > lim or max(
                    r.get("param_err", 0) for r in recs) > P23_PARAM_ATOL \
                    or any(r["sharded_leaf_whole"] for r in recs) or \
                    flash != {(12, 12, 12)}:
                bad.append(f"{world}/b {key}")
            for rec in recs:
                add("bert", rec["launches"])
        for key in [k for k in ranks[0]["c"] if k != "seconds"]:
            recs = [r["c"][key] for r in ranks]
            errs = {n: max(r["param_errs"][n] for r in recs)
                    for n in recs[0]["param_errs"]}
            share = worst(recs, "past") / recs[0]["elements"]
            flips = [r["relu_flips"] for r in recs]
            steps = [f["step"] for f in flips if f["step"] is not None]
            first = min(steps) if steps else None
            # the witness: the first flips, on every rank that had them
            at_first = [f for f in flips if f["step"] == first]
            witness = first is not None and all(
                f["near"] <= P23_NCF_FLIP_NEAR for f in at_first)
            flipped = worst(recs, "past") > 0
            near = max((f["near"] for f in at_first), default=0.0)
            shown = [e for f in at_first for e in f["first"]][:4]
            log(f"23(c) NCF {key}, {world} ranks on {kind}: loss err "
                f"{worst(recs, 'loss_err'):.3g} (limit {P23_PARAM_ATOL}), "
                f"param err {worst(recs, 'param_err'):.3g} (limit "
                f"{P23_PARAM_ATOL if not flipped else P23_NCF_FLIP_ATOL}; "
                f"by leaf {errs}), past {P23_PARAM_ATOL}: "
                f"{worst(recs, 'past')} of {recs[0]['elements']} elements "
                f"(limit {P23_NCF_FLIP_SHARE} of them where a ReLU input "
                f"flipped); ReLU inputs on the other side of 0 from the "
                f"one-rank fit's, each rank: "
                f"{[f['count'] for f in flips]}, the first at step "
                f"{first}, within {near:.3g} of 0 (limit "
                f"{P23_NCF_FLIP_NEAR}; [layer, row, unit, one rank, "
                f"ranks]: {shown}); launches a rank "
                f"{recs[0]['launches']}; blocks {recs[0]['shards']}; "
                f"computed on as blocks {recs[0]['covered']}")
            if worst(recs, "loss_err") > P23_PARAM_ATOL or (
                    flipped and not witness) or \
                    worst(recs, "param_err") > P23_NCF_FLIP_ATOL or \
                    share > P23_NCF_FLIP_SHARE or not all(
                        r["launches"].get("fused_embedding_lookup") and
                        r["launches"].get("embedding_scatter_add")
                        for r in recs):
                bad.append(f"{world}/c {key}")
            for rec in recs:
                add("ncf", rec["launches"])
        for part, label in (("d", "ring"), ("e", "ulysses")):
            for key in [k for k in ranks[0][part] if k != "seconds"]:
                recs = [r[part][key] for r in ranks]
                readings = {n: [max(r["readings"][n][0] for r in recs),
                                max(r["readings"][n][1] for r in recs)]
                            for n in recs[0]["readings"]}
                f64 = {n: max(r["f64"][n] for r in recs)
                       for n in recs[0].get("f64", {})}
                # the ring's bf16 partials round on most elements: no
                # share limit there (the readings carry the share)
                within = all(v[0] <= 1.0 and (label == "ring" or v[1] <= (
                    FLASH_BF16_SHARE if n == "out" else BWD_BF16_SHARE))
                    for n, v in readings.items()) and all(
                    v <= 1.0 for v in f64.values())
                # one launch a forward for Ulysses; the flash ring's visit
                # its blocks: all of them, or causal those up to its own;
                # the plain ring's none
                want = [0 if key.endswith("_plain") else 1
                        if label == "ulysses" else (
                            i + 1 if key.endswith("causal") else world)
                        for i in range(world)]
                got = [r["fwd_launches"] for r in recs]
                log(f"23({part}) {label} {key}, {world} ranks on {kind}: "
                    f"worst readings over their limits {readings}"
                    + (f", against float64 {f64}" if f64 else "")
                    + f"; forward launches a rank {got} (expected {want});"
                    f" ms forward " + " ".join(f"{r['fwd_ms']:.1f}"
                                               for r in recs)
                    + ", backward " + " ".join(f"{r['bwd_ms']:.1f}"
                                               for r in recs))
                if not within or got != want:
                    bad.append(f"{world}/{part} {key}")
                for rec in recs:
                    add(label, rec["launches"])
        for key in [k for k in ranks[0]["f"] if k != "seconds"]:
            recs = [r["f"][key] for r in ranks]
            if key == "step":
                ok = worst(recs, "loss_err") <= P23_PARAM_ATOL and \
                    worst(recs, "param_err") <= P23_PARAM_ATOL
                log(f"23(f) MoE {recs[0]['layout']} step, {world} ranks on "
                    f"{kind}: loss err {worst(recs, 'loss_err'):.3g}, param "
                    f"err {worst(recs, 'param_err'):.3g} (limit "
                    f"{P23_PARAM_ATOL}); on blocks {recs[0]['covered']}; "
                    f"tokens a rank's experts took "
                    f"{[r['dispatched'] for r in recs]}")
            else:
                grads = {n: max(r["grads"][n] for r in recs)
                         for n in recs[0]["grads"]}
                ok = max(worst(recs, "out"), worst(recs, "aux"),
                         worst(recs, "dx"), *grads.values()) <= P23_MOE_RTOL
                log(f"23(f) MoE {key}, {world} ranks on {kind}: out "
                    f"{worst(recs, 'out'):.3g}, aux {worst(recs, 'aux'):.3g},"
                    f" dx {worst(recs, 'dx'):.3g}, gradients {grads} (limit "
                    f"{P23_MOE_RTOL} of each one's largest element); tokens a "
                    f"rank's experts took {[r['dispatched'] for r in recs]}")
            if not ok or not all(r["dispatched"] for r in recs):
                bad.append(f"{world}/f {key}")
        secs = {p: round(max(r[p]["seconds"] for r in ranks), 1)
                for p in "abcdef"}
        log(f"phase 23 group of {world}: seconds by part {secs}")
    log(f"phase 23 launches on its paths, summed over the ranks: {launches}")
    if bad:
        raise AssertionError(f"phase 23: {bad}")
    return launches


# ------------------------------- phase 24: pipelines and sharded serving
# Ranks share the one card over gloo, as in phase 23: a group of 4 runs
# (a) pipeline parallelism and the MLP served "tp4", a group of 2 runs
# (b) sharded serving, (c) sharded generate and (d) TCMF across ranks.
# Every reference is computed on the card by a rank of its own group, on
# one rank's worth of the model (no process group involved).
P24_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "phase24")
P24_TIMEOUT = 600
# (a) the pipelined MLP (hidden 1024 a stage, batch 256, 4 microbatches)
# under "pp4" (4 stages) and "dp2,pp2" (2 stages), and the LM at
# BERT-Base's block widths (d_model 768, 12 heads, d_ff 3072, seq 128,
# vocab 30 522, one block a stage) under "pp4", batch 32, 4 microbatches.
# fp32 with TF32 off; limits of phase 23: the loss within 1e-5, each
# leaf's gradient within 1e-5 of its largest element.
P24_MLP = dict(f_in=64, hidden=1024, out_dim=16, batch=256, micro=4)
P24_MLP_LAYOUTS = {"pp4": 4, "dp2,pp2": 2}
P24_LM = dict(vocab=30522, d_model=768, n_heads=12, d_ff=3072, seq_len=128,
              n_stages=4, n_microbatches=4, batch=32)
P24_STEPS = 1                # timed steps after the first, each layout
                             # (3 until phase 25 joined the run)
P24_LOSS_ATOL = 1e-5
P24_GRAD_RTOL = 1e-5
# (b) bench.py's measure_serving_sharded: 3 x Dense(256), in 16, out 8,
# the bottom rung a quarter of the top (64), 24 bottom rungs of records
P24_SERVE = dict(hidden=256, f_in=16, out=8, top=64)
P24_BERT_SIZE = {}           # BERT-Base (a rehearsal cuts it)
P24_NCF_ROWS = 8000
P24_NCF_ATOL = 1e-5
# (d) TCMF at phase 20's width from the SVD start, the series split over
# two ranks (X's gradient and the mse summed in two parts), against the
# one-rank fp32 fit from the same start. The limits are twice the
# distances the two fp32 routes read on the H100 (P24_TCMF_ROUTES: F, X
# as the largest difference, the final mse relative; PR 23's runs 1 and 2
# read the same bits: the fit is deterministic on one card, and the room
# is for another library's sum order). Each fault that
# dev/tcmf_rank_faults.py plants (X's terms once a rank, X's gradient
# unsummed, the mse over a rank's own count) fails at least one (PERF.md
# section 2). The float64 run's distances are printed beside.
P24_TCMF_STEPS = 300
P24_TCMF_ROUTES = (4.97e-3, 2.43e-3, 1.03e-7)
P24_TCMF_ROOM = 2.0


def p24_tcmf_limits():
    f, x, mse = (P24_TCMF_ROOM * c for c in P24_TCMF_ROUTES)
    return (f, x), mse


def phase_pipeline_serving(torch, np, kind, dev="cuda", sizes=None,
                           parts="abcd"):
    """Phase 24: pipeline parallelism (a), sharded serving (b), sharded
    generate (c) and TCMF across ranks (d), ranks sharing the card over
    gloo. ``sizes``: module constants to cut (a rehearsal), in every rank
    too. Returns the report; fails on any rank's failure or any reading
    past its limit."""
    import shutil
    from analytics_zoo_tpu_torch.parallel.launch import launch
    globals().update(sizes or {})
    t0 = time.perf_counter()
    gloo_dev = "cuda:0" if dev == "cuda" else "cpu"
    jobs = {}
    for world, mine in ((4, "ab"), (2, "bcd")):
        todo = "".join(p for p in mine if p in parts)
        if todo:
            jobs[world] = dict(device=gloo_dev, parts=todo, sizes=sizes)
    try:
        groups, secs = launch_side_by_side(launch, p24_rank, jobs, gloo_dev,
                                           P24_TIMEOUT)
        for world in groups:
            log(f"phase 24: the group of {world} ranks on {kind} over gloo:"
                f" {secs[world]:.1f} s (beside the other group)")
    finally:
        shutil.rmtree(P24_DIR, ignore_errors=True)
    rep = {"groups": {str(w): r for w, r in groups.items()}}
    rep["launches"] = p24_report(groups, kind)
    rep["seconds"] = time.perf_counter() - t0
    log(f"phase 24: {rep['seconds']:.1f} s")
    return rep


def p24_rank(cfg):
    """One rank of a phase 24 group: each of its parts, their launch
    counts its own."""
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.common.context import (OrcaContext,
                                                        init_orca_context,
                                                        stop_orca_context)
    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.ops import _build
    globals().update(cfg.get("sizes") or {})
    OrcaContext.default_matmul_precision = "float32"   # TF32 off
    init_orca_context(cluster_mode="multihost", device=cfg["device"])
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    estimator.DEFAULT_LOG_DIR = os.path.join(P24_DIR, f"tb{world}_{rank}")
    fns = {"a": p24_pipeline, "b": p24_serving, "c": p24_generate,
           "d": p24_tcmf}
    out = {}
    try:
        for part in cfg["parts"]:
            t0 = time.perf_counter()
            _build.reset_launch_counts()
            out[part] = fns[part](torch, np, cfg, world)
            out[part]["launches"] = {k: v for k, v in
                                     _build.launch_counts().items() if v}
            out[part]["seconds"] = time.perf_counter() - t0
    finally:
        stop_orca_context()
    return out


def p24_sync(torch, cfg):
    if cfg["device"].startswith("cuda"):
        torch.cuda.synchronize()


def p24_grad_reading(torch, est, grads, seq_grads, idx):
    """Each leaf's largest difference over its largest element: a stage
    leaf against the sequential gradient's row of this rank's stage."""
    out = {}
    for name, g in zip(est._names, grads):
        want = seq_grads[name.replace(".", "/")]
        if name in est._shards:
            want = want[idx:idx + 1]
        scale = max(float(want.abs().max()), 1e-30)
        out[name] = float((g - want).abs().max()) / scale
    return out


def p24_pipeline_case(torch, np, cfg, model, params, x, y, strategy):
    """One layout: one batch's loss and gradients through the estimator
    against ``apply_sequential`` on this rank, then ms a step and the
    ring shift's share over P24_STEPS steps."""
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.learn import losses
    from analytics_zoo_tpu_torch.parallel import collectives as C
    dev = torch.device(cfg["device"])
    loss = "sparse_categorical_crossentropy_logits"
    est = Estimator.from_fn(apply_fn=model.apply, params=params, loss=loss,
                            optimizer="adam", strategy=strategy,
                            param_rules=model.param_rules(), device=dev)
    mesh = est._mesh
    blocks = est._batch_shards
    di = mesh.data_index(est.strategy.batch_axes())
    per = len(x) // blocks
    xl, yl = x[di * per:(di + 1) * per], y[di * per:(di + 1) * per]
    got, grads = est._loss_and_grads(xl, yl)
    seq = {}

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                leaves(v, f"{prefix}{k}/")
            else:
                seq[prefix + k] = v.detach().to(dev).requires_grad_()
    leaves(params)
    nested = {}
    for k, v in seq.items():
        node = nested
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    out = model.apply_sequential(nested, torch.as_tensor(x, device=dev))
    want = losses.get(loss)(torch.as_tensor(y, device=dev), out).mean()
    gs = dict(zip(seq, torch.autograd.grad(want, list(seq.values()))))
    del out
    reading = p24_grad_reading(torch, est, grads, gs,
                               mesh.coord("pipe"))
    loss_err = abs(float(got) - float(want))
    del gs, grads, seq, nested
    # the steps: the first (untimed), then P24_STEPS timed
    est.fit((xl[:per], yl[:per]), epochs=1, batch_size=len(x),
            shuffle=False)
    C.reset_stats()
    p24_sync(torch, cfg)
    t0 = time.perf_counter()
    for _ in range(P24_STEPS):
        est.fit((xl[:per], yl[:per]), epochs=1, batch_size=len(x),
                shuffle=False)
    p24_sync(torch, cfg)
    secs = time.perf_counter() - t0
    stats = {k: list(v) for k, v in C.stats.items()}
    rec = dict(loss=float(got), loss_err=loss_err, grads=reading,
               step_ms=secs / P24_STEPS * 1e3,
               ring_share=C.stats.get("ring_shift", [0, 0.0])[1] / secs,
               collective_share=C.stats_seconds() / secs,
               collectives=stats,
               held={n: list(s.local_shape) for n, s in est._shards.items()},
               mesh=mesh.shape)
    del est
    if cfg["device"].startswith("cuda"):
        torch.cuda.empty_cache()
    return rec


def p24_pipeline(torch, np, cfg, world):
    """(a) the pipelined MLP under each layout, the LM at BERT-Base's
    block widths under "pp4"."""
    from analytics_zoo_tpu_torch.parallel import mesh as M
    from analytics_zoo_tpu_torch.parallel.pipeline import (
        PipelinedMLP, PipelinedTransformerLM)
    out = {}
    rng = np.random.RandomState(SEED + 240)
    c = P24_MLP
    x = rng.standard_normal((c["batch"], c["f_in"])).astype(np.float32)
    y = rng.randint(0, c["out_dim"], c["batch"]).astype(np.int32)
    for strategy, stages in P24_MLP_LAYOUTS.items():
        mesh = M.build_mesh(axes=(M.DATA_AXIS, M.PIPE_AXIS),
                            shape=[world // stages, stages])
        model = PipelinedMLP(hidden=c["hidden"], out_dim=c["out_dim"],
                             n_stages=stages, n_microbatches=c["micro"],
                             mesh=mesh)
        params = model.init(SEED + 241, x[:1])
        out[f"mlp/{strategy}"] = p24_pipeline_case(
            torch, np, cfg, model, params, x, y, strategy)
    lm = P24_LM
    mesh = M.build_mesh(axes=(M.DATA_AXIS, M.PIPE_AXIS),
                        shape=[1, lm["n_stages"]])
    model = PipelinedTransformerLM(
        **{k: v for k, v in lm.items() if k != "batch"}, mesh=mesh)
    params = model.init(SEED + 242, None)
    tokens = rng.randint(0, lm["vocab"], (lm["batch"], lm["seq_len"])) \
        .astype(np.int32)
    out["lm/pp4"] = p24_pipeline_case(torch, np, cfg, model, params,
                                      tokens, np.roll(tokens, -1, axis=1),
                                      "pp4")
    return out


def p24_healthz(port):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def p24_lead(im, body):
    """Rank 0 runs ``body()`` and unshards; the others follow. Each
    rank's record: rank 0's body's, the others' forwards served."""
    import torch
    if torch.distributed.get_rank() == 0:
        try:
            return body()
        finally:
            im.unshard()
    return {"served": im.follow()}


def p24_mlp_serving(torch, np, cfg, world):
    """bench.py's measure_serving_sharded under "tp<world>": its readings
    under bench.py's names."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)
    s = P24_SERVE
    m = Sequential()
    m.add(Dense(s["hidden"], input_shape=(s["f_in"],), activation="relu"))
    for _ in range(2):
        m.add(Dense(s["hidden"], activation="relu"))
    m.add(Dense(s["out"]))
    seeded_weights(m.module, SEED + 243)
    im = InferenceModel(device=cfg["device"]).load_zoo(m)
    # the input spec warm-up builds its batches from (bench.py's model
    # is loaded with a sample input)
    im.warm_up(rungs=(), sample_input=np.zeros((1, s["f_in"]), np.float32))
    im.shard(f"tp{world}", param_rules=[(r"kernel", (None, "model"))])

    def misses():
        fam = telemetry.snapshot().get("zoo_jit_cache_misses_total", {})
        return float(fam.get("fn=inference_model", 0.0)) \
            if isinstance(fam, dict) else 0.0

    def body():
        info = im.shard_info()
        frac = max(info["shard_hbm_bytes"].values()) / max(
            info["total_param_bytes"], 1)
        min_rung = max(2, s["top"] // 4)
        n = 24 * min_rung
        payloads = np.random.default_rng(21).standard_normal(
            (n, s["f_in"])).astype(np.float32)
        with Broker.launch(backend="python") as broker:
            eng = ClusterServing(im, broker.port, batch_size=min_rung,
                                 min_batch_size=min_rung,
                                 max_batch_size=s["top"], pipeline_window=2)
            start_rung = eng.batch_size
            in_q, out_q = InputQueue(port=broker.port), \
                OutputQueue(port=broker.port)
            eng.start()
            eng.wait_warm(timeout=240.0)
            base = misses()
            t0 = time.perf_counter()
            uris = in_q.enqueue_batch(
                (f"sh{i}", {"x": payloads[i]}) for i in range(n))
            res = out_q.query_many(uris, timeout=240.0)
            dt = time.perf_counter() - t0
            peak = eng.batch_size
            eng.stop()
        recompiles = int(misses() - base)
        missing = [u for u, v in res.items() if v is None]
        want = InferenceModel(device=cfg["device"]).load_zoo(m).predict(
            payloads)
        err = max(float(np.abs(np.asarray(res[f"sh{i}"]) - want[i]).max())
                  for i in range(n) if res.get(f"sh{i}") is not None)
        return {"serving_sharded_records_per_sec": n / dt,
                "serving_sharded_n_shards": int(info["n_shards"]),
                "serving_sharded_max_shard_fraction": frac,
                "serving_sharded_post_warmup_recompiles": recompiles,
                "serving_sharded_bucket_growth":
                    eng.ladder.rungs.index(peak)
                    - eng.ladder.rungs.index(start_rung),
                "missing": len(missing), "max_abs_err": err}
    return p24_lead(im, body)


def p24_serving(torch, np, cfg, world):
    """(b) on 4 ranks the MLP; on 2 BERT-Base "tp2" through ClusterServing
    and the FrontEnd (fp32) and its bf16 predict, NCF "tp2", the MLP, the
    /healthz sharding block; each rank's B3 and B1 launches."""
    from analytics_zoo_tpu_torch.ops import _build
    out = {"mlp": p24_mlp_serving(torch, np, cfg, world)}
    if world != 2:
        return out
    out["bert"] = p24_bert_serving(torch, np, cfg)
    out["ncf"] = p24_ncf_serving(torch, np, cfg)
    out["ncf"]["launches"] = {k: v for k, v in
                              _build.launch_counts().items() if v}
    return out


def p24_bert_serving(torch, np, cfg):
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 FrontEnd, InputQueue,
                                                 OutputQueue)
    from analytics_zoo_tpu_torch.text.bert import bert_tp_rules
    rank = torch.distributed.get_rank()
    x = bert_inputs(np.random.RandomState(SEED), BERT_BATCH)
    sample = tuple(a[:1] for a in x)
    out = {}
    for label, extra in (("fp32", {}), ("bf16", {"dtype": torch.bfloat16})):
        module = bert_classifier(None, use_flash=True, **P24_BERT_SIZE,
                                 **extra)
        want = None
        if rank == 0:
            want = InferenceModel(device=cfg["device"]).load_torch(
                module, sample).predict(x, batch_size=BERT_BATCH)
        im = InferenceModel(device=cfg["device"]).load_torch(module,
                                                             sample)
        del module
        im.shard("tp2", param_rules=bert_tp_rules())
        n_head = P24_BERT_SIZE.get("n_head", 12)
        head_dim = P24_BERT_SIZE.get("hidden_size", 768) // n_head
        heads = [int(p.shape[0]) // head_dim for n, p in
                 im._sharded.module.named_parameters()
                 if n.endswith("block_0.attention.query.weight")]
        _build.reset_launch_counts()
        limit = BERT_ATOL if label == "fp32" else BERT_BF16_ATOL

        def body(im=im, want=want, label=label, limit=limit):
            rec = {"limit": limit, "info": im.shard_info()}
            p24_sync(torch, cfg)
            t0 = time.perf_counter()
            got = im.predict(x, batch_size=BERT_BATCH)
            p24_sync(torch, cfg)
            rec["predict_ms"] = (time.perf_counter() - t0) * 1e3
            rec["predict_err"] = float(np.abs(got - want).max())
            if label != "fp32":
                return rec
            ids, seg = x
            with Broker.launch(backend="python") as broker:
                eng = ClusterServing(im, broker.port, batch_size=BERT_BATCH,
                                     max_batch_size=BERT_BATCH,
                                     warmup=False)
                eng.start()
                fe = FrontEnd(broker.port, engine=eng).start()
                try:
                    iq, oq = InputQueue(port=broker.port), \
                        OutputQueue(port=broker.port)
                    t0 = time.perf_counter()
                    uris = iq.enqueue_batch(
                        (f"b{i}", {"input_ids": ids[i],
                                   "token_type_ids": seg[i]})
                        for i in range(BERT_BATCH))
                    res = oq.query_many(uris, timeout=300)
                    rec["served_s"] = time.perf_counter() - t0
                    hz = p24_healthz(fe.port)
                    rec["metrics_sharding"] = eng.metrics().get("sharding")
                finally:
                    fe.stop()
                    eng.stop()
            rec["served_err"] = max(
                float(np.abs(np.asarray(res[f"b{i}"]) - want[i]).max())
                if res.get(f"b{i}") is not None else float("inf")
                for i in range(BERT_BATCH))
            rec["healthz_sharding"] = hz.get("sharding")
            return rec
        rec = p24_lead(im, body)
        rec["heads_a_rank"] = heads[0] if heads else None
        rec["heads"] = n_head
        rec["forward_launches"] = {k: v for k, v in
                                   _build.launch_counts().items() if v}
        out[label] = rec
        del im
        if cfg["device"].startswith("cuda"):
            torch.cuda.empty_cache()
    return out


def p24_ncf_serving(torch, np, cfg):
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    ncf = NeuralCF(**NCF)
    seeded_weights(ncf.model.module, SEED + 244)
    x, _ = p23_ncf_data(np)
    x = x[:P24_NCF_ROWS]
    want = None
    if torch.distributed.get_rank() == 0:
        want = InferenceModel(device=cfg["device"]).load_zoo(ncf).predict(
            x, batch_size=len(x))
    # the sharded path's launches alone
    _build.reset_launch_counts()
    im = InferenceModel(device=cfg["device"]).load_zoo(ncf)
    im.shard("tp2", param_rules=NeuralCF.tp_param_rules())
    tables = {n: list(p.shape) for n, p in
              im._sharded.module.named_parameters()
              if n.endswith("embedding")}

    def body():
        got = im.predict(x, batch_size=len(x))
        return {"err": float(np.abs(got - want).max()),
                "covered": sorted(set(im._sharded.shards)
                                  - set(im._sharded.gathered))}
    rec = p24_lead(im, body)
    rec["tables"] = tables
    return rec


def p24_generate(torch, np, cfg, world):
    """(c) the decode Seq2Seq "tp2": greedy bitwise and raw within 1e-5 of
    the one-rank generate."""
    from analytics_zoo_tpu_torch.common.compile_ahead import BucketLadder
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import Seq2Seq
    b, steps = DECODE_BATCH, DECODE_STEPS
    m = Seq2Seq(**DECODE)
    seeded_weights(m.model.module, SEED)
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((b, 8, DECODE["input_dim"])).astype(np.float32)
    start = np.zeros((b, DECODE["output_dim"]), np.float32)
    ref = None
    if torch.distributed.get_rank() == 0:
        one = InferenceModel(device=cfg["device"]).load_zoo(m)
        one.set_ladder(BucketLadder(b, b))
        ref = (one.generate(enc, start, steps),
               one.generate(enc, start, steps, mode="raw"))
    im = InferenceModel(device=cfg["device"]).load_zoo(m)
    im.set_ladder(BucketLadder(b, b))
    im.shard("tp2")

    def body():
        p24_sync(torch, cfg)
        t0 = time.perf_counter()
        greedy = im.generate(enc, start, steps)
        p24_sync(torch, cfg)
        ms = (time.perf_counter() - t0) * 1e3
        raw = im.generate(enc, start, steps, mode="raw")
        return {"greedy_bitwise": bool(np.array_equal(greedy, ref[0])),
                "raw_err": float(np.abs(raw - ref[1]).max()),
                "greedy_ms": ms, "steps": steps}
    return p24_lead(im, body)


def p24_tcmf(torch, np, cfg, world):
    """(d) TCMF at the electricity panel's width over the ranks, from the
    SVD start, against the one-rank fp32 fit and the same steps in float64
    (rank 0, no group); ms a step."""
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster
    n, t = P20_TCMF
    y = p20_panel(np, t)[:, :t]
    dev = cfg["device"]
    m = TCMFForecaster(rank=P20_TCMF_RANK, svd=True, device=dev)
    f0, x0 = m._init_factors(y)
    m._init_factors = lambda _y: (f0.copy(), x0.copy())
    p24_sync(torch, cfg)
    t0 = time.perf_counter()
    mse = m.fit(y, num_steps=P24_TCMF_STEPS, distributed=True)
    p24_sync(torch, cfg)
    secs = time.perf_counter() - t0
    rec = dict(mse=mse, step_ms=secs / P24_TCMF_STEPS * 1e3,
               devices_used=m.fit_report["devices_used"])
    if torch.distributed.get_rank() == 0:
        one = TCMFForecaster(rank=P20_TCMF_RANK, device=dev)
        one._init_factors = lambda _y: (f0.copy(), x0.copy())
        p24_sync(torch, cfg)
        t0 = time.perf_counter()
        mse1 = one._run_factorization(y, P24_TCMF_STEPS, None)
        p24_sync(torch, cfg)
        rec.update(one_rank_step_ms=(time.perf_counter() - t0)
                   / P24_TCMF_STEPS * 1e3, mse_one=mse1,
                   f_err=float(np.abs(m.F - one.F).max()),
                   x_err=float(np.abs(m.X - one.X).max()),
                   mse_rel=abs(mse - mse1) / abs(mse1))
        ref = TCMFForecaster(rank=P20_TCMF_RANK, device=dev)
        ref._init_factors = lambda _y: (f0.astype(np.float64),
                                        x0.astype(np.float64))
        mse64 = ref._run_factorization(y.astype(np.float64),
                                       P24_TCMF_STEPS, None)
        rec.update(mse64=mse64, f64_err=float(np.abs(m.F - ref.F).max()),
                   x64_err=float(np.abs(m.X - ref.X).max()),
                   mse64_rel=abs(mse - mse64) / abs(mse64))
    return rec


def p24_report(groups, kind):
    """Print each reading (every rank's is in chiprun_out/phase24.json),
    hold it to its limit, and sum the paths' launches by part."""
    bad = []
    launches = {}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "phase24.json"), "w") as fh:
        json.dump({str(w): r for w, r in groups.items()}, fh, indent=1)

    def add(path, counts):
        dst = launches.setdefault(path, {})
        for k, v in counts.items():
            dst[k] = dst.get(k, 0) + v

    for world, ranks in groups.items():
        if "a" in ranks[0]:
            for key in [k for k in ranks[0]["a"]
                        if k not in ("seconds", "launches")]:
                recs = [r["a"][key] for r in ranks]
                loss_err = max(r["loss_err"] for r in recs)
                grads = {}
                for r in recs:
                    for n, v in r["grads"].items():
                        grads[n] = max(grads.get(n, 0.0), v)
                log(f"24(a) {key}, {world} ranks on {kind}: loss "
                    f"{recs[0]['loss']:.6g}, err {loss_err:.3g} (limit "
                    f"{P24_LOSS_ATOL}); gradients over each leaf's largest "
                    f"{ {n: float(f'{v:.3g}') for n, v in grads.items()} } "
                    f"(limit {P24_GRAD_RTOL}); a rank holds "
                    f"{recs[-1]['held']}; ms a step " + " ".join(
                        f"{r['step_ms']:.1f}" for r in recs)
                    + ", the ring shift's share " + " ".join(
                        f"{r['ring_share']:.3f}" for r in recs)
                    + ", all collectives' " + " ".join(
                        f"{r['collective_share']:.3f}" for r in recs)
                    + " (rehearsal costs: gloo on one card)")
                if loss_err > P24_LOSS_ATOL or \
                        max(grads.values()) > P24_GRAD_RTOL:
                    bad.append(f"{world}/a {key}")
        b = ranks[0].get("b")
        if b is None:
            continue
        mlp = b["mlp"]
        log(f"24(b) measure_serving_sharded's MLP under tp{world} on {kind}:"
            f" " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                             else f"{k} {v}" for k, v in mlp.items()
                             if k != "launches"))
        if mlp["missing"] or mlp["serving_sharded_max_shard_fraction"] >= 1 \
                or mlp["serving_sharded_post_warmup_recompiles"] != 0 \
                or mlp["serving_sharded_bucket_growth"] < 1 \
                or mlp["serving_sharded_n_shards"] != world \
                or mlp["max_abs_err"] > 1e-5:
            bad.append(f"{world}/b mlp")
        if world != 2:
            continue
        for label in ("fp32", "bf16"):
            rec = b["bert"][label]
            per_fwd = [r["b"]["bert"][label]["forward_launches"].get(
                "flash_attention_fwd", 0) for r in ranks]
            served = [r["b"]["bert"][label].get("served", 0) for r in ranks]
            log(f"24(b) BERT-Base {label} tp2 on {kind}: predict err "
                f"{rec['predict_err']:.3g}"
                + (f", served err {rec['served_err']:.3g}"
                   if label == "fp32" else "")
                + f" (limit {rec['limit']}); {rec['heads_a_rank']} heads a "
                f"rank; B3 launches each rank {per_fwd} over {served[1]} "
                f"forwards; predict "
                f"{rec['predict_ms']:.1f} ms; shard bytes "
                f"{rec['info']['shard_hbm_bytes']} of "
                f"{rec['info']['total_param_bytes']}")
            forwards = served[1]
            ok = rec["predict_err"] <= rec["limit"] and \
                2 * ranks[1]["b"]["bert"][label]["heads_a_rank"] == \
                ranks[1]["b"]["bert"][label]["heads"] and \
                all(c == 12 * forwards for c in per_fwd)
            if label == "fp32":
                ok = ok and rec["served_err"] <= rec["limit"] and \
                    (rec["healthz_sharding"] or {}).get("n_shards") == 2 \
                    and (rec["metrics_sharding"] or {}).get("n_shards") == 2
                log(f"24(b) /healthz sharding block: "
                    f"{rec['healthz_sharding']}; {BERT_BATCH} records "
                    f"served in {rec['served_s']:.2f} s")
            if not ok:
                bad.append(f"2/b bert {label}")
            for r in ranks:
                add("bert", r["b"]["bert"][label]["forward_launches"])
        ncf = b["ncf"]
        lk = [r["b"]["ncf"]["launches"].get("fused_embedding_lookup", 0)
              for r in ranks]
        log(f"24(b) NCF tp2 on {kind}: err {ncf['err']:.3g} (limit "
            f"{P24_NCF_ATOL}); B1 launches each rank {lk}; tables a rank "
            f"{ranks[1]['b']['ncf']['tables']}")
        if ncf["err"] > P24_NCF_ATOL or not all(lk) or len(set(lk)) != 1:
            bad.append("2/b ncf")
        for r in ranks:
            add("ncf", r["b"]["ncf"]["launches"])
        c = ranks[0]["c"]
        log(f"24(c) Seq2Seq tp2 generate on {kind}: greedy bitwise "
            f"{c['greedy_bitwise']}, raw err {c['raw_err']:.3g} (limit "
            f"1e-5); {c['greedy_ms']:.1f} ms for {c['steps']} greedy steps;"
            f" forwards the follower served {ranks[1]['c']['served']}")
        if not c["greedy_bitwise"] or c["raw_err"] > 1e-5:
            bad.append("2/c")
        d = ranks[0]["d"]
        (lf, lx), lm = p24_tcmf_limits()
        log(f"24(d) TCMF {P20_TCMF[0]} x {P20_TCMF[1]} rank {P20_TCMF_RANK} "
            f"over {d['devices_used']} ranks on {kind}, against the one-rank "
            f"fit: F {d['f_err']:.3g} (limit {lf:.3g}), X {d['x_err']:.3g} "
            f"(limit {lx:.3g}), mse {d['mse']:.6g} vs {d['mse_one']:.6g} "
            f"({d['mse_rel']:.3g} relative, limit {lm:.3g}); against "
            f"float64: F {d['f64_err']:.3g}, X {d['x64_err']:.3g}, mse "
            f"{d['mse64_rel']:.3g} relative; ms a step "
            + " ".join(f"{r['d']['step_ms']:.3f}" for r in ranks)
            + f" (one rank {d['one_rank_step_ms']:.3f})")
        if d["f_err"] > lf or d["x_err"] > lx or d["mse_rel"] > lm or \
                d["devices_used"] != 2:
            bad.append("2/d")
        secs = {p: round(max(r[p]["seconds"] for r in ranks), 1)
                for p in ranks[0] if isinstance(ranks[0][p], dict)}
        log(f"phase 24 group of {world}: seconds by part {secs}")
    for world, ranks in groups.items():
        for r in ranks:
            if "a" in r:
                add("pipeline", r["a"]["launches"])
    log(f"phase 24 launches on its paths, summed over the ranks: {launches}")
    if bad:
        raise AssertionError(f"phase 24: {bad}")
    return launches


P25_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "phase25")
# (a), (b): 80 000 ratings in MovieLens-1M's id ranges, 8 TFRecord files,
# bench.py's measure_ncf configuration (batch 8000, Adam(1e-3)), one
# epoch of 10 steps, shuffle off; the stub's scroll pages of 1000
P25_RATINGS = 80_000
P25_FILES = 8
P25_ES_BATCH = 1000
# (c): MNIST-shaped images, a LeNet-5-sized keras model at batch 128
P25_IMAGES = 8192
P25_PNGS = 256
P25_IMAGE_BATCH = 128
# (d): keras2 Conv1D / Dense with a CustomLoss of mean absolute error
# against loss="mae", 10 steps of 256; the two losses differ only in the
# order of one mean's sum (a few fp32 ulps of losses of order 1)
P25_K2 = dict(rows=2560, seq=16, feat=8, batch=256)
P25_K2_ATOL = 1e-6
# (e): NNClassifier over 16 384 rows of 64-wide features, 10 classes
P25_NN = dict(rows=16384, width=64, classes=10, batch=256, epochs=2)
# (f): an MLP GAN at MNIST width, batch 64, 20 steps of each loss; step 0
# against the same step in plain autograd with optax's Adam written out
# (p25_plain_adam; on the CPU the two read the same bits)
P25_GAN = dict(noise=100, g=(256, 512), d=(512, 256), out=784, batch=64,
               steps=20)
P25_GAN_ATOL = 1e-5
# (g): a BERT-Base-wide nn.TransformerEncoder (12 layers of d 768, 12
# heads, FFN 3072, gelu, batch_first) at 32 x 512 fp32, TF32 off, held
# against the same module run by torch itself through its own
# nn.MultiheadAttention, and against that run in float64 on the card.
# The flash kernel is held to its plain version within FLASH_ATOL (1e-5,
# phase 3) at this attention shape; dev/estimate_torchnet_limits.py
# (CPU, 12 layers at d 768, 2 x 128, seeds 0-2) puts an error of that
# size, with a random sign, in every element of every layer's attention
# output and reads how far the encoder's output moves: 6.44e-5 to
# 7.43e-5 (a gain of at most 7.43 over FLASH_ATOL; fp32 alone reads
# 1.5e-6 from float64 on the CPU). The limit is twice the gain's
# reading, rounded up. Torch's own eval forward takes its fused fast
# path (torch._transformer_encoder_layer_fwd), whose gelu read 1.05e-3
# from float64 on an NVIDIA H100 80GB HBM3 at 700.00 W, where its unfused
# path read 4.7e-6 (relu: both 4.0e-6): the fused run's distances are
# printed beside, not held.
P25_ENCODER = dict(d_model=768, nhead=12, dim_ff=3072, layers=12, batch=32,
                   seq=512)
P25_ENCODER_GAIN = 7.5
P25_ENCODER_ATOL = 2 * P25_ENCODER_GAIN * FLASH_ATOL
# (h): ResNet-50's torch twin, seeded, eval, 32 x 3 x 224 x 224, fp32 with
# TF32 off. The ONNX and IR interpreters call cuDNN and cuBLAS as the
# module does but may take other algorithms, so each output is held to
# the module's relative to the largest logit: within twice P25_IMPORT_F64
# (each fp32 route within P25_IMPORT_F64 of the float64 module, which the
# card also checks). dev/estimate_torchnet_limits.py --resnet (CPU, 224
# px, 2 images, seeds 0-1): the fp32 module 2.11e-7 to 2.45e-7 of the
# largest logit from float64; P25_IMPORT_F64 leaves 20x that for cuDNN's
# algorithms.
P25_RESNET_BATCH = 32
P25_IMPORT_F64 = 5e-6
P25_IMPORT_RTOL = 2 * P25_IMPORT_F64


def p25_ratings(np):
    """(users, items, labels): the ratings of (a) and (b), seeded."""
    rng = np.random.default_rng(SEED + 25)
    u = rng.integers(1, NCF["user_count"] + 1, P25_RATINGS)
    i = rng.integers(1, NCF["item_count"] + 1, P25_RATINGS)
    y = rng.integers(0, NCF["class_num"], P25_RATINGS)
    return u, i, y


def p25_ncf_fit(torch, np, x, y, dev):
    """bench.py's measure_ncf fit, one epoch without shuffling, from the
    seeded weights; (per-step losses, host ms a step, each step's kernel
    launches: the optimizer steps' alone, not the step profiler's counting
    pass)."""
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    ncf = NeuralCF(**NCF)
    seeded_weights(ncf.model.module, SEED)
    ncf.compile(optimizer=Adam(1e-3), loss="sparse_categorical_crossentropy",
                device=dev)
    est = ncf.model._ensure_estimator(for_training=True)
    step, per_step = est._train_step, []

    def counted_step(bx, by):
        before = _build.launch_counts()
        out = step(bx, by)
        per_step.append({n: c - before.get(n, 0) for n, c in
                         _build.launch_counts().items()
                         if c - before.get(n, 0)})
        return out
    est._train_step = counted_step
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ncf.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = np.asarray(est.step_losses)
    return losses, secs / len(losses) * 1e3, per_step


def p25_tfrecord(torch, np, kind, dev, rep):
    """25(a): ratings written with write_tfrecords into P25_FILES files,
    read back through read_tfrecords_as_shards, NCF fit from them and from
    the arrays: every step's loss bitwise; B1 2 and B1b 4 launches a
    step."""
    from analytics_zoo_tpu_torch.data import tfrecord
    from analytics_zoo_tpu_torch.ops import _build
    u, i, y = p25_ratings(np)
    recs = [{"pair": np.asarray([a, b], np.int64),
             "label": np.asarray([c], np.int64)} for a, b, c in zip(u, i, y)]
    out = os.path.join(P25_DIR, "tfrecord")
    per = P25_RATINGS // P25_FILES
    t0 = time.perf_counter()
    for f in range(P25_FILES):
        tfrecord.write_tfrecords(os.path.join(out, f"part-{f:05d}.tfrecord"),
                                 recs[f * per:(f + 1) * per])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = tfrecord.read_tfrecords_as_shards(out, num_shards=P25_FILES)
    back = [r for s in shards.collect() for r in s]
    read_s = time.perf_counter() - t0
    x = np.stack([r["pair"] for r in back]).astype(np.float32)
    lab = np.asarray([r["label"][0] for r in back], np.int32)
    _build.reset_launch_counts()
    losses, step_ms, per_step = p25_ncf_fit(torch, np, x, lab, dev)
    counts = {}
    for c in per_step:
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    want, want_ms, _ = p25_ncf_fit(
        torch, np, np.stack([u, i], 1).astype(np.float32),
        y.astype(np.int32), dev)
    steps = len(losses)
    a = dict(records=len(back), write_records_per_s=P25_RATINGS / write_s,
             parse_records_per_s=P25_RATINGS / read_s, write_s=write_s,
             read_s=read_s, steps=steps, step_ms=step_ms,
             arrays_step_ms=want_ms, losses=losses.tolist(),
             bitwise=bool(np.array_equal(losses, want)), launches=counts,
             launches_per_step=per_step,
             bytes=sum(os.path.getsize(os.path.join(out, f))
                       for f in os.listdir(out)))
    rep["a"] = a
    log(f"25(a) TFRecord -> NCF on {kind}: {P25_RATINGS} ratings written to "
        f"{P25_FILES} files ({a['bytes']} bytes) at "
        f"{a['write_records_per_s']:.1f} records/s, parsed at "
        f"{a['parse_records_per_s']:.1f} records/s (pure-Python CRC32C and "
        f"protobuf); NCF fit {steps} steps of {BATCH}: {step_ms:.3f} ms a "
        f"step (the arrays' fit {want_ms:.3f}); every loss bitwise the "
        f"arrays' fit: {a['bitwise']}; launches over its {len(per_step)} "
        f"optimizer steps {counts}")
    if len(back) != P25_RATINGS or not a["bitwise"] or \
            not np.isfinite(losses).all() or steps != P25_RATINGS // BATCH \
            or len(per_step) != steps:
        raise AssertionError(f"25(a) {a}")
    return x, lab


class P25EsStub:
    """An in-process stub of Elasticsearch's REST API on 127.0.0.1 (the
    routes of the JAX package's tests/test_elastic_search.py: _bulk, a
    _search that opens a scroll, _search/scroll, its DELETE)."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer
        stub = self
        self.store, self.scrolls, self.deleted, self.bulk_calls = {}, {}, \
            [], 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, payload):
                body = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n).decode()

            def do_DELETE(self):
                stub.deleted.append(json.loads(self._body())["scroll_id"])
                self._json({"succeeded": True})

            def do_POST(self):
                raw = self._body()
                if self.path.endswith("/_bulk"):
                    stub.bulk_calls += 1
                    docs = stub.store.setdefault(self.path.split("/")[1], [])
                    lines = [ln for ln in raw.splitlines() if ln.strip()]
                    items = []
                    for k in range(0, len(lines), 2):
                        action = json.loads(lines[k])["index"]
                        _id = action.get("_id", str(len(docs)))
                        docs.append({"_id": _id,
                                     "_source": json.loads(lines[k + 1])})
                        items.append({"index": {"_id": _id, "status": 201}})
                    self._json({"errors": False, "items": items})
                elif "/_search/scroll" in self.path:
                    sid = json.loads(raw)["scroll_id"]
                    index, cursor, size = stub.scrolls[sid]
                    page = stub.store.get(index, [])[cursor:cursor + size]
                    stub.scrolls[sid] = (index, cursor + size, size)
                    self._json({"_scroll_id": sid, "hits": {"hits": page}})
                else:
                    index = self.path.split("/")[1]
                    size = int(json.loads(raw or "{}").get("size", 10))
                    sid = f"scroll-{index}-{len(stub.scrolls)}"
                    stub.scrolls[sid] = (index, size, size)
                    self._json({"_scroll_id": sid, "hits": {
                        "hits": stub.store.get(index, [])[:size]}})

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="p25-es", daemon=True)
        self.thread.start()
        self.config = {"host": "127.0.0.1",
                       "port": self.server.server_address[1]}

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def p25_elastic(torch, np, kind, dev, rep):
    """25(b): the ratings through the stub (write_df, then read_df by
    scroll): frames and dtypes equal; NCF predict on the read rows bitwise
    predict on the originals, B1 2 launches a predict."""
    import pandas as pd
    from analytics_zoo_tpu_torch.data.elastic_search import EsTable
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    u, i, y = p25_ratings(np)
    df = pd.DataFrame({"user": u, "item": i, "label": y})
    stub = P25EsStub()
    try:
        t0 = time.perf_counter()
        n = EsTable.write_df(stub.config, "ratings", df)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = EsTable.read_df(stub.config, "ratings",
                              batch_size=P25_ES_BATCH).to_pandas()
        read_s = time.perf_counter() - t0
        released = list(stub.deleted)
        bulk_calls = stub.bulk_calls
    finally:
        stub.close()
    got = got.drop(columns="_id").reset_index(drop=True)
    same = list(got.columns) == list(df.columns) and all(
        got[c].dtype == df[c].dtype and np.array_equal(got[c], df[c])
        for c in df.columns)
    ncf = NeuralCF(**NCF)
    seeded_weights(ncf.model.module, SEED)
    im = InferenceModel(device=dev).load_zoo(ncf)
    x_read = got[["user", "item"]].to_numpy().astype(np.float32)
    x_orig = df[["user", "item"]].to_numpy().astype(np.float32)
    want = im.predict(x_orig, batch_size=len(x_orig))
    _build.reset_launch_counts()
    pred = im.predict(x_read, batch_size=len(x_read))
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    b = dict(rows=len(got), written=n, write_s=write_s, read_s=read_s,
             write_rows_per_s=n / write_s, read_rows_per_s=len(got) / read_s,
             bulk_calls=bulk_calls, scrolls_released=len(released),
             frames_equal=bool(same),
             predict_bitwise=bool(np.array_equal(pred, want)),
             launches=counts)
    rep["b"] = b
    log(f"25(b) Elasticsearch stub on 127.0.0.1 ({kind}): write_df of "
        f"{n} rows in {bulk_calls} bulk requests at "
        f"{b['write_rows_per_s']:.1f} rows/s; read_df by scroll of "
        f"{P25_ES_BATCH} at {b['read_rows_per_s']:.1f} rows/s, the scroll "
        f"released ({len(released)}); frames and dtypes equal: {same}; NCF "
        f"predict of the {len(got)} read rows bitwise the originals': "
        f"{b['predict_bitwise']}; launches {counts}")
    if not (same and b["predict_bitwise"] and n == P25_RATINGS
            and len(released) == 1):
        raise AssertionError(f"25(b) {b}")


def p25_lenet():
    """A LeNet-5-sized keras model over uint8 28 x 28 images (scaled in an
    autograd Lambda)."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import autograd as A
    from analytics_zoo_tpu_torch.keras import layers as kl
    inp = Input(shape=(28, 28))
    h = A.Lambda(lambda a: a.float().unsqueeze(-1) / 255.0,
                 out_shape=(28, 28, 1))(inp)
    h = kl.Conv2D(6, 5, 5, activation="tanh", border_mode="same",
                  name="lenet_c1")(h)
    h = kl.MaxPooling2D()(h)
    h = kl.Conv2D(16, 5, 5, activation="tanh", name="lenet_c2")(h)
    h = kl.Flatten()(kl.MaxPooling2D()(h))
    h = kl.Dense(120, activation="tanh", name="lenet_f1")(h)
    h = kl.Dense(84, activation="tanh", name="lenet_f2")(h)
    out = kl.Dense(10, activation="softmax", name="lenet_out")(h)
    m = Model(inp, out)
    seeded_weights(m.module, SEED + 38)
    return m


def p25_parquet(torch, np, kind, dev, rep):
    """25(c): write_ndarrays of MNIST-shaped images and write_from_directory
    over seeded PNGs, both read back bitwise; read_as_dataset feeds one
    epoch of a LeNet-5-sized keras model. Returns the PNG directory."""
    from PIL import Image
    from analytics_zoo_tpu_torch.data.image import (ParquetDataset,
                                                    write_from_directory,
                                                    write_ndarrays)
    rng = np.random.default_rng(SEED + 26)
    images = rng.integers(0, 256, (P25_IMAGES, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, P25_IMAGES).astype(np.int64)
    nd = os.path.join(P25_DIR, "ndarrays")
    t0 = time.perf_counter()
    write_ndarrays(images, labels, nd, block_size=1024)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = ParquetDataset.read_as_xshards(nd).collect()
    read_s = time.perf_counter() - t0
    nd_same = np.array_equal(np.concatenate([s["image"] for s in shards]),
                             images) and np.array_equal(
        np.concatenate([s["label"] for s in shards]), labels)
    png_dir = os.path.join(P25_DIR, "pngs")
    pngs = {}
    for k in range(P25_PNGS):
        cls = ("cat", "dog")[k % 2]
        os.makedirs(os.path.join(png_dir, cls), exist_ok=True)
        arr = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        path = os.path.join(png_dir, cls, f"{k:04d}.png")
        Image.fromarray(arr).save(path)
        pngs[path] = (arr, k % 2)
    pq = os.path.join(P25_DIR, "png_parquet")
    write_from_directory(png_dir, {"cat": 0, "dog": 1}, pq, block_size=64)
    t0 = time.perf_counter()
    back = ParquetDataset.read_as_xshards(pq).collect()
    png_read_s = time.perf_counter() - t0
    got_imgs = np.concatenate([s["image"] for s in back])
    got_labels = np.concatenate([s["label"] for s in back])
    want = sorted((a.tobytes(), lab) for a, lab in pngs.values())
    png_same = len(got_imgs) == P25_PNGS and sorted(
        (a.tobytes(), int(lab)) for a, lab in zip(got_imgs, got_labels)) \
        == want
    ds = ParquetDataset.read_as_dataset(nd, "image", "label")
    m = p25_lenet()
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = m.estimator.fit(ds, epochs=1, batch_size=P25_IMAGE_BATCH)
    if dev == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = P25_IMAGES // P25_IMAGE_BATCH
    c = dict(write_rows_per_s=P25_IMAGES / write_s,
             read_rows_per_s=P25_IMAGES / read_s,
             png_read_rows_per_s=P25_PNGS / png_read_s,
             ndarrays_bitwise=bool(nd_same), pngs_bitwise=bool(png_same),
             fit_steps=steps, fit_ms_per_step=fit_s / steps * 1e3,
             epoch_loss=float(hist["loss"][0]))
    rep["c"] = c
    log(f"25(c) image parquet on {kind}: {P25_IMAGES} 28x28 uint8 images "
        f"written at {c['write_rows_per_s']:.1f} rows/s, read at "
        f"{c['read_rows_per_s']:.1f} rows/s, bitwise {nd_same}; "
        f"{P25_PNGS} PNGs through write_from_directory read (decoded) at "
        f"{c['png_read_rows_per_s']:.1f} rows/s, bitwise {png_same}; "
        f"LeNet-5 one epoch from read_as_dataset, {steps} steps of "
        f"{P25_IMAGE_BATCH}: {c['fit_ms_per_step']:.3f} ms a step, loss "
        f"{c['epoch_loss']:.4f}")
    if not (nd_same and png_same and np.isfinite(c["epoch_loss"])):
        raise AssertionError(f"25(c) {c}")
    return png_dir


def p25_keras2_model(k2, A, seed_module):
    """keras2 Conv1D -> Lambda -> Node sugar -> Flatten -> Dense."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    inp = Input(shape=(P25_K2["seq"], P25_K2["feat"]))
    h = k2.Conv1D(16, 3, padding="same", activation="relu",
                  name="k2_conv")(inp)
    h = A.Lambda(lambda a: a * 0.5)(h) + 0.1
    h = k2.Flatten()(h)
    h = k2.Dense(32, activation="tanh", name="k2_hidden")(h)
    out = k2.Dense(1, name="k2_out")(1.0 - (-h) * 0.5)
    m = Model(inp, out)
    seeded_weights(m.module, seed_module)
    return m


def p25_autograd_keras2(torch, np, kind, dev, rep):
    """25(d): a keras2 model with a Lambda and the Node sugar, compiled
    with a CustomLoss of mean absolute error and with loss="mae" from the
    same weights: each of 10 steps' losses within P25_K2_ATOL."""
    from analytics_zoo_tpu_torch.keras import autograd as A
    from analytics_zoo_tpu_torch.keras2 import layers as k2
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    rng = np.random.default_rng(SEED + 27)
    x = rng.standard_normal((P25_K2["rows"], P25_K2["seq"], P25_K2["feat"]),
                            dtype=np.float32)
    y = x.mean((1, 2))[:, None].astype(np.float32)
    losses = {}
    for name, loss in (
            ("custom", A.CustomLoss(lambda yt, yp: A.mean(A.abs(yt - yp),
                                                          axis=1), (1,))),
            ("mae", "mae")):
        m = p25_keras2_model(k2, A, SEED + 28)
        m.compile(optimizer=Adam(1e-3), loss=loss, device=dev)
        m.fit(x, y, batch_size=P25_K2["batch"], nb_epoch=1, shuffle=False)
        losses[name] = np.asarray(m.estimator.step_losses)
    err = float(np.abs(losses["custom"] - losses["mae"]).max())
    d = dict(steps=len(losses["mae"]), max_abs_err=err,
             losses=losses["custom"].tolist())
    rep["d"] = d
    log(f"25(d) keras2 Conv1D/Dense with a Lambda and Node sugar on {kind}: "
        f"CustomLoss (autograd MAE) against loss='mae', {d['steps']} steps "
        f"of {P25_K2['batch']}: max |loss diff| {err:.3g} (limit "
        f"{P25_K2_ATOL})")
    if d["steps"] != P25_K2["rows"] // P25_K2["batch"] or err > P25_K2_ATOL \
            or not np.isfinite(losses["custom"]).all():
        raise AssertionError(f"25(d) {d}")


def p25_nnframes(torch, np, kind, dev, rep, png_dir):
    """25(e): NNClassifier over a DataFrame of 64-wide feature arrays, fit
    then transform: the prediction column is the argmax of predict;
    NNImageReader over (c)'s PNGs."""
    import pandas as pd
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as kl
    from analytics_zoo_tpu_torch.nnframes import NNClassifier, NNImageReader
    rng = np.random.default_rng(SEED + 29)
    n, w, k = P25_NN["rows"], P25_NN["width"], P25_NN["classes"]
    x = rng.standard_normal((n, w), dtype=np.float32)
    y = (x[:, :k].argmax(1)).astype(np.int64)
    df = pd.DataFrame({"features": list(x), "label": y})
    m = Sequential()
    m.add(kl.Dense(128, input_shape=(w,), activation="relu", name="nn_h"))
    m.add(kl.Dense(k, activation="softmax", name="nn_out"))
    seeded_weights(m.module, SEED + 30)
    clf = (NNClassifier(m, "sparse_categorical_crossentropy",
                        optimizer="adam", device=dev)
           .setBatchSize(P25_NN["batch"]).setMaxEpoch(P25_NN["epochs"]))
    t0 = time.perf_counter()
    model = clf.fit(df)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(df)
    transform_s = time.perf_counter() - t0
    probs = model.estimator.predict(x, batch_size=model.batch_size)
    argmax_equal = bool(np.array_equal(out["prediction"].to_numpy(),
                                       probs.argmax(-1).astype(np.float64)))
    acc = float((out["prediction"].to_numpy() == y).mean())
    imgs = NNImageReader.read_images(png_dir)
    e = dict(fit_s=fit_s, transform_s=transform_s,
             argmax_equal=argmax_equal, train_accuracy=acc,
             images_read=len(imgs),
             image_shape=list(imgs["image"][0].shape))
    rep["e"] = e
    log(f"25(e) NNClassifier on {kind}: {n} rows x {w}, {k} classes, "
        f"{P25_NN['epochs']} epochs of {P25_NN['batch']} in {fit_s:.2f} s, "
        f"transform {transform_s:.2f} s; prediction column = argmax of "
        f"predict: {argmax_equal}; train accuracy {acc:.3f}; NNImageReader "
        f"{len(imgs)} images of {e['image_shape']}")
    if not argmax_equal or len(imgs) != P25_PNGS or \
            e["image_shape"] != [32, 32, 3]:
        raise AssertionError(f"25(e) {e}")


def p25_gan_nets(torch):
    from torch import nn
    g = P25_GAN
    gen = nn.Sequential(nn.Linear(g["noise"], g["g"][0]), nn.ReLU(),
                        nn.Linear(g["g"][0], g["g"][1]), nn.ReLU(),
                        nn.Linear(g["g"][1], g["out"]), nn.Tanh())

    class Disc(nn.Module):
        def __init__(self):
            super().__init__()
            self.net = nn.Sequential(
                nn.Linear(g["out"], g["d"][0]), nn.LeakyReLU(0.2),
                nn.Linear(g["d"][0], g["d"][1]), nn.LeakyReLU(0.2),
                nn.Linear(g["d"][1], 1))

        def forward(self, x):
            return self.net(x)[:, 0]
    disc = Disc()
    seeded_weights(gen, SEED + 31)
    seeded_weights(disc, SEED + 32)
    return gen, disc


def p25_plain_adam(torch, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """optax's first Adam update from zero moments, tensor by tensor in
    its order of rounding: Adam's first step is about lr x sign(g), so a
    gradient near eps (1e-8) moves by up to the rate on another order of
    rounding (torch.optim.Adam's reads up to 7e-5 from this one)."""
    import numpy as np
    c1 = float(1 - np.float32(b1) ** np.float32(1))
    c2 = float(1 - np.float32(b2) ** np.float32(1))
    with torch.no_grad():
        for p in params:
            g = p.grad
            mu = torch.zeros_like(g) * b1 + g * (1 - b1)
            nu = torch.zeros_like(g) * b2 + (g * g) * (1 - b2)
            p.add_((mu / c1) / (torch.sqrt(nu / c2) + eps) * -lr)
            p.grad = None


def p25_plain_gan_step(torch, gen, disc, x, z, lsgan):
    """One GAN step in plain autograd and optax's Adam, in the JAX
    package's order: D on real and fake, then G through the updated D."""
    import torch.nn.functional as F
    with torch.no_grad():
        fake = gen(z)
    real_l, fake_l = disc(x), disc(fake)
    if lsgan:
        d_loss = (((real_l - 1) ** 2).mean() + (fake_l ** 2).mean()) / 2
    else:
        d_loss = -(F.logsigmoid(real_l).mean()
                   + F.logsigmoid(-fake_l).mean())
    d_loss.backward()
    p25_plain_adam(torch, list(disc.parameters()))
    for p in gen.parameters():
        p.grad = None
    fl = disc(gen(z))
    g_loss = ((fl - 1) ** 2).mean() if lsgan else -F.logsigmoid(fl).mean()
    g_loss.backward()
    p25_plain_adam(torch, list(gen.parameters()))
    return float(d_loss.detach()), float(g_loss.detach())


def p25_gan(torch, np, kind, dev, rep):
    """25(f): 20 steps each of minimax and lsgan at MNIST width with
    finite losses, step 0 against the plain autograd step from the same z
    and parameters, generate(64)."""
    import copy
    from analytics_zoo_tpu_torch.learn.gan import GANEstimator
    g = P25_GAN
    rng = np.random.default_rng(SEED + 33)
    data = torch.from_numpy(rng.uniform(
        -1, 1, (g["batch"] * g["steps"], g["out"])).astype(np.float32)).to(
        dev)
    f = {}
    for loss in ("minimax", "lsgan"):
        gen, disc = p25_gan_nets(torch)
        gan = GANEstimator(gen, disc, noise_dim=g["noise"], loss=loss,
                           seed=SEED, device=dev)
        pgen, pdisc = copy.deepcopy(gan.generator), \
            copy.deepcopy(gan.discriminator)
        d_losses, g_losses = [], []
        t0 = time.perf_counter()
        for s in range(g["steps"]):
            x = data[s * g["batch"]:(s + 1) * g["batch"]]
            z = gan._draw(g["batch"], gan._noise)
            if s == 0:
                plain = p25_plain_gan_step(torch, pgen, pdisc, x, z,
                                           loss == "lsgan")
            d, gl = gan._step(x, z)
            d_losses.append(float(d))
            g_losses.append(float(gl))
            if s == 0:
                step0 = max(
                    [abs(d_losses[0] - plain[0]), abs(g_losses[0] - plain[1])]
                    + [float((p.detach() - q.detach()).abs().max())
                       for p, q in zip(
                        list(gan.generator.parameters())
                        + list(gan.discriminator.parameters()),
                        list(pgen.parameters()) + list(pdisc.parameters()))])
        if dev == "cuda":
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / g["steps"] * 1e3
        out = gan.generate(64)
        f[loss] = dict(d_losses=d_losses, g_losses=g_losses,
                       step0_max_abs_err=step0, step_ms=step_ms,
                       generate_shape=list(out.shape),
                       finite=bool(np.isfinite(d_losses + g_losses).all()
                                   and np.isfinite(out).all()))
        log(f"25(f) GAN {loss} at MNIST width on {kind} (noise "
            f"{g['noise']}, G {g['g']} -> {g['out']}, D {g['d']} -> 1, "
            f"batch {g['batch']}): {g['steps']} steps, {step_ms:.3f} ms a "
            f"step (host clock, the noise drawn on the card), last D/G "
            f"loss {d_losses[-1]:.4f} / {g_losses[-1]:.4f}; step 0 against "
            f"plain autograd and optax's Adam from the same z: "
            f"{step0:.3g} (limit {P25_GAN_ATOL}); generate(64) "
            f"{f[loss]['generate_shape']}")
        if not f[loss]["finite"] or step0 > P25_GAN_ATOL or \
                f[loss]["generate_shape"] != [64, g["out"]]:
            raise AssertionError(f"25(f) {loss}: {f[loss]}")
    rep["f"] = f


def p25_encoder(torch):
    from torch import nn
    e = P25_ENCODER
    torch.manual_seed(SEED + 34)
    layer = nn.TransformerEncoderLayer(e["d_model"], e["nhead"], e["dim_ff"],
                                       dropout=0.0, activation="gelu",
                                       batch_first=True)
    return nn.TransformerEncoder(layer, e["layers"],
                                 enable_nested_tensor=False).eval()


def p25_forward_ms(torch, fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def p25_torchnet(torch, np, kind, dev, rep, resnet):
    """25(g): the BERT-Base-wide TransformerEncoder served through
    Net.load_torch and InferenceModel.load_torch at use_flash=None after
    the shape's verdict: 12 B3 launches a forward, the output within
    P25_ENCODER_ATOL of torch's own run; ResNet-50's twin bitwise itself
    through Net.load_torch."""
    import copy
    import shutil
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.net import Net
    from analytics_zoo_tpu_torch.ops import _build, autotune
    e = P25_ENCODER
    d = e["d_model"] // e["nhead"]
    g = {}
    # the verdict in a file of the phase's own, removed after
    prev_cache = os.environ.get("ZOO_AUTOTUNE_CACHE")
    os.makedirs(AUTOTUNE_DIR, exist_ok=True)
    os.environ["ZOO_AUTOTUNE_CACHE"] = os.path.join(AUTOTUNE_DIR,
                                                    "autotune.json")
    autotune.reset_tuner()
    try:
        with autotune_mode("sync"):
            rec = autotune.tune_attention(e["batch"], e["seq"], e["nhead"], d,
                                          dtype=torch.float32)
        p22_check_record(rec, "25(g) verdict")
        module = p25_encoder(torch).to(dev)
        x = torch.from_numpy(np.random.default_rng(SEED + 35)
                             .standard_normal((e["batch"], e["seq"],
                                               e["d_model"]),
                                              dtype=np.float32)).to(dev)
        # torch's unfused path: a hook on each attention keeps the layer
        # off its fused fast path (as net/torch_net.py's swap does)
        unfused = copy.deepcopy(module)
        for layer in unfused.layers:
            layer.self_attn.register_forward_pre_hook(lambda *a: None)
        with torch.inference_mode():
            fused = module(x).float().cpu().numpy()
            torch_ms = p25_forward_ms(torch, lambda: module(x))
            want = unfused(x).float().cpu().numpy()
            unfused_ms = p25_forward_ms(torch, lambda: unfused(x))
            ref64 = unfused.double()(x.double()).cpu().numpy()
        del unfused
        xs = x.cpu().numpy()
        with autotune_mode("sync"):
            net = Net.load_torch(module, device=dev)
            im = InferenceModel(device=dev).load_torch(module, xs[:2])
            for name, run in (("net", lambda: net.predict(xs)),
                              ("inference_model",
                               lambda: im.predict(xs, batch_size=e["batch"]))):
                _build.reset_launch_counts()
                got = run()
                per = _build.launch_counts().get("flash_attention_fwd", 0)
                ms = p25_forward_ms(torch, run)
                g[name] = dict(flash_launches_per_forward=per, ms=ms,
                               max_abs_err=float(np.abs(got - want).max()),
                               f64_err=float(np.abs(got - ref64).max()),
                               fused_err=float(np.abs(got - fused).max()),
                               finite=bool(np.isfinite(got).all()))
        g.update(verdict=rec, torch_ms=torch_ms, unfused_ms=unfused_ms,
                 swapped=net.swapped,
                 unfused_f64_err=float(np.abs(want - ref64).max()),
                 fused_f64_err=float(np.abs(fused - ref64).max()))
    finally:
        shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
        if prev_cache is None:
            os.environ.pop("ZOO_AUTOTUNE_CACHE", None)
        else:
            os.environ["ZOO_AUTOTUNE_CACHE"] = prev_cache
        autotune.reset_tuner()
    twin = Net.load_torch(resnet["module"], device=dev)
    twin_out = twin.predict(resnet["x"])
    g["resnet_twin_bitwise"] = bool(np.array_equal(twin_out,
                                                   resnet["want"]))
    g["resnet_twin_swapped"] = twin.swapped
    rep["g"] = g
    log(f"25(g) TorchNet on {kind}: nn.TransformerEncoder of {e['layers']} "
        f"layers (d {e['d_model']}, {e['nhead']} heads, FFN {e['dim_ff']}, "
        f"gelu) at {e['batch']} x {e['seq']} fp32, TF32 off; verdict "
        f"{p22_verdict_line(rec)}; {net.swapped} attentions swapped")
    for name, label in (("net", "Net.load_torch"),
                        ("inference_model", "InferenceModel.load_torch")):
        r = g[name]
        log(f"25(g) {label}: {r['ms']:.3f} ms a forward, "
            f"{r['flash_launches_per_forward']} B3 launches; "
            f"{r['max_abs_err']:.3g} from torch's own unfused run, "
            f"{r['f64_err']:.3g} from it in float64 (limit "
            f"{P25_ENCODER_ATOL:.3g}: twice dev/estimate_torchnet_"
            f"limits.py's reading for FLASH_ATOL); {r['fused_err']:.3g} "
            f"from torch's fused fast path (not held)")
    log(f"25(g) torch itself: fused fast path {torch_ms:.3f} ms a forward, "
        f"{g['fused_f64_err']:.3g} from float64; unfused {unfused_ms:.3f} "
        f"ms, {g['unfused_f64_err']:.3g} from float64; ResNet-50's twin "
        f"through Net.load_torch bitwise itself: "
        f"{g['resnet_twin_bitwise']} ({twin.swapped} swapped)")
    for name in ("net", "inference_model"):
        r = g[name]
        if r["flash_launches_per_forward"] != e["layers"] or not r["finite"] \
                or r["max_abs_err"] > P25_ENCODER_ATOL \
                or r["f64_err"] > P25_ENCODER_ATOL:
            raise AssertionError(f"25(g) {name}: {g}")
    if not g["resnet_twin_bitwise"] or twin.swapped:
        raise AssertionError(f"25(g) ResNet-50 twin: {g}")


# ---- 25(h)'s writers: ResNet-50's twin as ONNX and as IR v10 ----------

def p25_pb_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def p25_pb_len(field: int, payload: bytes) -> bytes:
    return p25_pb_varint((field << 3) | 2) + p25_pb_varint(len(payload)) \
        + payload


def p25_pb_int(field: int, v: int) -> bytes:
    return p25_pb_varint(field << 3) + p25_pb_varint(v)


def p25_onnx_attr(name: str, value) -> bytes:
    """An AttributeProto: INT (type 2), INTS (7) or FLOAT (1)."""
    import struct
    out = p25_pb_len(1, name.encode())
    if isinstance(value, float):
        return out + p25_pb_varint((3 << 3) | 5) + struct.pack("<f", value) \
            + p25_pb_int(20, 1)
    if isinstance(value, int):
        return out + p25_pb_int(4, value) + p25_pb_int(20, 2)
    for v in value:
        out += p25_pb_int(8, int(v))
    return out + p25_pb_int(20, 7)


def p25_onnx_tensor(name: str, arr) -> bytes:
    import numpy as np
    code = {np.dtype("float32"): 1, np.dtype("int64"): 7}[arr.dtype]
    out = b"".join(p25_pb_int(1, d) for d in arr.shape)
    return out + p25_pb_int(2, code) + p25_pb_len(8, name.encode()) \
        + p25_pb_len(9, np.ascontiguousarray(arr).tobytes())


def p25_onnx_node(op, inputs, outputs, attrs=()) -> bytes:
    out = b"".join(p25_pb_len(1, i.encode()) for i in inputs)
    out += b"".join(p25_pb_len(2, o.encode()) for o in outputs)
    out += p25_pb_len(4, op.encode())
    return out + b"".join(p25_pb_len(5, p25_onnx_attr(k, v))
                          for k, v in attrs)


def p25_trace(torch, module):
    """The twin's fx graph as (op, name, module or function, input names)
    in order: every layer a Conv2d, BatchNorm2d, ReLU, MaxPool2d,
    AdaptiveAvgPool2d(1) or Linear, the residual adds and the flatten."""
    import operator
    import torch.fx as fx
    gm = fx.symbolic_trace(module)
    mods = dict(gm.named_modules())
    out = []
    for n in gm.graph.nodes:
        args = [a.name for a in n.args if isinstance(a, fx.Node)]
        if n.op == "call_module":
            out.append(("module", n.name, mods[n.target], args))
        elif n.op == "call_function":
            if n.target in (operator.add, torch.add):
                out.append(("add", n.name, None, args))
            elif n.target is torch.flatten:
                out.append(("flatten", n.name, None, args))
            else:
                raise ValueError(f"25(h) writer: no rule for {n.target}")
        elif n.op in ("placeholder", "output"):
            out.append((n.op, n.name, None, args))
        else:
            raise ValueError(f"25(h) writer: no rule for {n.op}")
    return out


def p25_write_onnx(torch, np, module, path):
    """ResNet-50's twin as an ONNX ModelProto (Conv, BatchNormalization,
    Relu, MaxPool, Add, GlobalAveragePool, Flatten, Gemm)."""
    from torch import nn
    nodes, inits, inputs, output = [], [], [], None

    def init(name, t):
        inits.append(p25_onnx_tensor(name, t.detach().cpu().numpy()
                                     .astype(np.float32)))
        inputs.append(name)
        return name

    def pair(v):
        return list(v) if isinstance(v, tuple) else [v, v]

    for kind, name, mod, args in p25_trace(torch, module):
        if kind == "placeholder":
            inputs.insert(0, name)
            continue
        if kind == "output":
            output = args[0]
            continue
        if kind == "add":
            nodes.append(p25_onnx_node("Add", args, [name]))
        elif kind == "flatten":
            nodes.append(p25_onnx_node("Flatten", args, [name],
                                       [("axis", 1)]))
        elif isinstance(mod, nn.Conv2d):
            ins = args + [init(f"{name}.w", mod.weight)]
            if mod.bias is not None:
                ins.append(init(f"{name}.b", mod.bias))
            p = pair(mod.padding)
            nodes.append(p25_onnx_node("Conv", ins, [name], [
                ("kernel_shape", pair(mod.kernel_size)),
                ("strides", pair(mod.stride)), ("pads", p + p)]))
        elif isinstance(mod, nn.BatchNorm2d):
            ins = args + [init(f"{name}.{k}", getattr(mod, a)) for k, a in (
                ("scale", "weight"), ("bias", "bias"),
                ("mean", "running_mean"), ("var", "running_var"))]
            nodes.append(p25_onnx_node("BatchNormalization", ins, [name],
                                       [("epsilon", float(mod.eps))]))
        elif isinstance(mod, nn.ReLU):
            nodes.append(p25_onnx_node("Relu", args, [name]))
        elif isinstance(mod, nn.MaxPool2d):
            p = pair(mod.padding)
            nodes.append(p25_onnx_node("MaxPool", args, [name], [
                ("kernel_shape", pair(mod.kernel_size)),
                ("strides", pair(mod.stride)), ("pads", p + p)]))
        elif isinstance(mod, nn.AdaptiveAvgPool2d):
            nodes.append(p25_onnx_node("GlobalAveragePool", args, [name]))
        elif isinstance(mod, nn.Linear):
            ins = args + [init(f"{name}.w", mod.weight),
                          init(f"{name}.b", mod.bias)]
            nodes.append(p25_onnx_node("Gemm", ins, [name],
                                       [("transB", 1)]))
        else:
            raise ValueError(f"25(h) ONNX writer: {type(mod).__name__}")
    graph = b"".join(p25_pb_len(1, n) for n in nodes)
    graph += p25_pb_len(2, b"resnet50")
    graph += b"".join(p25_pb_len(5, t) for t in inits)
    graph += b"".join(p25_pb_len(11, p25_pb_len(1, i.encode()))
                      for i in inputs)
    graph += p25_pb_len(12, p25_pb_len(1, output.encode()))
    data = p25_pb_int(1, 8) + p25_pb_len(7, graph)
    with open(path, "wb") as fh:
        fh.write(data)
    return len(nodes)


def p25_write_ir(torch, np, module, in_shape, xml_path, bin_path):
    """ResNet-50's twin as OpenVINO IR v10 (Parameter, Const,
    Convolution, BatchNormInference (opset5), ReLU, MaxPool, Add,
    ReduceMean, Reshape, MatMul, Result)."""
    from torch import nn
    layers, edges, blob = [], [], bytearray()
    ids = {}

    def layer(typ, n_in, attrs=None, version="opset1", extra=""):
        lid = len(layers)
        data = "" if not attrs else "<data " + " ".join(
            f'{k}="{v}"' for k, v in attrs.items()) + "/>"
        ins = "" if not n_in else "<input>" + "".join(
            f'<port id="{p}"/>' for p in range(n_in)) + "</input>"
        out = "" if typ == "Result" else \
            f'<output><port id="{n_in}" precision="FP32"/></output>'
        layers.append(f'<layer id="{lid}" name="l{lid}" type="{typ}" '
                      f'version="{version}">{data}{ins}{out}</layer>')
        return lid, n_in

    def edge(src, dst, port):
        edges.append(f'<edge from-layer="{src[0]}" from-port="{src[1]}" '
                     f'to-layer="{dst[0]}" to-port="{port}"/>')

    def const(arr):
        arr = np.ascontiguousarray(arr)
        off = len(blob)
        blob.extend(arr.tobytes())
        et = {np.dtype("float32"): "f32", np.dtype("int64"): "i64"}[
            arr.dtype]
        return layer("Const", 0, {"element_type": et, "offset": off,
                                  "size": arr.nbytes,
                                  "shape": ",".join(map(str, arr.shape))})

    def op(typ, srcs, attrs=None, version="opset1"):
        lid = layer(typ, len(srcs), attrs, version)
        for port, s in enumerate(srcs):
            edge(s, lid, port)
        return lid

    def t(x):
        return x.detach().cpu().numpy().astype(np.float32)

    def pair(v):
        return tuple(v) if isinstance(v, tuple) else (v, v)

    for kind, name, mod, args in p25_trace(torch, module):
        src = [ids[a] for a in args]
        if kind == "placeholder":
            ids[name] = layer("Parameter", 0, {
                "shape": ",".join(map(str, in_shape)), "element_type": "f32"})
            continue
        if kind == "output":
            op("Result", src)
            continue
        if kind == "add":
            ids[name] = op("Add", src)
        elif kind == "flatten":
            ids[name] = op("Reshape", src + [const(np.array([0, -1],
                                                              np.int64))],
                           {"special_zero": "true"})
        elif isinstance(mod, nn.Conv2d):
            p, s = pair(mod.padding), pair(mod.stride)
            y = op("Convolution", src + [const(t(mod.weight))], {
                "strides": f"{s[0]},{s[1]}", "dilations": "1,1",
                "pads_begin": f"{p[0]},{p[1]}", "pads_end": f"{p[0]},{p[1]}",
                "auto_pad": "explicit"})
            if mod.bias is not None:
                y = op("Add", [y, const(t(mod.bias).reshape(1, -1, 1, 1))])
            ids[name] = y
        elif isinstance(mod, nn.BatchNorm2d):
            ids[name] = op("BatchNormInference", src + [
                const(t(mod.weight)), const(t(mod.bias)),
                const(t(mod.running_mean)), const(t(mod.running_var))],
                {"epsilon": mod.eps}, version="opset5")
        elif isinstance(mod, nn.ReLU):
            ids[name] = op("ReLU", src)
        elif isinstance(mod, nn.MaxPool2d):
            k, s, p = pair(mod.kernel_size), pair(mod.stride), \
                pair(mod.padding)
            ids[name] = op("MaxPool", src, {
                "kernel": f"{k[0]},{k[1]}", "strides": f"{s[0]},{s[1]}",
                "pads_begin": f"{p[0]},{p[1]}", "pads_end": f"{p[0]},{p[1]}",
                "rounding_type": "floor"})
        elif isinstance(mod, nn.AdaptiveAvgPool2d):
            ids[name] = op("ReduceMean", src + [const(np.array([2, 3],
                                                               np.int64))],
                           {"keep_dims": "true"})
        elif isinstance(mod, nn.Linear):
            y = op("MatMul", src + [const(t(mod.weight))],
                   {"transpose_a": "false", "transpose_b": "true"})
            ids[name] = op("Add", [y, const(t(mod.bias))])
        else:
            raise ValueError(f"25(h) IR writer: {type(mod).__name__}")
    xml = ('<?xml version="1.0"?><net name="resnet50" version="10">'
           "<layers>" + "".join(layers) + "</layers><edges>"
           + "".join(edges) + "</edges></net>")
    with open(xml_path, "w") as fh:
        fh.write(xml)
    with open(bin_path, "wb") as fh:
        fh.write(bytes(blob))
    return len(layers)


def p25_resnet(torch, np, dev):
    """ResNet-50's torch twin (1000 classes), seeded: the default
    initialisation from a torch seed, the batch norms' running statistics
    drawn from the numpy seed; eval; and its input batch."""
    from analytics_zoo_tpu_torch.models.migration_image import \
        make_torch_resnet50
    torch.manual_seed(SEED + 36)
    module = make_torch_resnet50()
    rng = np.random.default_rng(SEED + 37)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.0, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.uniform(
                    -0.1, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.uniform(
                    -0.1, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, c).astype(np.float32)))
    module = module.eval().to(dev)
    x = rng.standard_normal((P25_RESNET_BATCH, 3, 224, 224),
                            dtype=np.float32)
    with torch.inference_mode():
        want = module(torch.from_numpy(x).to(dev)).float().cpu().numpy()
    return {"module": module, "x": x, "want": want}


def p25_importers(torch, np, kind, dev, rep, resnet):
    """25(h): the twin written as ONNX and as IR by the writers above;
    Net.load_onnx and InferenceModel.load_openvino predict the batch on
    the card, each within P25_IMPORT_RTOL of the module (of its largest
    logit), each within P25_IMPORT_F64 of the float64 module."""
    import copy
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.net import Net
    module, x, want = resnet["module"], resnet["x"], resnet["want"]
    onnx_path = os.path.join(P25_DIR, "resnet50.onnx")
    xml_path = os.path.join(P25_DIR, "resnet50.xml")
    bin_path = os.path.join(P25_DIR, "resnet50.bin")
    t0 = time.perf_counter()
    n_onnx = p25_write_onnx(torch, np, module, onnx_path)
    n_ir = p25_write_ir(torch, np, module, x.shape, xml_path, bin_path)
    write_s = time.perf_counter() - t0
    f64 = copy.deepcopy(module).double()
    with torch.inference_mode():
        ref64 = f64(torch.from_numpy(x).double().to(dev)).cpu().numpy()
    del f64
    scale = float(np.abs(ref64).max())
    onnx = Net.load_onnx(onnx_path, device=dev)
    im = InferenceModel(device=dev).load_openvino(xml_path, bin_path,
                                                  batch_size=len(x))
    xd = torch.from_numpy(x).to(dev)
    with torch.inference_mode():
        module_ms = p25_forward_ms(torch, lambda: module(xd))
    h = dict(onnx_nodes=n_onnx, ir_layers=n_ir, write_s=write_s,
             module_ms=module_ms, scale=scale,
             module_f64_rel=float(np.abs(want - ref64).max()) / scale,
             onnx_bytes=os.path.getsize(onnx_path),
             ir_bytes=os.path.getsize(bin_path))
    for name, run in (("onnx", lambda: onnx.predict(x)),
                      ("openvino", lambda: im.predict(x,
                                                      batch_size=len(x)))):
        got = run()
        h[name] = dict(ms=p25_forward_ms(torch, run),
                       rel_err=float(np.abs(got - want).max()) / scale,
                       f64_rel=float(np.abs(got - ref64).max()) / scale,
                       finite=bool(np.isfinite(got).all()))
    rep["h"] = h
    log(f"25(h) ResNet-50's twin as ONNX ({n_onnx} nodes, {h['onnx_bytes']} "
        f"bytes) and IR v10 ({n_ir} layers, {h['ir_bytes']} bytes), written "
        f"in {write_s:.2f} s; predict {P25_RESNET_BATCH} x 3 x 224 x 224 "
        f"fp32 on {kind} (TF32 off): the module {module_ms:.3f} ms, "
        f"Net.load_onnx {h['onnx']['ms']:.3f} ms ({h['onnx']['rel_err']:.3g} "
        f"of the largest logit from the module, {h['onnx']['f64_rel']:.3g} "
        f"from float64), InferenceModel.load_openvino "
        f"{h['openvino']['ms']:.3f} ms ({h['openvino']['rel_err']:.3g}, "
        f"{h['openvino']['f64_rel']:.3g}); the module "
        f"{h['module_f64_rel']:.3g} from float64 (limits "
        f"{P25_IMPORT_RTOL:.3g} from the module, {P25_IMPORT_F64:.3g} from "
        f"float64)")
    for name in ("onnx", "openvino"):
        r = h[name]
        if not r["finite"] or r["rel_err"] > P25_IMPORT_RTOL or \
                r["f64_rel"] > P25_IMPORT_F64:
            raise AssertionError(f"25(h) {name}: {h}")
    if h["module_f64_rel"] > P25_IMPORT_F64:
        raise AssertionError(f"25(h) the module: {h}")


def phase_readers_importers(torch, np, kind, dev="cuda", sizes=None,
                            parts="abcdefgh"):
    """Phase 25: the readers feeding fits (a) TFRecord, (b) Elasticsearch,
    (c) image parquet; (d) autograd and keras2; (e) nnframes; (f) the GAN;
    (g) TorchNet's attention on the flash kernel; (h) ONNX and OpenVINO
    at ResNet-50. TF32 off; the files go under build/phase25/ and are
    removed after. ``sizes``: module constants to cut (a rehearsal).
    Each part's launches are counted from 0 just before it."""
    import shutil
    globals().update(sizes or {})
    t0 = time.perf_counter()
    rep = {}
    shutil.rmtree(P25_DIR, ignore_errors=True)
    os.makedirs(P25_DIR)
    try:
        with p17_tf32(torch, False):
            if "a" in parts:
                p19_part(rep, "a", lambda: p25_tfrecord(
                    torch, np, kind, dev, rep), phase=25)
            if "b" in parts:
                p19_part(rep, "b", lambda: p25_elastic(
                    torch, np, kind, dev, rep), phase=25)
            png_dir = None
            if "c" in parts:
                png_dir = p19_part(rep, "c", lambda: p25_parquet(
                    torch, np, kind, dev, rep), no_queue_b=True, phase=25)
            if "d" in parts:
                p19_part(rep, "d", lambda: p25_autograd_keras2(
                    torch, np, kind, dev, rep), no_queue_b=True, phase=25)
            if "e" in parts and png_dir is not None:
                p19_part(rep, "e", lambda: p25_nnframes(
                    torch, np, kind, dev, rep, png_dir), no_queue_b=True,
                    phase=25)
            if "f" in parts:
                p19_part(rep, "f", lambda: p25_gan(
                    torch, np, kind, dev, rep), no_queue_b=True, phase=25)
            resnet = p25_resnet(torch, np, dev) if set("gh") & set(parts) \
                else None
            if "g" in parts:
                p19_part(rep, "g", lambda: p25_torchnet(
                    torch, np, kind, dev, rep, resnet), phase=25)
            if "h" in parts:
                p19_part(rep, "h", lambda: p25_importers(
                    torch, np, kind, dev, rep, resnet), no_queue_b=True,
                    phase=25)
    finally:
        shutil.rmtree(P25_DIR, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t0
    log(f"phase 25: {rep['seconds']:.1f} s; launches by part: "
        f"{rep['launches']}")
    return rep


#: phase 26's seeded tree and the rule ids it must trip: every rule but
#: metric-undeclared, whose doc rows are checked only on a scan of the
#: whole package
ZOOLINT_FIXTURE = os.path.join("tests", "fixtures", "zoolint_torch")
ZOOLINT_FIXTURE_RULES = frozenset({
    "wallclock-hotpath", "hotpath-host-sync", "jit-in-loop",
    "jit-call-inline", "jit-static-unhashable",
    "jit-compile-in-serve-loop", "engine-unlocked-write", "lock-order",
    "cross-thread-unlocked-state", "lock-order-inversion",
    "blocking-under-lock", "thread-leak", "metric-undocumented",
    "envvar-undocumented", "rowwise-map-in-data-plane", "record-ack-leak",
    "lock-release-path", "span-pairing", "tainted-host-sync",
    "shape-dependent-branch-in-jit", "kv-page-leak"})
#: phase 26's limit on each CLI run (seconds)
ZOOLINT_TIMEOUT_S = 120


def phase_zoolint(kind):
    """Phase 26: the port's zoolint stands alone on the card's host. Four
    processes side by side from the checkout's root: the CLI over the
    port with its baseline (exit 0), the CLI over the seeded fixture with
    no baseline (exit 1, every rule family tripped), the same in
    ``--format github`` (exit 1, one ``::error`` line a finding), and the
    analyser's import (no JAX, nothing of the JAX package loaded)."""
    root = os.path.dirname(os.path.abspath(__file__))
    tool = [sys.executable, "-m", "analytics_zoo_tpu_torch.analysis"]
    probe = ("import sys, analytics_zoo_tpu_torch.analysis as a\n"
             "a.all_rules()\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'analytics_zoo_tpu'))\n"
             "print(bad)\n")
    runs = {"tree": tool + ["--timing", "analytics_zoo_tpu_torch"],
            "fixture": tool + ["--timing", "--no-baseline",
                               "--format=json", ZOOLINT_FIXTURE],
            "github": tool + ["--no-baseline", "--format=github",
                              ZOOLINT_FIXTURE],
            "imports": [sys.executable, "-c", probe]}

    def run(cmd):
        t1 = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=ZOOLINT_TIMEOUT_S)
        return r.returncode, r.stdout, r.stderr, time.perf_counter() - t1

    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(runs)) as pool:
        futs = {k: pool.submit(run, cmd) for k, cmd in runs.items()}
        done = {k: f.result() for k, f in futs.items()}
    rep = {"seconds": time.perf_counter() - t0}
    out = {}
    for k, (rc, o, e, sec) in done.items():
        out[k] = (rc, o, e)
        rep[f"{k}_s"] = sec
    rc, o, e = out["tree"]
    rep["tree"] = dict(rc=rc, summary=o.strip().splitlines()[-1:],
                       timing=e.strip().splitlines()[-1:])
    log(f"phase 26 (a) zoolint over analytics_zoo_tpu_torch on the host of "
        f"{kind}: exit {rc}; {' '.join(rep['tree']['summary'])}; "
        f"{' '.join(rep['tree']['timing'])}")
    if rc != 0:
        raise AssertionError(f"phase 26 (a): zoolint exited {rc}:\n{o}\n{e}")
    rc, o, e = out["fixture"]
    if rc != 1:
        raise AssertionError(f"phase 26 (b): zoolint over the seeded "
                             f"fixture exited {rc}, not 1:\n{o[-2000:]}\n"
                             f"{e[-2000:]}")
    summary = json.loads(o)["summary"]
    rep["fixture"] = dict(rc=rc, total=summary["total"],
                          by_rule=summary["by_rule"],
                          timing=e.strip().splitlines()[-1:])
    missing = sorted(ZOOLINT_FIXTURE_RULES - set(summary["by_rule"]))
    log(f"phase 26 (b) zoolint over {ZOOLINT_FIXTURE}: exit {rc}, "
        f"{summary['total']} findings over {len(summary['by_rule'])} rules "
        f"{summary['by_rule']}; {' '.join(rep['fixture']['timing'])}")
    if missing:
        raise AssertionError(f"phase 26 (b): the fixture tripped no "
                             f"{missing}")
    rc, o, e = out["github"]
    errors = sum(1 for line in o.splitlines() if line.startswith("::error "))
    rep["github"] = dict(rc=rc, errors=errors)
    log(f"phase 26 (b) --format github over the fixture: exit {rc}, "
        f"{errors} ::error lines for {summary['total']} findings")
    if rc != 1 or errors != summary["total"]:
        raise AssertionError(f"phase 26 (b): --format github exited {rc} "
                             f"with {errors} ::error lines for "
                             f"{summary['total']} findings:\n{o[-2000:]}\n"
                             f"{e[-2000:]}")
    rc, o, e = out["imports"]
    loaded = o.strip().splitlines()[-1:] if rc == 0 else None
    rep["imports"] = dict(rc=rc, forbidden=loaded)
    log(f"phase 26 (c) the analyser's import loads of JAX and the JAX "
        f"package: {loaded}")
    if loaded != ["[]"]:
        raise AssertionError(f"phase 26 (c): exit {rc}, loaded {loaded}\n"
                             f"{e[-2000:]}")
    log(f"phase 26: {rep['seconds']:.1f} s (the four processes side by "
        f"side; (a) {rep['tree_s']:.1f} s, (b) {rep['fixture_s']:.1f} s)")
    return rep


#: phase 27: the port's examples, in tests/test_examples.py's order
EXAMPLES_DIR = "examples_torch"
EXAMPLES = ("recommendation_ncf.py", "anomaly_detection.py",
            "autots_forecast.py", "cluster_serving.py", "torch_migration.py",
            "distributed_training.py", "dogs_vs_cats_transfer.py",
            "sentiment_analysis.py", "vae.py", "fraud_detection.py",
            "image_similarity.py", "wide_and_deep.py", "object_detection.py",
            "image_augmentation.py", "model_inference.py",
            "automl_hp_search.py", "qa_ranker.py", "multihost_launch.py",
            "image_classification_serving.py")
#: the examples that start ranks: subprocesses, run beside the others
#: inside phase 27 (no earlier phase's timed reading shares the card
#: with their ranks)
EXAMPLES_RANKS = ("distributed_training.py", "multihost_launch.py")
#: the kernels whose launches each in-process example reports (B1, B1b,
#: B3), and the examples that must launch some of them
EXAMPLES_KERNELS = ("fused_embedding_lookup", "embedding_scatter_add",
                    "flash_attention_fwd")
EXAMPLES_MUST = {"recommendation_ncf.py": ("fused_embedding_lookup",
                                           "embedding_scatter_add"),
                 "wide_and_deep.py": ("fused_embedding_lookup",
                                      "embedding_scatter_add")}
#: the limit on each example that starts ranks (seconds)
EXAMPLES_TIMEOUT_S = 300


def start_rank_examples(device: str = "cuda"):
    """Phase 27's two examples that start ranks, as subprocesses of their
    own (their ranks share the card over gloo): ``{name: (start time,
    Popen, stdout file, stderr file)}`` for ``phase_examples``."""
    root = os.path.dirname(os.path.abspath(__file__))
    args = [] if device == "cuda" else ["--device", device]
    # the ranks' processes (8 + 2 on the host's cores beside this one)
    # take one intra-op thread each
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for name in EXAMPLES_RANKS:
        # their output goes to files: nothing reads a pipe while the
        # in-process examples run
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, os.path.join(root, EXAMPLES_DIR, name)] + args,
            cwd=root, stdout=out, stderr=err, text=True, env=env), out, err)
    return procs


def phase_examples(kind, device: str = "cuda"):
    """Phase 27: every script of examples_torch/ on the card with its
    default device (``device`` other than "cuda" passes ``--device``).
    The two that start ranks run as subprocesses, started first and run
    beside the others; every other runs in this process through runpy,
    with the launch counts zeroed just before it and read just after, and
    no context left from an earlier phase. Each line: the wall seconds, the exit status or the
    exception, and the launches of B1, B1b and B3. Any example that
    raises or exits non-zero fails the phase, and so does
    recommendation_ncf or wide_and_deep without a B1 and a B1b launch."""
    import contextlib
    import io
    import runpy
    from analytics_zoo_tpu_torch.common.context import stop_orca_context
    from analytics_zoo_tpu_torch.ops import _build
    root = os.path.dirname(os.path.abspath(__file__))
    args = [] if device == "cuda" else ["--device", device]
    t0 = time.perf_counter()
    procs = start_rank_examples(device)
    rep, failed = {}, []
    try:
        for name in EXAMPLES:
            if name in procs:
                continue
            stop_orca_context()
            path = os.path.join(root, EXAMPLES_DIR, name)
            out = io.StringIO()
            argv = sys.argv
            sys.argv = [path] + args
            _build.reset_launch_counts()
            t1 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    runpy.run_path(path, run_name="__main__")
                status = "exit 0"
            except SystemExit as e:
                status = f"exit {e.code if e.code is not None else 0}"
            except BaseException as e:  # noqa: BLE001 - reported below
                status = f"raised {type(e).__name__}: {e}"
            finally:
                sys.argv = argv
                stop_orca_context()
            sec = time.perf_counter() - t1
            counts = _build.launch_counts()
            launches = {k: counts.get(k, 0) for k in EXAMPLES_KERNELS}
            lines = out.getvalue().strip().splitlines()
            rep[name] = dict(seconds=sec, status=status, launches=launches,
                             stdout=lines)
            if status not in ("exit 0", "exit None"):
                failed.append(name)
            missing = [k for k in EXAMPLES_MUST.get(name, ())
                       if launches[k] <= 0]
            if missing:
                failed.append(name)
                status += f"; no launch of {missing}"
            log(f"phase 27 {name}: {sec:.1f} s, {status}, launches "
                f"{launches}")
            for line in lines[-6:]:
                log(f"  | {line}")
    finally:
        ended = {}
        while len(ended) < len(procs):
            for name, (t1, p, _, _) in procs.items():
                if name in ended:
                    continue
                if p.poll() is not None:
                    ended[name] = (time.perf_counter() - t1,
                                   f"exit {p.returncode}")
                elif time.perf_counter() - t1 > EXAMPLES_TIMEOUT_S:
                    p.kill()
                    p.wait()
                    ended[name] = (time.perf_counter() - t1,
                                   f"killed after {EXAMPLES_TIMEOUT_S} s")
            time.sleep(0.05)
        for name, (t1, p, out, err) in procs.items():
            sec, status = ended[name]
            out.seek(0)
            err.seek(0)
            o, e = out.read(), err.read()
            out.close()
            err.close()
            lines = o.strip().splitlines()
            rep[name] = dict(seconds=sec, status=status, stdout=lines,
                             stderr=e.strip().splitlines()[-20:])
            if p.returncode != 0:
                failed.append(name)
            log(f"phase 27 {name} (ranks in subprocesses): {sec:.1f} s "
                f"from its start to its end, {status}")
            for line in (lines if p.returncode == 0 else
                         rep[name]["stderr"])[-8:]:
                log(f"  | {line}")
    seconds = time.perf_counter() - t0
    log(f"phase 27: {len(EXAMPLES)} examples on {kind} in {seconds:.1f} s "
        f"of wall time; failed: {failed}")
    if failed:
        raise AssertionError(f"phase 27: examples failed: {failed}")
    return {"seconds": seconds, "examples": rep}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.ops import paged_attention as pa
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)

    t_start = time.perf_counter()
    report = {}

    def mark(phase):
        """The run's seconds when ``phase`` ended (report["marks"])."""
        at = time.perf_counter() - t_start
        report.setdefault("marks", {})[phase] = at
        log(f"elapsed: phase {phase} done at {at:.1f} s")
    # the run's verdicts go to a file of its own, empty at the start, so no
    # phase reads a verdict a former run left; the autotuner reads none in
    # phases 1-21 but where a phase asks (decode's paged="auto" in 9(f)
    # and 15(g), after building its verdicts), and phase 22 sets each
    # part's mode
    import shutil
    from analytics_zoo_tpu_torch.ops import autotune
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    os.makedirs(AUTOTUNE_DIR)
    os.environ["ZOO_AUTOTUNE_CACHE"] = os.path.join(AUTOTUNE_DIR,
                                                    "autotune.json")
    os.environ["ZOO_AUTOTUNE"] = "off"
    autotune.reset_tuner()
    # 1. card
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    build_s = _build.build()
    report["build_s"] = build_s
    log(f"build: {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernel vs plain
    torch.backends.cuda.matmul.allow_tf32 = False
    log("kernels vs plain (lookup bitwise):")
    report["single_launches"] = single_launches(torch, eb)
    report["paged_single_launches"] = paged_single_launches(torch, pa)
    report["binding_floor"] = binding_floor(torch, eb)
    cases = phase_kernels(torch, eb)
    report["kernel_cases"] = cases
    flash_cases = phase_flash(torch, fa)
    report["flash_cases"] = flash_cases
    bwd_cases = phase_flash_bwd(torch, fa)
    report["flash_bwd_cases"] = bwd_cases
    log("paged kernels vs plain (gather bitwise):")
    gather_cases, attn_cases, paged_calls = phase_paged(torch, pa)
    report["paged_gather_cases"] = gather_cases
    report["paged_attention_cases"] = attn_cases
    log("bag and scatter kernels vs plain (bitwise):")
    bag_cases, scatter_cases = phase_bag(torch, eb)
    report["bag_cases"] = bag_cases
    report["scatter_cases"] = scatter_cases
    mark("3")

    # 4. slice — the NCF path starts here
    ncf = NeuralCF(**NCF)
    seeded_weights(ncf.model.module, SEED)
    rng = np.random.RandomState(SEED)
    x = np.stack([rng.randint(1, NCF["user_count"] + 1, BATCH),
                  rng.randint(1, NCF["item_count"] + 1, BATCH)],
                 1).astype(np.float32)
    _build.reset_launch_counts()
    im = InferenceModel(device="cuda").load_zoo(ncf)
    y = im.predict(x, batch_size=BATCH)
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        im.predict(x, batch_size=BATCH)
    predict_ms = (time.perf_counter() - t0) / reps * 1e3
    y_cpu = InferenceModel(device="cpu").load_zoo(ncf).predict(x)
    diff = float(np.abs(y - y_cpu).max())
    if y.shape != (BATCH, NCF["class_num"]) or not np.isfinite(y).all():
        raise AssertionError(f"bad predict output {y.shape}")
    if diff > SLICE_ATOL:
        raise AssertionError(f"cuda vs cpu predict differ by {diff}")
    if float(np.abs(y.sum(-1) - 1).max()) > 1e-5:
        raise AssertionError("softmax rows do not sum to 1")
    log(f"slice: NeuralCF predict {BATCH} rows on {kind}: "
        f"{predict_ms:.3f} ms/call (host clock), max |cuda - cpu| = "
        f"{diff:.3g} (atol {SLICE_ATOL})")
    report["slice"] = dict(predict_ms=predict_ms, max_abs_diff=diff)

    # 5. serving
    before = eb.launches.value
    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port, batch_size=SERVE_BATCH,
                           max_batch_size=SERVE_BATCH,
                           warmup=False) as serving:
        iq = InputQueue(port=broker.port)
        oq = OutputQueue(port=broker.port)
        t0 = time.perf_counter()
        uris = iq.enqueue_batch((f"b{i}", {"x": x[i]})
                                for i in range(N_BURST))
        got = oq.query_many(uris, timeout=120, poll_interval=0.002)
        burst_s = time.perf_counter() - t0
        lat = []
        for i in range(N_SINGLE):
            t1 = time.perf_counter()
            uri = iq.enqueue(f"s{i}", x=x[N_BURST + i])
            r = oq.query(uri, timeout=30, poll_interval=0.0005)
            lat.append(time.perf_counter() - t1)
            got[uri] = r
        metrics = serving.metrics()
        iq.close()
        oq.close()
    rows = {f"b{i}": i for i in range(N_BURST)}
    rows.update({f"s{i}": N_BURST + i for i in range(N_SINGLE)})
    worst = 0.0
    for uri, i in rows.items():
        if got.get(uri) is None:
            raise AssertionError(f"no result for {uri}")
        worst = max(worst, float(np.abs(got[uri] - y[i]).max()))
    if worst > SLICE_ATOL:
        raise AssertionError(f"served result differs from predict: {worst}")
    served = eb.launches.value - before
    if served <= 0:
        raise AssertionError("serving did not launch the lookup kernel")
    rps = N_BURST / burst_s
    p50 = float(np.percentile(lat, 50)) * 1e3
    log(f"serving on {kind}: {N_BURST} records in {burst_s:.3f} s = "
        f"{rps:.1f} records/s (batch {SERVE_BATCH}); single-request p50 "
        f"{p50:.3f} ms over {N_SINGLE}; max |served - predict| = "
        f"{worst:.3g}; kernel launches while serving: {served}; {metrics}")
    report["serving"] = dict(records_per_s=rps, p50_ms=p50,
                             max_abs_diff=worst, launches=served,
                             metrics=metrics)
    ncf_counts = _build.launch_counts()
    if ncf_counts.get("fused_embedding_lookup", 0) <= 0:
        raise AssertionError(
            f"NCF path launched no lookup kernel: {ncf_counts}")
    mark("5")

    # 6. BERT slice, 7. BERT serving — the BERT path
    _build.reset_launch_counts()
    bert_im, bert_y, bert_x, report["bert"] = phase_bert(
        torch, np, InferenceModel, fa, kind)
    report["bert_serving"] = phase_bert_serving(
        np, bert_im, bert_y, bert_x, fa,
        (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    bert_counts = _build.launch_counts()
    if bert_counts.get("flash_attention_fwd", 0) <= 0:
        raise AssertionError(
            f"BERT path launched no flash attention kernel: {bert_counts}")
    mark("7")
    # 8. BERT fine-tuning: (a) compares, (b) is the path
    torch.cuda.reset_peak_memory_stats()
    state = bert_classifier(None, use_flash=True).state_dict()
    report["bert_train_grads"] = phase_bert_train_grads(torch, np, state)
    _build.reset_launch_counts()
    report["bert_fit"] = phase_bert_fit(torch, np, state, Estimator, kind)
    train_counts = _build.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if train_counts.get(name, 0) <= 0:
            raise AssertionError(f"the fine-tuning path launched no {name}:"
                                 f" {train_counts}")
    mark("8")
    # 9. decode: (a)-(e) through InferenceModel and DecodeScheduler, (f)
    # through ClusterServing
    _build.reset_launch_counts()
    dec_im, greedy, dec_inputs, report["decode"] = phase_decode(
        torch, np, pa, kind)
    report["decode_serving"] = phase_decode_serving(
        np, dec_im, greedy, dec_inputs,
        (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    served_gathers = report["decode_serving"]["gather_launches"]
    decode_counts = _build.launch_counts()
    served_paged = report["decode_serving"]["metrics"]["paged_steps"]
    forced = report["decode_serving"]["forced"]
    if report["decode"]["d"]["float32"]["launches"].get("paged_gather", 0) \
            <= 0 or served_gathers != served_paged \
            or forced["gather_launches"] <= 0 \
            or forced["gather_launches"] != forced["paged_steps"]:
        raise AssertionError(f"the decode path did not launch paged_gather "
                             f"in (d) or in (f)'s forced burst {forced}, or "
                             f"(f)'s {served_gathers} gathers are not its "
                             f"{served_paged} paged steps: "
                             f"{report['decode']['d']}")
    if decode_counts.get("paged_attention", 0) <= 0:
        raise AssertionError(f"the live pool launched no paged_attention: "
                             f"{decode_counts}")
    mark("9")
    # 10. NCF training: (a) compares, (b)-(d) are the path
    x_tr, y_tr, hist_tr = ncf_train_data(np)
    report["ncf_train_step"] = {
        c: phase_train_step(np, c, x_tr, y_tr, hist_tr)
        for c in ("ncf", "hist")}
    _build.reset_launch_counts()
    report["ncf_fit"] = {
        c: phase_fit(torch, np, c, x_tr, y_tr, hist_tr, kind)
        for c in ("ncf", "hist")}
    ncf_train_counts = _build.launch_counts()
    for name in ("fused_embedding_lookup", "embedding_bag",
                 "embedding_scatter_add"):
        if ncf_train_counts.get(name, 0) <= 0:
            raise AssertionError(f"the NCF training path launched no "
                                 f"{name}: {ncf_train_counts}")
    mark("10")
    # 11. checkpoints: every part is the path
    _build.reset_launch_counts()
    report["checkpoints"] = phase_checkpoints(
        torch, np, x_tr, y_tr, hist_tr,
        (Broker, ClusterServing, InputQueue, OutputQueue), card)
    ckpt_counts = _build.launch_counts()
    for name in ("fused_embedding_lookup", "embedding_bag",
                 "embedding_scatter_add", "flash_attention_fwd"):
        if ckpt_counts.get(name, 0) <= 0:
            raise AssertionError(f"the checkpoint paths launched no {name}:"
                                 f" {ckpt_counts}")
    mark("11")
    # 12. the zoo models: (a)'s kernel cases and one-step comparisons come
    # first, then the counts restart and the Wide&Deep path runs, then
    # (b)-(f)
    report["zoo"] = phase_zoo(torch, np, eb, card)
    zoo_counts = _build.launch_counts()
    for name in ("fused_embedding_lookup", "embedding_scatter_add"):
        if zoo_counts.get(name, 0) <= 0:
            raise AssertionError(f"the zoo paths launched no {name}: "
                                 f"{zoo_counts}")
    mark("12")
    # 13. Zouwu's TCN through init_orca_context, XShards under DISK_4 and
    # the streaming feed, the forecasters: no kernel of the port on its
    # path (cuDNN's convolutions, as JAX's TCN runs outside Pallas)
    _build.reset_launch_counts()
    t13 = time.perf_counter()
    report["tcn"] = phase_tcn(torch, np, card)
    report["tcn"]["seconds"] = time.perf_counter() - t13
    tcn_counts = _build.launch_counts()
    log(f"phase 13: {report['tcn']['seconds']:.1f} s; the port's kernel "
        f"launches on the TCN path: {tcn_counts}")
    mark("13")
    # 14. the estimator's loop modes at measure_ncf, the eight optimizers,
    # remat, the BERT task estimators and the profile window: each part
    # zeroes the counts before its paths
    torch.backends.cuda.matmul.allow_tf32 = False
    t14 = time.perf_counter()
    report["a3"] = phase_a3(torch, np, eb, state, Estimator, x_tr, y_tr,
                            kind, card)
    report["a3"]["seconds"] = time.perf_counter() - t14
    a3_counts = report["a3"]["launches"]
    log(f"phase 14: {report['a3']['seconds']:.1f} s; launches by path: "
        f"{a3_counts}")
    mark("14")
    # 15. Cluster Serving's scheduling and delivery: the native broker,
    # lanes, warm-up, deadlines, admission, leases, preemption and the
    # frontend; each part zeroes the counts before its paths
    report["a7"] = phase_serving_a7(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), im,
        x, state, (dec_im, greedy, dec_inputs), kind)
    a7_counts = report["a7"]["launches"]
    log(f"phase 15: {report['a7']['seconds']:.1f} s; launches by path: "
        f"{a7_counts}")
    mark("15")
    # 16. the rest of Cluster Serving: int8 NCF and BERT-Base, the fits'
    # MFU, the quantized NCF served, /trace, the fleet from config.yaml
    # and a killed replica; each part zeroes the counts before its paths
    report["a7b"] = phase_a7b(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), ncf,
        state, Estimator, x_tr, y_tr, kind)
    a7b_counts = report["a7b"]["launches"]
    log(f"phase 16: {report['a7b']['seconds']:.1f} s; launches by path: "
        f"{a7b_counts}")
    fences = report["a7b"]["f"]["ncf_fences"]
    log(f"NCF fit ms a step (batch 8000), this call: phase 14's per-step "
        f"fit {report['a3']['ncf_loops']['per_step']['step_ms']:.3f}; phase "
        f"16 with the step profiler's sampled fences "
        f"{fences['profiled']['ms_per_step']:.3f}, without "
        f"{fences['no_fences']['ms_per_step']:.3f}")
    mark("16")
    # 17. ResNet-50 (ROADMAP A15): training, correctness, predict and
    # int8, the profile; no kernel of queue B runs on it
    report["image"] = phase_image(torch, np, kind)
    log(f"phase 17: {report['image']['seconds']:.1f} s; launches by path: "
        f"{report['image']['launches']}")
    mark("17")
    # 18. image classification from images to answers: the three new
    # architectures, the torchvision import, the ImageSet path, image
    # records served, int8 mobilenet-v2, a snapshot into InferenceModel;
    # the counts zeroed before it, no kernel of queue B on its paths
    report["image_path"] = phase_image_path(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    log(f"phase 18: {report['image_path']['seconds']:.1f} s; the port's "
        f"kernel launches on its paths: {report['image_path']['launches']}")
    mark("18")
    # 19. text from words to answers: the TextSet path, TextClassifier
    # (cnn, lstm, gru) and KNRM, the twin's import served, a frozen GloVe
    # table, load_hf_bert into BERT-Base, the bf16 forecasters, NCF through
    # Estimator.from_keras; the counts zeroed before each part
    report["text"] = phase_text(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    log(f"phase 19: {report['text']['seconds']:.1f} s")
    mark("19")
    # 20. Zouwu's AutoTS: the grid and bayes searches, the population, the
    # thread pool, MTNet, TCMF at the electricity panel's width, the
    # anomaly detectors; the counts zeroed before each part, none of queue
    # B launched
    report["zouwu"] = phase_zouwu(torch, np, kind)
    log(f"phase 20: {report['zouwu']['seconds']:.1f} s")
    mark("20")
    # 21. object detection: SSD300-VGG training and ObjectDetector at VOC
    # width, the fixture overfit, the runtime hooks, int8 recurrent cells
    # and the new layers, Arrow and encrypted records; the counts zeroed
    # before each part, none of queue B launched
    report["detection"] = phase_detection(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    log(f"phase 21: {report['detection']['seconds']:.1f} s")
    mark("21")
    # 22. the autotuner's verdicts and the routes that read them (BERT's
    # use_flash=None, measure_flash_attention, the kernels' verdicts, the
    # warm-up queue, decode's paged="auto"), Friesian into the NCF fit at
    # bench.py's size and at MovieLens-1M's under NATIVE_4, predict's
    # window; the counts zeroed before each part
    report["autotune_friesian"] = phase_autotune_friesian(torch, np, kind)
    log(f"phase 22: {report['autotune_friesian']['seconds']:.1f} s")
    mark("22")
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    # C20: the steps of phases 13, 17 and 21 with cuDNN's deterministic
    # algorithms (init_orca_context's default) and its defaults, in turns;
    # two AutoTS searches bitwise
    report["c20"] = c20_cost(torch, np, kind)
    log(f"C20: {report['c20']['seconds']:.1f} s")
    mark("C20")
    # 23. the strategies across ranks: groups of 2 and 4 ranks sharing the
    # card over gloo, a one-rank NCCL group; each part of each rank zeroes
    # the counts before its path and reads them after
    torch.cuda.empty_cache()
    report["parallel"] = phase_parallel(torch, np, kind)
    p23 = report["parallel"]["launches"]
    for path, names in (("bert", ("flash_attention_fwd",
                                  "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")),
                        ("ncf", ("fused_embedding_lookup",
                                 "embedding_scatter_add")),
                        ("ring", ("flash_attention_fwd",
                                  "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")),
                        ("ulysses", ("flash_attention_fwd",
                                     "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"))):
        for name in names:
            if p23.get(path, {}).get(name, 0) <= 0:
                raise AssertionError(f"phase 23's {path} path launched no "
                                     f"{name}: {p23}")
    mark("23")
    torch.cuda.empty_cache()
    report["pipeline_serving"] = phase_pipeline_serving(torch, np, kind)
    p24 = report["pipeline_serving"]["launches"]
    for path, name in (("bert", "flash_attention_fwd"),
                       ("ncf", "fused_embedding_lookup")):
        if p24.get(path, {}).get(name, 0) <= 0:
            raise AssertionError(f"phase 24's sharded {path} path launched "
                                 f"no {name}: {p24}")
    mark("24")
    # 25. the readers feeding fits, autograd and keras2, nnframes, the
    # GAN, TorchNet's attention on the flash kernel, ONNX and OpenVINO at
    # ResNet-50; each path's counts zeroed just before it
    torch.cuda.empty_cache()
    report["readers_importers"] = phase_readers_importers(torch, np, kind)
    r25 = report["readers_importers"]
    steps25 = r25["a"]["steps"]
    p25 = {"a_tfrecord_fit": r25["a"]["launches"],
           "b_predict": r25["b"]["launches"],
           "g_net_forward": {"flash_attention_fwd": r25["g"]["net"][
               "flash_launches_per_forward"]},
           "g_inference_model_forward": {"flash_attention_fwd": r25["g"][
               "inference_model"]["flash_launches_per_forward"]}}
    for path, name, want in (
            ("a_tfrecord_fit", "fused_embedding_lookup", 2 * steps25),
            ("a_tfrecord_fit", "embedding_scatter_add", 4 * steps25),
            ("b_predict", "fused_embedding_lookup", 2),
            ("g_net_forward", "flash_attention_fwd", 12),
            ("g_inference_model_forward", "flash_attention_fwd", 12)):
        if p25[path].get(name, 0) != want:
            raise AssertionError(f"phase 25's {path} launched "
                                 f"{p25[path].get(name, 0)} {name}, not "
                                 f"{want}: {p25}")
    mark("25")
    # 26. zoolint for the port on the card's host: the tree clean with its
    # baseline, the seeded fixture tripping every family, no JAX loaded by
    # the analyser; no kernel on its path
    report["zoolint"] = phase_zoolint(kind)
    mark("26")
    # 27. the examples of examples_torch/ on the card, each with its
    # default device; each in-process example's counts zeroed just before
    # it and read just after
    report["examples"] = phase_examples(kind)
    mark("27")
    report["launches"] = {"ncf": ncf_counts, "bert": bert_counts,
                          "bert_train": train_counts,
                          "decode": decode_counts,
                          "ncf_train": ncf_train_counts,
                          "checkpoints": ckpt_counts, "zoo": zoo_counts,
                          "tcn": tcn_counts, "a3": a3_counts,
                          "a7": a7_counts, "a7b": a7b_counts,
                          "image": report["image"]["launches"],
                          "image_path": report["image_path"]["launches"],
                          "text": report["text"]["launches"],
                          "zouwu": report["zouwu"]["launches"],
                          "detection": report["detection"]["launches"],
                          "autotune_friesian":
                              report["autotune_friesian"]["launches"],
                          "parallel": report["parallel"]["launches"],
                          "pipeline_serving": p24,
                          "readers_importers": p25,
                          "examples": {
                              name: ex["launches"] for name, ex in
                              report["examples"]["examples"].items()
                              if "launches" in ex}}

    # kernels line: each kernel's times at its path's headline shape, its
    # largest error over every case it was checked in
    head = next(c for c in cases if c["case"] == "ncf_concat"
                and c["dtype"] == "torch.float32" and c["batch"] == BATCH)
    fhead = next(c for c in flash_cases if c["case"] == "bert_base"
                 and c["dtype"] == "torch.float32")
    kernels = {"kernels": [{
        "name": "fused_embedding_lookup", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/ops/csrc/embedding_bag.cu",
        "replaces": "analytics_zoo_tpu/ops/embedding_bag.py:102",
        "launches": ncf_counts["fused_embedding_lookup"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "launch_ms": head["launch_ms"],
        "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:156",
        "launches": bert_counts["flash_attention_fwd"],
        "max_abs_err": max(c["max_abs_err"] for c in flash_cases),
        "ms": fhead["ms"], "plain_ms": fhead["plain_ms"],
        "bound_ms": fhead["bound_ms"], "bound_by": fhead["bound_by"],
        "library_ms": fhead["library_ms"]}]}
    # the backward kernels at the fine-tuning shape (fp32); library_ms is
    # the whole SDPA backward, which one call computes for both
    bhead = next(c for c in bwd_cases if c["case"] == "bert_train"
                 and c["dtype"] == "torch.float32")
    for kernel, line, grads in (("dq", 345, ("dq",)),
                                ("dkv", 376, ("dk", "dv"))):
        kernels["kernels"].append({
            "name": f"flash_attention_bwd_{kernel}", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/ops/csrc/"
                      "flash_attention_bwd.cu",
            "replaces": f"analytics_zoo_tpu/ops/flash_attention.py:{line}",
            "launches": train_counts[f"flash_attention_bwd_{kernel}"],
            "max_abs_err": max(c[f"{g}_max_abs_err"] for c in bwd_cases
                               for g in grads),
            "ms": bhead[f"{kernel}_ms"], "plain_ms": bhead[f"{kernel}_plain_ms"],
            "bound_ms": bhead[f"{kernel}_bound_ms"],
            "bound_by": bhead[f"{kernel}_bound_by"],
            "library_ms": bhead["library_ms"]})
    # the paged kernels at the decode slice's shape (fp32, the top rung's
    # table width); no single PyTorch call computes either function. The
    # combine, the attention's second launch where the plan splits the
    # rows (the live pool's rows fit one block's round and are not split),
    # at the wide case (fp32, 4096 positions): its device time a launch
    # from the profiler (it cannot be called alone), its launches from
    # phase 3d's public calls
    for name, line, recs, head_case in (
            ("paged_gather", 77, gather_cases,
             max((c for c in gather_cases if c["case"].startswith("slice")),
                 key=lambda c: c["width"])["case"]),
            ("paged_attention", 174, attn_cases, "slice")):
        head = next(c for c in recs if c["case"] == head_case
                    and c["dtype"] == "torch.float32")
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "analytics_zoo_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": f"analytics_zoo_tpu/ops/paged_attention.py:{line}",
            "launches": decode_counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in recs),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None})
    kernels["kernels"][-1]["splits"] = head["splits"]
    whead = next(c for c in attn_cases if c["case"] == "wide"
                 and c["dtype"] == "torch.float32")
    kernels["kernels"].append({
        "name": "paged_attention_combine", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "analytics_zoo_tpu/ops/paged_attention.py:174 "
                    "(_attn_kernel's flush, across splits)",
        "launches": paged_calls["paged_attention_combine"],
        "launches_on": "phase 3d's public attention calls",
        "max_abs_err": max(c["combine_max_abs_err"] for c in attn_cases
                           if "combine_max_abs_err" in c),
        "ms": whead["combine_device_ms"], "ms_by": "profiler",
        "device_ms": whead["combine_device_ms"],
        "plain_ms": whead["combine_plain_ms"],
        "bound_ms": whead["combine_bound_ms"],
        "bound_by": whead["combine_bound_by"], "library_ms": None})
    # the bag at the history column's shape as the keras layer calls it
    # (no lengths, mean, fp32); the scatter at NCF's item table (concat,
    # fp32), its launch alone from sorted keys
    bag_head = next(c for c in bag_cases if c["case"] == "slice_no_lengths"
                    and c["mode"] == "mean" and c["dtype"] == "torch.float32")
    sc_head = next(c for c in scatter_cases if c["case"] == "ncf_concat"
                   and c["dtype"] == "torch.float32")
    for name, replaces, recs, head in (
            ("embedding_bag", "analytics_zoo_tpu/ops/embedding_bag.py:155",
             bag_cases, bag_head),
            ("embedding_scatter_add",
             "analytics_zoo_tpu/ops/embedding_bag.py:222 _fused_bwd and "
             ":261 _bag_bwd (plain JAX)", scatter_cases, sc_head)):
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "analytics_zoo_tpu_torch/ops/csrc/embedding_bag.cu",
            "replaces": replaces, "launches": ncf_train_counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
        if name == "embedding_bag":
            kernels["kernels"][-1].update(launch_ms=head["launch_ms"],
                                          device_ms=head["device_ms"])
    # Wide&Deep's path (phase 12): the lookup and the scatter at its
    # tables, their launches there and per training step
    wnd = report["zoo"]["widedeep"]
    for row in kernels["kernels"]:
        rec = {"fused_embedding_lookup": wnd["lookup"],
               "embedding_scatter_add": wnd["scatter"]}.get(row["name"])
        if rec is None:
            continue
        row.update(
            widedeep_launches=zoo_counts[row["name"]],
            widedeep_launches_per_step=wnd["fit"]["launches_per_step"][
                row["name"]],
            **{f"widedeep_{k}": rec[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")})
    # phase 14's paths: the NCF loop modes, the optimizers and the profile
    # window (B1, B1b), the remat fit (B3-B5)
    loops = a3_counts["ncf_loops"]
    for row in kernels["kernels"]:
        name = row["name"]
        if name in ("fused_embedding_lookup", "embedding_scatter_add"):
            row["phase14_launches"] = dict(
                **{f"ncf_{m}": loops[m].get(name, 0) for m in loops},
                optimizers=a3_counts["optimizers"].get(name, 0),
                profile=a3_counts["profile"].get(name, 0))
        elif name.startswith("flash_attention"):
            row["phase14_launches"] = dict(
                bert_remat=a3_counts["bert_remat"].get(name, 0))
    # phase 15's paths: NCF behind the lanes, deadlines, admission and
    # leases (B1), BERT-Base behind warm-up (B3), generate records with
    # preemption (B6)
    for row in kernels["kernels"]:
        p15 = {path: c.get(row["name"], 0) for path, c in a7_counts.items()
               if c.get(row["name"], 0)}
        if p15:
            row["phase15_launches"] = p15
    # phase 16's paths: int8 NCF, served and in the fleet (B1), int8
    # BERT-Base (B3), the profiled fits (B1, B1b, B3-B5)
    for row in kernels["kernels"]:
        p16 = {path: c.get(row["name"], 0) for path, c in a7b_counts.items()
               if c.get(row["name"], 0)}
        if p16:
            row["phase16_launches"] = p16
    # phase 19's paths: NCF through Estimator.from_keras (B1, B1b),
    # load_hf_bert into BERT-Base (B3-B5)
    for row in kernels["kernels"]:
        p19 = {part: c.get(row["name"], 0) for part, c in
               report["text"]["launches"].items() if c.get(row["name"], 0)}
        if p19:
            row["phase19_launches"] = p19
    # phase 22's paths: BERT by its verdict, measure_flash_attention and
    # the queue's drain (B3), one public call each after the verdicts (B1,
    # B2, B6, B7), decode by its verdicts (B6), the recsys and ML-1M fits
    # (B1, B1b), predict's windows (B1)
    for row in kernels["kernels"]:
        p22 = {part: c.get(row["name"], 0) for part, c in
               report["autotune_friesian"]["launches"].items()
               if c.get(row["name"], 0)}
        if p22:
            row["phase22_launches"] = p22
    # phase 23's paths, summed over the ranks of its groups: BERT-Base
    # under dp / fsdp / tp (B3-B5), NCF under dp / tp on the tables'
    # column blocks (B1, B1b), the ring and Ulysses (B3-B5)
    for row in kernels["kernels"]:
        p23 = {part: c.get(row["name"], 0) for part, c in
               report["parallel"]["launches"].items()
               if c.get(row["name"], 0)}
        if p23:
            row["phase23_launches"] = p23
    # phase 24's paths, summed over the ranks of its groups: BERT-Base
    # served "tp2" on 6 heads a rank (B3), NCF served "tp2" on the tables'
    # column blocks (B1)
    for row in kernels["kernels"]:
        got = {part: c.get(row["name"], 0) for part, c in p24.items()
               if c.get(row["name"], 0)}
        if got:
            row["phase24_launches"] = got
    # phase 27's paths: each example run in this process (B1, B1b, B3)
    for row in kernels["kernels"]:
        got = {name: ex["launches"][row["name"]] for name, ex in
               report["examples"]["examples"].items()
               if ex.get("launches", {}).get(row["name"], 0)}
        if got:
            row["phase27_launches"] = got
    # phase 25's paths: NCF fit from TFRecords (B1, B1b), NCF predict of
    # the rows read from Elasticsearch (B1), a forward of the foreign
    # TransformerEncoder through Net.load_torch and InferenceModel (B3)
    for row in kernels["kernels"]:
        got = {part: c.get(row["name"], 0) for part, c in p25.items()
               if c.get(row["name"], 0)}
        if got:
            row["phase25_launches"] = got
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    # the card again, so that the output's tail names it beside the numbers
    log(f"chip_smoke: {report['seconds']:.1f} s in all on {card}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(json.dumps(kernels))
    # result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
