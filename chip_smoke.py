#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, `nvcc`
and `triton`.  It builds the port's kernels from the sources in the
checkout (into `.kernel_build/`), holds each kernel against its plain
PyTorch version at its paths' shapes, times both beside the
kernel's bound and one PyTorch library call computing the same function,
then drives the port's paths with random weights from a seed:
generation through `GenerationEngine` at GPT-2 small's widths (with
prefix caching, chunked prefill, the host KV tier and speculative
decoding in phase 14),
BERT-base classification through `InferenceModel`, BERT-base
fine-tuning through `Estimator.fit` (with remat, a learning-rate
schedule, checkpoints, a failure and its retry, and validation data in
phase 12), and recommendation training (NeuralCF, WideAndDeep,
SessionRecommender) through `Estimator.fit` from the DEVICE data
store, Orca's data path (XShards, the DISK tier, pinned
prefetch, the new optimizers and losses) in phase 13, the serving
front end (ServingServer over HTTP: NCF, BERT-base and GPT-2 small) in
phase 15, int8 weight serving (BERT-base, ResNet-50, NCF) in phase 16
and the image zoo (ResNet-50 fine-tuning, Inception-v1, MobileNetV2,
VGG-16, SSD and Faster R-CNN) in phase 17 and the rest of the model
zoo (BERT-base from a checkpoint file, TextClassifier, KNRM, Seq2Seq,
AnomalyDetector, VAE, GANEstimator, InferenceEstimator) in phase 18 and
the Keras-style API (`Estimator.from_keras`, the NCF toy, a Keras BERT
and TransformerLayer, conv and recurrent stacks) in phase 19 and the
model importers (an ONNX BERT-base through `Estimator.from_onnx`, a TF1
MobileNet through `InferenceModel.load_tf`, CaffeNet through
`Net.load_caffe`) in phase 20 and Chronos AutoTS (init_orca_context,
the TCN / LSTM / Seq2Seq forecasters, AutoTSEstimator and TSPipeline,
the search engine's device and process backends) in phase 21 and the
rest of Chronos and AutoML (MTNet, TCMF, the AE and threshold
detectors, ARIMA with AutoARIMA through AutoTSEstimator, AutoXGBoost,
the DoppelGANger simulator) in phase 22 and the training-side
observability planes (spans, events, goodput, the flight recorder, the
watchdog and the nonfinite sentinel, memory telemetry, the dispatch
ledger with MFU, the request lifecycle log) on the fine-tune and decode
paths in phase 23 and the serving-side planes (SLO tracking and the SLO
shedder, latency blame and tail exemplars, W3C trace context, the
timeline export, the metrics history with its alerts, the telemetry
spool and the fleet view, the server's tracing routes) over /generate
in phase 24 and serving scale-out (native CRC32C, the worker pool, the
replica router, durable streams with consumers, the control plane, the
gRPC front end) in phase 25 and resilience and long context (encrypted
models, the elastic training driver, ring attention over two ranks at
t = 16384, the router's shared host tier and phase-aware routing) in
phase 26;
each path's
outputs (or first gradients,
or training steps) are checked against a recompute through the plain
versions or the port on the CPU.

Phases (each one failing exits non-zero, with no result line):
  1. setup: card name and power limit, versions, kernel build, TF32 off;
  2. K1 LayerNorm forward (Triton) vs its plain version;
  3. K6 paged decode attention (CUDA) vs its plain version, f32, int8,
     f16 and bf16 pools, on the body the wrapper picks (split) and the
     first design's body (rows) on the same operands, timed beside it;
     an unaligned pool, which takes the rows body;
  4. K2 fused dense + bias + GELU (CUDA) vs its plain version, bf16 and
     f32, at the BERT fc1 shapes and a ragged one, and in bf16 at m and n
     no multiple of the Hopper body's tile and at k % 8 != 0 (the
     cp_async body), each on the body its layout calls for; where the
     Hopper body runs, the cp_async body also runs on the same operands,
     held to the same gate and timed beside it (`cp_async_ms`); the bf16
     gate is 2^-7 of |ref| plus 1.13e-6 of sum |x w| + |b| (f32 sums in
     other orders, through GELU's largest slope) plus 1e-6;
  5. K3 flash attention forward (CUDA) vs its plain version, bf16 and
     f32: kv_mask with a fully padded row, a bias at each of
     [1|b, 1|h, t, t], causal, dropout, and q/k/v read in place from a
     fused qkv projection; out and lse; every case again on scenes with
     the edges of the padded-key-tile skip (a row ending on a tile's first
     key, rows with whole padded tiles) and at a t that ends inside a
     128-row block, drawn from a generator of their own;
  5b. K1b LayerNorm backward (Triton) vs its plain version at the
     fine-tune's 16384 x 768 f32 and at row counts that fill no block;
  5c. K4a, K4b and K5, the flash backward (CUDA), vs their plain
     version, bf16 and f32, in every case of phase 5 plus a loss on the
     lse and the fine-tune's own case (fused qkv, dropout, key mask); dq,
     dk, dv and the bias's gradient at each broadcast; the key mask has
     the edges of the padded-key-tile skips, and dk, dv must be exactly
     zero at every padded key, dbias at every key all of a bias plane's
     replicas pad; every case again at a t that ends inside a
     128-row block, drawn from the boundary scenes' own generator;
  5e. K3, K4a, K4b and K5 at b*h = 65544 (batch 5462, 12 heads, t = 128,
     bf16, kv_mask, a [b, 1, t, t] and then a [b, h, t, t] bias) vs
     their plain versions under phase 5's and 5c's gates;
  5d. the Hopper bodies (K2 sm90, K3, K4a, K4b, K5, bf16; K6's split
     body) launched from 6 new host threads at once, each thread's first
     CUDA call a launch, the flash kernels at t = 128 and 512 in turn:
     every launch goes through and matches the same call made alone bit
     for bit;
  6. slice 1: warm the generation engine, serve concurrent greedy
     requests through the background loop, check K1/K6 launch counts
     (every K6 launch on its split body) and the logits; again with an
     int8 KV pool and with an f16 one (bench.py's configuration);
  14. the rest of the generation engine (after phase 6, on its model):
     (a) bench.py's prefix traffic with prefix caching + chunked prefill
     against both off (hit rate >= 0.8), (b) seven decoding lanes while
     a 900-token prompt arrives, chunking on and off (their streams
     equal), (c) a cut pool whose evicted prefixes spill to a host tier
     and come back (both restore paths), (d) speculation on a wired
     cycle model at GPT-2 small's widths (streams equal on and off),
     (e) speculation on random prompts; in every scene the served
     logits against the plain recompute and K1 / K6 launches exact,
     each comparison in timed windows taken in turns; a chunk, a
     decode and a verify step profiled with phase 10;
  7. slice 2: BERTClassifier at BERT-base's widths (bf16, flash) behind
     InferenceModel, predict calls from 4 threads at t = 128 and 512;
     sequences/s, valid tokens/s, latency p50 per (batch, t); K1/K2/K3
     launch counts exact per forward, every K2 launch on its sm90 body;
     logits vs the plain recompute; an
     f32 model at a tight tolerance; the same traffic with
     attn_impl="einsum" as a comparison line;
  8. slice 3: BERTClassifier at BERT-base's widths fine-tuned through
     `Estimator.from_torch(...).fit(...)` (bf16, flash, dropout 0.1,
     Adam 2e-5, batch 32 x t = 512): the first step's gradients through
     the kernels vs the plain path (bf16, and an f32 model at a tight
     gate), 2 warm-up and 10 timed steps in one `fit`, step p50 (CUDA
     events recorded as each step is queued), tokens/s,
     `bert_train_mfu`, launches per step exact, every K2 launch on its
     sm90 body, an evaluate call that launches no backward kernel;
  9. the learnable-bias path: a 2-block encoder at BERT-base widths fed
     a `RelativePositionBias` [1, 12, 512, 512], trained a few steps,
     K5 launched once per attention layer per step, the bias table's
     gradient vs the plain path;
  12. BERT-base fine-tuning (phase 8's model and batch) with the rest of
     the fit surface: (a) the first step under remat with each policy
     (None, "dots", "dots_all") gives no-remat's gradients within the
     spread of two no-remat steps (0 under PyTorch's deterministic
     algorithms, which (a) and (e) run with; the default algorithms'
     spread is reported), and leaves the dropout generator in
     no-remat's state; (b) launches per step exact (K1 49, K1b 25, K2
     24 on its sm90 body, K3 24, K4a 12, K4b 12 under remat); (c) peak
     card memory and fit step p50 per remat configuration at batch 32
     and 128 x t = 512, the peaks over the weights ordered None <
     "dots" <= "dots_all" < off; (d) AdamWeightDecay(2e-5) under
     Warmup(5, 20) over a 20-step fit: each step's lr within 4 f32 ulps
     of optax's f32 formula evaluated on the host (its distance from the
     f64 value reported), and the lr-0 first step leaves the weights
     bitwise; (e) a 2 x
     10-step fit with model_dir under a temp dir that a fault plan kills
     once (train.step, epoch 2 step 5): one retry, the final weights
     those of an uninterrupted fit within (a)'s spread; the checkpoint's
     bytes, its save on the critical path sync and background, the
     background write and the load timed; `resume_latest` on a fresh
     Estimator restores epoch 2 bit for bit (about 5 GB written in all,
     at most 2 versions on disk at once, the directory removed after);
     (f) `validation_data` gives one `val_summary` row per epoch equal
     to `evaluate` after it (1e-6 relative); run after phase 9, before
     phase 11, its step profiles with phase 10's;
  11. recommendation training through `Estimator.fit` from the DEVICE
     data store: NeuralCF at bench.py's cell (200,000 users, 50,000
     items, embeddings 64, MLP 256-256-128, batch 65536 x 30 steps, Adam
     1e-3), gated (a) card vs the port on the CPU at f32 over 3 steps,
     (b) DEVICE vs DRAM per-step losses at bf16, (c) the loss falling
     over 3 epochs, (d) a second fit hitting the cache; samples/s through
     `fit` beside a plain PyTorch loop over 30 batches on the card
     (`estimator_vs_raw`) and the DRAM store, a fit step by device op,
     the busy share and the bound; WideAndDeep at the MovieLens-1M
     layout of the reference's wide-n-deep notebook (batch 16384) and
     SessionRecommender at the JAX defaults (50,000 items, batch 4096),
     each under gate (a), with samples/s; `recommend_for_user` over
     10,000 pairs; no kernel of the other paths is launched (run after
     phase 12, before phase 10's profiles);
  13. Orca's data path (after phase 11, before phase 10's profiles;
     results under "data_path" in the line before the kernels line):
     (a) bench.py's NCF cell from `XShards.partition` into 7 dict shards
     (batches span shard edges) on the DRAM store, per-step losses
     within 1e-6 of the fit from the arrays, and under the DEVICE store
     streamed from the host with JAX's warning, no cache entry; (b)
     host-input prefetch depth 0 against 2 (pinned double buffering):
     losses bitwise equal under deterministic algorithms, samples/s
     through `fit` (best of 5 one-epoch windows, in turns, beside phase
     11's DRAM and DEVICE stores), the busy share from a profiled fit,
     the pinned ring's slots, bytes and waits; (c) the DISK_2 tier:
     losses bitwise those of the DRAM tier, the spill directory removed
     with the XShards, samples/s; (e) RMSprop, Adagrad and Adadelta under
     phase 11's gate (a) at their registry rates, a non-finite step
     leaving weights and optimizer state bitwise with no host read, and
     one-logit NCF fits with binary_crossentropy and mse whose loss
     falls; (f) a BatchNorm model's non-finite step on the DRAM and the
     DEVICE store leaving its running stats finite and its count
     unmoved, and the buffer snapshot's cost a step on ResNet-50's 53
     BatchNorm layers; no kernel launched in (a)-(c), (e), (f); (d)
     phase 8's BERT-base recipe fed XShards of 100/70/90/64/60 rows:
     launches per step K1 25, K1b 25, K2 12 (sm90), K3 12, K4a 12, K4b
     12, losses bitwise a dict-input fit's, step p50 beside phase 8's;
  15. the serving front end (after phase 13, before phase 10's profiles;
     results under "serving"): (a) bench.py's serving cell: NeuralCF at
     its widths (f32) behind InferenceModel(4, 512) and
     ServingServer(max_batch_size=64, batch_timeout_ms=2), 64
     per-record clients (2 s warm-up, 6 s timed), then 4 pre-batched
     clients x 512 records for 3 s: records/s, p50 / p99, queue wait
     and predict p50 read through GET /metrics (bench.py's 40 ms
     queue-wait check reported), the card's busy share over a profiled
     second; no client error, 64 served rows within 1e-5 of a direct
     predict, no kernel launched; (b) phase 7's BERT-base (bf16, flash)
     over /predict: 16 per-record clients at t = 128, then 4
     pre-batched clients of 32 x 512: sequences/s and p50 / p99 beside
     phase 7's, launches exact (K1 25, K2 12 on its sm90 body, K3 12 a
     forward, forwards = the /stats batches), logits within 0.05 of a
     direct predict; (c) phase 6's f32 engine behind /generate: 12
     greedy requests (prompts 32-512, 64 new tokens) through the port's
     InputQueue, each stream equal to engine.generate of its prompt, the
     done lines and X-Request-Id right, K1 25 a forward and K6 12 a
     decode step (split body), logits within 1e-3 of the plain
     recompute, tokens/s over HTTP beside phase 6's; (d) 400 on a
     malformed body, 413 past max_context, a serving.admission refusal
     answering 503 with the Retry-After the decode steps give, then the
     stream through a RetryPolicy, and a poisoned lane among 4 evicted
     alone (its neighbours' streams and a fifth request unchanged); (e)
     the NeuralCF of (a) saved and served through
     start_serving(ServingConfig(modelPath=...)) within 1e-5 of
     ZooModel.predict, its port closed after stop_serving;
  16. int8 weight serving (after phase 15; results under
     "int8_serving"): (a) phase 7's BERT-base behind
     InferenceModel(4, 32).load_module(model, quantize=True):
     quantize_stats equal JAX's for the same tree, the bytes resident on
     the card beside them, sequences/s and predict p50 at phase 7's
     shapes in turns with the bf16 model, peak card memory over a 32 x
     512 predict for both, launches exact (K1 25, K2 12 on its sm90
     body, K3 12 a forward), logits within 0.05 of the plain recompute
     with the same dequantized weights, top-1 agreement with bf16
     reported; (b) ResNet-50 (ImageClassifier, 2 classes) int8 and bf16
     in turns at 32 x 224^2: bytes, images/s, logits within 0.05 of the
     same network with the dequantized weights as plain parameters, no
     kernel of ours launched; (c) a saved NeuralCF at bench.py's widths
     served by start_serving with quantize: true, /predict within 1e-5
     of a direct quantized predict;
  17. the image zoo (after phase 16; results under "image_zoo"), no
     kernel of ours launched in any scene: (a) ResNet-50 fine-tuning
     (BASELINE config #3, ImageClassifier("resnet-50", 2), bf16, Adam)
     through model.estimator(...).fit on synthetic 224^2 images with a
     learnable label, at batch 128 and 256 from the arrays (3 epochs of
     3 steps; the epoch loss falls) and at 256 from ImageSet.from_arrays
     through a seeded crop / flip / normalize chain: step p50 (CUDA
     events), images/s, the card's busy share, peak memory and MFU (3 x
     the forward FLOPs of the convs' and the head's shapes, of 989
     TFLOP/s); predict after fit equals an eval-mode forward; (b) with
     TF32 off, an f32 ResNet-50 takes 2 SGD steps at batch 8 on the card
     and on the port's CPU path from the same weights: per-step losses,
     the first step's update and the running statistics within 1e-3
     relative; predict equals an eval-mode forward; save_model ->
     load_model bitwise, buffers included; (c) Inception-v1, MobileNetV2
     and VGG-16 at full width, 5 steps at batch 64: finite losses,
     images/s; (d) SSD and Faster R-CNN at JAX's defaults, 5 steps on a
     repeated batch: losses finite and falling, detect (host NMS) at
     most max_det boxes an image, inside [0, 1];
  18. the rest of the model zoo (after phase 17; results under
     "zoo_rest" and on a `zoo_rest` line), TF32 off: (a) BERT-base
     (dropout off) loaded from a seeded `pytorch_model.bin` through
     `est.set_params(lambda p: load_bert_pretrained(p, dir))`: every
     encoder tensor bitwise the file's, the head kept, export -> re-read
     -> load bitwise; 3 fine-tune steps at 32 x 128 with launches per
     step exact (K1 25, K1b 25, K2 12 on its sm90 body, K3 12, K4a 12,
     K4b 12), the first step's loss within 0.1 of an f32 CPU recompute;
     (b) TextClassifier at the JAX defaults (20 classes), cnn, lstm and
     gru: 2 epochs of 4 steps at batch 128, steps/s and sequences/s,
     logits within 1e-4 of the CPU path; (c) KNRM at the JAX defaults:
     4 steps at batch 256, NDCG@3, NDCG@5 and MAP over an XShards of 64
     queries x 10 candidates equal to the CPU path's, scores within
     1e-4; (d) Seq2Seq (hidden 64, 2 layers, dense bridge; LSTM and GRU)
     fit, `infer` of 24 steps within 1e-4 of the CPU path;
     AnomalyDetector (8, 32, 15) unrolled by 24: fit, predictions within
     1e-4 of the CPU path, `detect_anomalies` 5 indices; (e) the VAE at
     the JAX defaults: 2 epochs at batch 128, `aux_loss` in
     train_summary, `generate(16)` in [0, 1], `reconstruct` equal on two
     calls under deterministic algorithms (cuDNN's transposed convs sum
     in a varying order otherwise: the spread is reported); (f) GANEstimator on the 2-d Gaussian of JAX's GAN test: the
     first batch's update within 1e-5 of the CPU step on the same noise,
     then 20 epochs; (g) InferenceEstimator.from_saved_model on (b)'s
     GRU classifier: predict bitwise the model's own, accuracy
     Estimator.evaluate's, fit raising; no kernel of ours launched in
     (b)-(g);
  19. the Keras-style API (after phase 18; results under "keras" and on
     a `keras` line): (a) the README NCF toy (BASELINE config #1: two
     Inputs, Embedding, Flatten, Concat, Dense relu 256-256-128,
     Dense(2, "softmax")) at bench.py's NCF widths (200,000 x 50,000 x
     64) through `Estimator.from_keras` at batch 16384, built on its
     first batch, 3 epochs of 6 steps (the epoch loss falls) and once
     through `model.fit`; samples/s, peak memory, host against card
     time a step; no kernel of ours; (b) a Keras `BERT` layer at
     BERT-base's widths, `LayerNormalization` and `Dense(2)` on its
     pooled output, compiled and fit at 32 x 128 (dropout 0.1):
     launches per step exact (K1 26, K1b 26, K2 12 on its sm90 body,
     no flash: einsum below t = 4096, as JAX), the Keras BERT forward
     bitwise the port's `TransformerEncoder` on the same weights; (c) a
     Keras `TransformerLayer` at GPT-2 small's widths, `Select(1, -1)`
     and `Dense(2)`, fit at 2 x 4096 (flash): launches per step exact
     (K1 25, K1b 25, K2 12, K3 12, K4a 12, K4b 12), one eval forward's
     logits within 0.05 of max(1, |ref|) of the plain versions on the
     same weights; (d) test_keras_api.py's conv / BatchNorm / pool
     stack, an LSTM / GRU / Bidirectional / TimeDistributed stack and a
     ConvLSTM2D graph fit on the card, each eval output within 1e-4 of
     max(1, |CPU|) of the same weights on the CPU in f32, under
     deterministic algorithms; no kernel of ours in (d); step p50, peak
     memory and host against card time a step for (a)-(c);
  20. the model importers (after phase 19; results under "importers"
     and on an `importers` line), fixtures written here from seeds, f32,
     TF32 off, no kernel of ours launched: (a) BERT-base written as a
     static-shape ONNX graph (`bert_onnx`), imported through
     `Estimator.from_onnx`, its logits within 2e-4 of max(1, |CPU|) of
     the native BERTClassifier on the CPU on 4 rows, fit 1 + 5 Adam steps
     at 32 x 128 (steps/s, samples/s, step p50, peak memory, host against
     card time a step), served through `InferenceModel.load_module`
     (sequences/s over 20 batches of 32 x 128); (b) a TF1 frozen
     MobileNet v1 1.0/224 (`mobilenet_v1_graphdef`) served through
     `InferenceModel.load_tf` at 64 x 224^2 NHWC (images/s, busy share);
     (c) BVLC CaffeNet's deploy net (`caffenet_model`, 61M weights)
     through `Net.load_caffe` at 64 x 3 x 227^2 (decode time, images/s);
     (b) and (c) within 1e-3 of max(1, |CPU|) of the same net on the CPU
     on two images;
  21. Chronos AutoTS, BASELINE config #4's path (after phase 20; results
     under "chronos" and on a `chronos` line), f32, TF32 off, no kernel
     of ours launched, on a synthetic nyc-taxi-shaped series (10,320
     half hours, daily and weekly seasons, standardized with numpy,
     rolled at lookback 24 and horizon 1): (a) init_orca_context
     ("local") gives the card and a second call the same, "yarn" raises
     ValueError, stop_orca_context resets, an explicit call replaces
     the implicit start of OrcaContext.device; (b) the TCN (48 x 3,
     kernel 3), LSTM (64 x 2) and Seq2Seq (64 x 2) forecasters, the
     widest widths of AutoTS's default spaces: predictions on every
     window within 1e-5 of max(1, |CPU|) of the port on the CPU from the
     same weights, the first step's loss within 1e-5 and gradients
     within 1e-4 of each tensor's largest (dropout 0), 2 epochs of fit
     whose loss falls (step p50, samples/s, host against card time a
     step, busy share over a profiled epoch), save -> load bitwise;
     (c) AutoTSEstimator(model="lstm") with the default space
     (n_sampling 4, 2 epochs, batch 64): the trial configs equal the
     same search with the port on the CPU, the pipeline predicts as its
     best forecaster, save -> load bitwise; (d) SearchEngine
     (backend="device") with 4 Estimator.from_torch trials: one lease
     acquisition a trial call, no holder after, the winner's mse below
     0.7 var(y); (e) AutoEstimator.from_torch over 2 process workers:
     no worker initializes CUDA, the best model rebuilt here is on the
     card, equals the worker's export and predicts as it does on the
     CPU;
  22. the rest of Chronos and AutoML (after phase 21; results under
     "chronos_rest" and on a `chronos_rest` line), f32, TF32 off, no
     kernel of ours launched: (a) MTNet at JAX's defaults (4 memory
     chunks of 8 steps, widths 32, AR window 4) on phase 21's series in
     40-step windows: predictions on every window within 1e-5 of
     max(1, |CPU|) of the port on the CPU from the same weights, every
     row of the memory attention summing to 1 within 1e-6, the first
     step's loss within 1e-5 and gradients within 1e-4 (dropout 0), 2
     epochs at batch 64 whose loss falls, save -> load bitwise; (b) TCMF
     at DeepGLO's electricity shape (370 series of 25,968 hours,
     synthetic, from the seed) at its defaults, 4 epochs: the
     factorization's first Adam step within 1e-5 of the CPU's from the
     same state, each stage's fit wall, predict(24) global and hybrid
     within 1e-4 of max(1, |CPU|) of the same saved state on the CPU,
     fit_incremental on 24 new hours; (c) on the host beside the card:
     AEDetector (roll 24, JAX's defaults) trained on the card, its
     anomaly indexes equal to the CPU's from its weights,
     ThresholdDetector, ARIMAForecaster and AutoTSEstimator(model=
     "arima") (3 samples, m = 48) with its TSPipeline, AutoXGBRegressor
     on 24 lags; (d) DPGANSimulator at DoppelGANger's WWT shape (550
     days, 1 feature, 3 attributes; 8,192 series, 2 epochs at batch
     128): the first adversarial step's updates within 1e-4 of each
     tensor's largest CPU update on the same noise, generate inside the
     training range, save -> load -> generate bitwise.  Prophet,
     XShardsTSDataset and DBScanDetector need pandas or sklearn, which
     the card machine lacks: the CPU tests hold them;
  23. the observability planes (after phase 22; results under
     "observability" and on an `observability` line), the settings
     put back to their defaults at its end: (a) BERT-base (bf16 flash)
     fine-tuned through `Estimator.from_torch(...).fit` at 32 x 128, 2
     epochs of 16 steps with 4 validation steps each, with the event
     sink in a temp dir, `goodput_sample_every` 4, `watchdog_deadline_s`
     120, the nonfinite sentinel on and `hardware_peak_flops` the card's
     dense bf16 peak: 2 `train_epoch` and 2 `validation_epoch` events,
     every `spmd.step` span under `estimator.epoch` under
     `estimator.fit`, the `train_step` ledger at one signature and one
     call a step, the goodput buckets within 5% of the clock's wall,
     `memory_device_allocated_bytes` at least the parameters' bytes, the
     launches exactly the fine-tune's per step (K1 25, K1b 25, K2 12, K3
     12, K4a 12, K4b 12) and per validation forward (K1 25, K2 12, K3
     12); the same fit again with no sink and the sampled fences at
     10^6 steps ("off"), and with the sentinel and watchdog off too
     ("bare"), in turns off, bare, bare, off, on (the median over its
     fits of each setting's mean step wall in epoch 2, the goodput
     ratio, the ledger's mfu_ratio), then one more epoch of the gated
     fit under a device trace (the card's busy share beside that
     epoch's goodput ratio); (b) one step with the classifier's
     bias set to NaN: skipped, one `nonfinite_step` bundle whose first
     named tensor is that bias and whose `torch` section names the
     card; (c) 16 greedy requests x 32 tokens through the
     GenerationEngine on phase 6's model, the lifecycle log on, off,
     off, on: every finished record's queue wait <= TTFT <= e2e, its
     tokens and finish reason the stream's, the same streams in every
     turn, `decode` at one signature, K1 25 per forward and K6 12 per decode step exactly
     (tokens/s of each turn); (d) `flight_recorder.dump("smoke")` read
     back holds every key of `flight_recorder.BUNDLE_KEYS`; the host's
     microseconds a call of a span, an event, a flight record, a
     lifecycle token and a ledgered call, the sink off and on in turns;
  24. the serving-side planes on phase 6's model behind ServingServer:
     (a) SLO targets, the metrics history (0.25 s), the spool and the
     default exemplars armed; 16 greedy requests (prompts 32-256, 32
     new tokens) over the port's client, each under a client
     traceparent, a third with X-Tenant: each stream = the engine's
     greedy stream of its prompt, every finished record's blame phases
     sum to its e2e within `blame_tolerance`, /slo judged = the
     requests, every span of a request in the client's trace and the
     response's traceparent of that trace, /timeline and ?fleet=1 valid
     (`scripts/check_timeline_schema.py::validate_timeline`),
     /debug/requests and a dossier, a rate of `generation_tokens_total`
     in /metrics/history with >= 2 points, /metrics?fleet=1 the exact
     sum of the local and spooled counters, `decode` at one signature,
     K1 25 per forward and K6 12 per decode step, all `split`; (b) an
     unmeetable TTFT target, `slo_shed_attainment` 0.99 and
     `slo_shed_min_queue` 2: a burst of 12 gets 503s with the shedder's
     message, Retry-After > 0 and the request's traceparent echoed; no
     503 with it disarmed; (c) tokens/s with the planes armed and
     disarmed (on, off, off, on), the recorder's microseconds and bytes
     a sample (its CRC's share), a spool write's, a /timeline export's;
     (d) a bundle on demand with a history tail, exemplars and a valid
     timeline sibling;
  25. serving scale-out and the durable data plane: (a) the native
     library (`native/`, g++) built and loaded, crc32c's known answer,
     crc32c of 1 MiB, tfrecord_scan and csv_to_f32 equal to their plain
     versions, and a metrics-history sample's CRC32C native and plain;
     (b) phase 7's BERT-base saved and served from `WorkerPool` worker
     processes on the card behind ServingServer over /predict, with 1
     worker and with 2 (sequences/s, p50/p99), the logits within 0.05
     of the in-process model's, each worker's K1 25 / K2 12 / K3 12 a
     forward read back over its pipe, its CUDA context (nvidia-smi, or
     the worker's own bytes on the card), a worker killed under its
     batch failing that batch alone; (c) two GPT-2 small engines behind
     `ReplicaRouter` over /generate: streams equal to one engine's,
     served skew <= 0.3, K1 25 / K6 12 (split) per step summed over the
     replicas, one decode signature, replica-labeled /metrics rows and
     per-replica SLO rows, a drained router's 503 with Retry-After, a
     replica stopped mid-stream re-queuing its request under its id,
     tokens/s with 1 and 2 replicas; (d) records through
     `enqueue(stream=)` drained by `predict_consumer` over the pool and
     `generation_consumer` over an engine, each consumer killed holding
     leases: every record out once under its id, the outputs equal the
     back end's; a full backlog's 429 with Retry-After; a torn fsync
     truncated at the last good frame; (e) a `ModelRegistry` of two
     GPT-2 small versions (the second registered from a committed
     checkpoint, an uncommitted one refused): a hot swap under load with
     no request dropped, rollback, an A/B split within 4 sigma of its
     weights (JAX's picks), 0.25 shadow judged on the shadow side only,
     and two tenants under `run_open_loop` at twice the measured
     capacity, the free one (a bucket at a fifth of its offered rate)
     shed with 429 and Retry-After, the gold one's attainment recorded;
     (f) where `grpc` imports, protocol "both" answering over gRPC what
     it answers over HTTP (else printed as not run); a `scale_out` line;
  26. resilience and long context: (a) phase 7's BERT-base saved
     encrypted (`write_model(encrypt_key=)`; the format, AZTE3 or
     AZTE2, printed), loaded through `InferenceModel.load_model(
     decrypt_key=)` with outputs bitwise those of the model saved in the
     clear and K1 25 / K2 12 / K3 12 a forward, a wrong key raising
     JAX's error, and `start_serving` with `decryptKeyEnv` and 2 worker
     processes on the card serving it over /predict within 0.05 of the
     in-process model; (b) `ElasticTrainingDriver` over a process
     member (this script, `--elastic-member`) fine-tuning BERT-base at
     32 x 128 for 3 epochs of 8 steps under deterministic algorithms,
     a committed checkpoint an epoch: an uninterrupted run, then one
     whose member is SIGKILLed after step 11, crashes in the middle of
     the epoch-2 checkpoint's write (the torn save skipped), stalls at
     step 18 (found past its 10 s heartbeat deadline) and ends: weights
     and every epoch's per-step losses bitwise the uninterrupted run's,
     the attempt ledger as stated, "nan" at step 5 skipped with the
     weights unchanged, the member's K1 25, K1b 25, K2 12, K3 12, K4a 12
     and K4b 12 a step, and a spent restart budget raising
     `ElasticRestartExceeded`; (c) two ranks sharing the card (this
     script, `--ring-rank`, gloo with a host-staged exchange) under
     `init_orca_context(cluster_mode="distributed", mesh_shape={"sp":
     2})` at b 1, h 8, d 64, bf16, t 16384: `ring_self_attention`
     forward and backward non-causal, causal, with a kv_mask padding the
     last 1000 keys, and with dropout 0.1 and a learnable [1, 1, t, t]
     bias, each within 0.03 of the largest magnitude of the unsharded
     kernels' result on the same card, K3 (and K4a, K4b, K5 with the
     bias) once a live ring step, dropout moving the output; one SGD
     step of a MultiHeadAttention with attn_impl "ring" against "flash"
     (losses within 1e-3); then the unsharded K3, K4a, K4b and K5 at
     t = 16384 with the kv_mask and the bias against their plain
     versions one head at a time under phase 5's and 5c's gates, and
     timed beside their bounds and SDPA's; (d) two GPT-2 small replicas
     from `ReplicaRouter.build` with `kv_host_tier_bytes` 1 GiB and
     phase-aware routing: one host tier object, replica 1 restoring the
     6 blocks of a prompt replica 0 spilled with its stream one
     engine's, K6 12 a decode step, all `split`, and 16 routed greedy
     streams equal to one engine's; a `resilience` line;
  10. device times of phases 2-5c (profiler), one decode step, one BERT
     forward, one fine-tune step (t = 512, batch 32), one
     learnable-bias step and one batch-32 step of each of phase 12's
     remat configurations by device op, after the timed phases.
The line before the last is a JSON object of every kernel's numbers;
the last line is {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.  Without a
card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from functools import lru_cache, partial

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside
#: the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
D_MODEL = 768


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi(query: str) -> str:
    """One `nvidia-smi --query-gpu=<query>` line for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def clocks(when: str, start: float) -> None:
    """Print the card's clocks, power draw and temperature beside a
    timing window (a card below its peak clocks times slower), and the
    seconds since `start` (a perf_counter reading)."""
    print(f"clocks {when} ({time.perf_counter() - start:.1f} s in): " + smi(
        "clocks.sm,clocks.mem,power.draw,temperature.gpu,"
        "clocks_throttle_reasons.active"), flush=True)


def cuda_ms(fn, iters: int = 50, warm: int = 5) -> float:
    """Time per call of `fn` over `iters` back-to-back calls, between
    two CUDA events (host launch gaps included)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50):
    """(device ms per call, {device op name: ms per call}, profile) of
    every kernel, copy and fill `fn` puts on the card, from a
    torch.profiler trace: per op name, the median duration times the
    launches per call (a median, because single microsecond-long
    launches vary; the launches per call rounded to a whole number,
    because a trace can drop events).  The total is None when the trace
    holds no whole launch per call, and the caller then keeps its
    CUDA-event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    runs = {}
    for e in prof.events():
        # a GPU user annotation (the range of `Optimizer.step`) spans
        # kernels counted on their own
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            runs.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    per = {name: statistics.median(d) * round(len(d) / iters)
           for name, d in runs.items()}
    total = sum(per.values())
    return (total if total > 0 else None), per, prof


def call_times(shape: dict, fns: dict) -> dict:
    """Per-call time of each of `fns` ({"ms" | "plain_ms" |
    "library_ms": fn}) between CUDA events, host launch gaps included,
    into shape["call_ms" | "plain_call_ms" | "library_call_ms"]; the
    functions are kept for `device_times`, which runs the profiler after
    the timed serving."""
    for key, fn in fns.items():
        shape[key.replace("ms", "call_ms")] = cuda_ms(fn)
    shape["_fns"] = fns
    return shape


def device_times(shape: dict) -> None:
    """shape[key] = device time per call of each kept function, from the
    profiler, or its CUDA-event time where the trace shows no device
    time; shape["ms_from"] says which."""
    fns = shape.pop("_fns")
    src = "profiler"
    for key, fn in fns.items():
        dev, _, _ = device_ms(fn, iters=20)
        if dev is None:
            src = "cuda_events"
        shape[key] = dev if dev is not None \
            else shape[key.replace("ms", "call_ms")]
    shape["ms_from"] = src


def k2_bodies(label: str, counts: dict) -> dict:
    """K2's launches per body since the last reset, checked: every launch
    of a bf16 path took the Hopper (sm90) body, none the cp_async one."""
    from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
        fused_dense_gelu,
    )
    bodies = dict(fused_dense_gelu.launches_by_body)
    check(bodies["sm90"] == counts["fused_dense_gelu"]
          and bodies["cp_async"] == 0 and bodies["f32"] == 0,
          f"{label}: K2 launches by body {bodies}; all "
          f"{counts['fused_dense_gelu']} must take the sm90 body")
    return bodies


def bound(n_bytes: float, n_flops: float, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak for their type (f32 by default)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: K1
# ----------------------------------------------------------------------

def phase_layer_norm(torch, gen):
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (
        layer_norm_fwd,
        layer_norm_fwd_reference,
    )
    shapes = []
    # rows 8: the decode step at 8 lanes; rows 1024: the largest
    # prefill bucket; rows 16384: a BERT batch of 32 x 512
    for rows in (8, 1024, 16384):
        x = torch.randn(rows, D_MODEL, generator=gen, device="cuda")
        scale = 1 + 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        got = layer_norm_fwd(x, scale, bias, 1e-6)
        want = layer_norm_fwd_reference(x, scale, bias, 1e-6)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        # same formula in f32, another reduction order: 1e-5 absolute
        check(err <= 1e-5, f"K1 rows={rows}: max abs err {err} > 1e-5")
        n_bytes = 2 * rows * D_MODEL * 4 + 2 * D_MODEL * 4 + 2 * rows * 4
        b_ms, b_by = bound(n_bytes, 8 * rows * D_MODEL)
        shape = dict(name="layer_norm_fwd", rows=rows, d=D_MODEL,
                     max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
        # partial, not lambda: the functions run again after the loop
        # and must keep this iteration's tensors
        shapes.append(call_times(shape, dict(
            ms=partial(layer_norm_fwd, x, scale, bias, 1e-6),
            plain_ms=partial(layer_norm_fwd_reference, x, scale, bias,
                             1e-6),
            library_ms=partial(F.layer_norm, x, (D_MODEL,), scale, bias,
                               1e-6))))
        print(f"K1 layer_norm_fwd rows={rows} d={D_MODEL}: max_abs_err="
              f"{err:.3e}; per call with launch gaps: kernel "
              f"{shape['call_ms']:.5f} ms, plain {shape['plain_call_ms']:.5f}"
              f" ms, F.layer_norm {shape['library_call_ms']:.5f} ms; bound "
              f"{b_ms:.5f} ms ({b_by})", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 3: K6
# ----------------------------------------------------------------------

#: K6's pools: (label, pool dtype or None for int8, quantized)
PAGED_POOLS = (("f32", "float32", False), ("int8", None, True),
               ("f16", "float16", False), ("bf16", "bfloat16", False))
#: seed of the f16, bf16 and unaligned K6 scenes, drawn from a generator
#: of their own (the f32 and int8 scenes, and every later phase's
#: inputs, stay as they were)
PAGED_SEED = 3


def paged_scene(torch, gen, quantized: bool, pool_dtype=None):
    """A serving-shaped decode scene: 8 lanes, 12 heads of 64, blocks
    of 16, 64-block tables (1024 positions); ragged ctx_len including
    an empty lane and a full 1023-token lane; garbage everywhere past
    ctx_len.  The pool is f32 (rounded to `pool_dtype` when given), or
    int8 with per-slot scales."""
    from analytics_zoo_tpu_torch.serving.generation.kv_cache import (
        quantize_kv_tokens,
    )
    S, H, D, BS, MB = 8, 12, 64, 16, 64
    nb = S * MB + 1
    ctx = [0, 1023, 1, 16, 100, 517, 800, 255]
    k_pool = torch.randn(nb, BS, H, D, generator=gen, device="cuda")
    v_pool = torch.randn(nb, BS, H, D, generator=gen, device="cuda")
    perm = 1 + torch.randperm(nb - 1, generator=gen, device="cuda")
    tables = torch.zeros(S, MB, dtype=torch.int32, device="cuda")
    for s, c in enumerate(ctx):
        used = -(-c // BS)
        tables[s, :used] = perm[s * MB:s * MB + used].to(torch.int32)
    sc = dict(q=torch.randn(S, H, D, generator=gen, device="cuda"),
              new_k=torch.randn(S, H, D, generator=gen, device="cuda"),
              new_v=torch.randn(S, H, D, generator=gen, device="cuda"),
              k_pool=k_pool, v_pool=v_pool, block_tables=tables,
              ctx_len=torch.tensor(ctx, dtype=torch.int32, device="cuda"),
              k_scale=None, v_scale=None)
    if quantized:
        sc["k_pool"], sc["k_scale"] = quantize_kv_tokens(k_pool)
        sc["v_pool"], sc["v_scale"] = quantize_kv_tokens(v_pool)
    elif pool_dtype is not None:
        sc["k_pool"] = k_pool.to(pool_dtype)
        sc["v_pool"] = v_pool.to(pool_dtype)
    return sc, ctx


def sdpa_yardstick(torch, sc):
    """One library path computing the same function: gather + dequant
    + concat the new token + scaled_dot_product_attention with a mask
    (timed only; the port never calls it)."""
    import torch.nn.functional as F
    q = sc["q"]
    S, H, D = q.shape
    nb, bs = sc["k_pool"].shape[:2]
    tok = (sc["block_tables"].long()[:, :, None] * bs
           + torch.arange(bs, device="cuda")).reshape(S, -1)
    k = sc["k_pool"].reshape(nb * bs, H, D)[tok].float()
    v = sc["v_pool"].reshape(nb * bs, H, D)[tok].float()
    if sc["k_scale"] is not None:
        k = k * sc["k_scale"].reshape(-1)[tok][:, :, None, None]
        v = v * sc["v_scale"].reshape(-1)[tok][:, :, None, None]
    k = torch.cat([k, sc["new_k"][:, None]], 1).transpose(1, 2)
    v = torch.cat([v, sc["new_v"][:, None]], 1).transpose(1, 2)
    c = tok.shape[1]
    col = torch.arange(c + 1, device="cuda")
    mask = (col[None] < sc["ctx_len"][:, None].long()) | (col[None] == c)
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask[:, None, None])[:, :, 0]


def paged_body(name, *args, k_scale=None, v_scale=None):
    """K6's body `name` called past the wrapper on the wrapper's
    operands: a comparison, not counted."""
    import torch

    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import _launch
    out = torch.empty(args[0].shape, device="cuda")
    check(_launch(name, *args, k_scale, v_scale, out) == 0,
          f"K6 {name} body: launch failed")
    return out


def phase_paged(torch, gen):
    """K6 on f32, int8, f16 and bf16 pools: the body the wrapper picks
    (split), and the first design's body (rows) on the same operands,
    each against the plain version; then a pool whose base is not
    16-byte aligned, which the wrapper sends to the rows body."""
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
        paged_decode_reference,
    )
    shapes = []
    pgen = torch.Generator(device="cuda")
    pgen.manual_seed(PAGED_SEED)
    for label, dtype_name, quantized in PAGED_POOLS:
        pool_dtype = None if dtype_name is None else getattr(torch,
                                                             dtype_name)
        own = label in ("f32", "int8")
        sc, ctx = paged_scene(torch, gen if own else pgen, quantized,
                              None if own else pool_dtype)
        args = (sc["q"], sc["new_k"], sc["new_v"], sc["k_pool"],
                sc["v_pool"], sc["block_tables"], sc["ctx_len"])
        kw = dict(k_scale=sc["k_scale"], v_scale=sc["v_scale"])
        before = dict(paged_decode.launches_by_body)
        got = paged_decode(*args, **kw)
        rows = paged_body("rows", *args, **kw)
        want = paged_decode_reference(*args, **kw)
        lib_out = sdpa_yardstick(torch, sc)
        torch.cuda.synchronize()
        taken = [b for b, c in paged_decode.launches_by_body.items()
                 if c != before[b]]
        check(taken == ["split"], f"K6 {label}: took the body {taken}, "
              "expected split")
        err = float((got - want).abs().max())
        rows_err = float((rows - want).abs().max())
        # both sides read the same pool values (f16 and bf16 upcast
        # exactly, int8 times the same scales), so the pool's rounding
        # is common to both and only f32 summation order is left: the
        # softmax summed online in another order (per-group and
        # per-chunk partial states merged) over up to 1024 columns,
        # 1e-4 absolute per element, as for f32
        check(err <= 1e-4 and rows_err <= 1e-4,
              f"K6 {label}: max abs err split {err}, rows {rows_err} > 1e-4")
        check(torch.equal(got[0], sc["new_v"][0])
              and torch.equal(rows[0], sc["new_v"][0]),
              f"K6 {label}: a ctx_len 0 lane must return exactly new_v")
        lib_err = float((lib_out - want).abs().max())
        S, H, D = sc["q"].shape
        item = sc["k_pool"].element_size()
        n_tok = sum(ctx)
        n_bytes = (n_tok * H * D * 2 * item + (n_tok * 8 if quantized
                                               else 0)
                   + 4 * S * H * D * 4 + sc["block_tables"].numel() * 4
                   + S * 4)
        b_ms, b_by = bound(n_bytes, n_tok * H * 4 * D)
        shape = dict(name="paged_decode", pool=label, S=S, h=H, d=D,
                     bs=16, max_blocks=64, ctx_len=ctx, body="split",
                     max_abs_err=max(err, rows_err), split_max_abs_err=err,
                     rows_max_abs_err=rows_err,
                     library_max_abs_err=lib_err, bound_ms=b_ms,
                     bound_by=b_by)
        # the design's floor: the same tables with every lane at 16
        # tokens, one chunk each (a launch's fixed chain of round trips)
        floor = (*args[:6], torch.full_like(sc["ctx_len"], 16))
        shapes.append(call_times(shape, dict(
            ms=partial(paged_decode, *args, **kw),
            plain_ms=partial(paged_decode_reference, *args, **kw),
            library_ms=partial(sdpa_yardstick, torch, sc),
            rows_ms=partial(paged_body, "rows", *args, **kw),
            floor_ms=partial(paged_decode, *floor, **kw))))
        print(f"K6 paged_decode pool={label} S={S} h={H} d={D} "
              f"bs=16 MB=64 ctx={ctx}: max_abs_err split={err:.3e} rows="
              f"{rows_err:.3e} (gather+sdpa {lib_err:.3e}); per call with "
              f"launch gaps: kernel {shape['call_ms']:.5f} ms, rows body "
              f"{shape['rows_call_ms']:.5f} ms, plain "
              f"{shape['plain_call_ms']:.5f} ms, gather+sdpa "
              f"{shape['library_call_ms']:.5f} ms; bound {b_ms:.5f} ms "
              f"({b_by})", flush=True)
    # a pool view whose base is 2 bytes past an aligned one: no bulk
    # copy reads it, so the wrapper takes the rows body
    sc, ctx = paged_scene(torch, pgen, False, torch.float16)
    flat = torch.empty(sc["k_pool"].numel() + 1, dtype=torch.float16,
                       device="cuda")
    k_off = flat[1:].view(sc["k_pool"].shape)
    k_off.copy_(sc["k_pool"])
    args = (sc["q"], sc["new_k"], sc["new_v"], k_off, sc["v_pool"],
            sc["block_tables"], sc["ctx_len"])
    before = dict(paged_decode.launches_by_body)
    got = paged_decode(*args)
    want = paged_decode_reference(*args)
    torch.cuda.synchronize()
    taken = [b for b, c in paged_decode.launches_by_body.items()
             if c != before[b]]
    err = float((got - want).abs().max())
    check(taken == ["rows"] and err <= 1e-4,
          f"K6 unaligned f16 pool: body {taken} (expected rows), max abs "
          f"err {err}")
    print(f"K6 paged_decode unaligned f16 pool: rows body, max_abs_err="
          f"{err:.3e}", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 4: K2
# ----------------------------------------------------------------------

def phase_fused_dense(torch, gen):
    from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
        _launch,
        dense_bias_gelu_reference,
        fused_dense_gelu,
    )

    def cp_async_body(x, w, b, out):
        # the cp.async + mma.sync body on operands the sm90 body takes,
        # called past the wrapper: a comparison, not counted
        check(_launch("cp_async", x, w, b, out) == 0,
              "K2 cp_async body: launch failed")
        return out

    shapes = []
    # m = 8 x 128 and 32 x 512: BERT fc1 at the served batches; m = 100:
    # a ragged edge in every dimension but k; bf16 (1000, 768, 1000): m
    # and n no multiple of the sm90 body's 128 x 256 tile; bf16 (1000,
    # 770, 1000): k % 8 != 0, which TMA cannot read (the cp_async body)
    for m, k, n, dtypes in ((8 * 128, 768, 3072, "both"),
                            (32 * 512, 768, 3072, "both"),
                            (100, 768, 3072, "both"),
                            (1000, 768, 1000, "bf16"),
                            (1000, 770, 1000, "bf16")):
        for dtype in ((torch.bfloat16, torch.float32) if dtypes == "both"
                      else (torch.bfloat16,)):
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(n, k, generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            b = (0.5 * torch.randn(n, generator=gen, device="cuda")
                 ).to(dtype)
            before = dict(fused_dense_gelu.launches_by_body)
            got = fused_dense_gelu(x, w, b)
            want = dense_bias_gelu_reference(x, w, b)
            torch.cuda.synchronize()
            body = [name for name, c in fused_dense_gelu.launches_by_body
                    .items() if c != before[name]]
            expect = ("f32" if dtype == torch.float32
                      else "cp_async" if k % 8 or n % 8 else "sm90")
            check(body == [expect], f"K2 {dtype} ({m}, {k}, {n}) took the "
                  f"body {body}, expected {expect}")
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == torch.bfloat16:
                # both accumulate in f32 and cast once; a value on a
                # rounding boundary may land one bf16 ulp apart: 2^-7
                # relative.  Near zero, where the k products cancel, two
                # f32 sums in other orders differ by up to ~1e-6 of
                # sum |x w| (sum_gate's term), through GELU's largest
                # slope, 1.13; the magnitude is the gate's arithmetic, in
                # f32 (TF32 is off), not a kernel
                mag = torch.matmul(x.float().abs(), w.float().abs().t()) \
                    + b.float().abs()
                tol = 2.0 ** -7 * want.float().abs() + 1.13e-6 * mag + 1e-6
                del mag
            else:
                # f32 throughout, k = 768 products summed in another
                # order
                tol = torch.full_like(diff, 1e-4)
            check(bool((diff <= tol).all()),
                  f"K2 {dtype} ({m}, {k}, {n}): max abs err {err}, "
                  f"beyond its tolerance")
            item = x.element_size()
            b_ms, b_by = bound((m * k + n * k + n + m * n) * item,
                               2 * m * k * n,
                               BF16_FLOPS if dtype == torch.bfloat16
                               else F32_FLOPS)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            shape = dict(name="fused_dense_gelu", dtype=name, m=m, k=k, n=n,
                         body=expect, max_abs_err=err, bound_ms=b_ms,
                         bound_by=b_by)
            wt = w.t()
            fns = dict(ms=partial(fused_dense_gelu, x, w, b),
                       plain_ms=partial(dense_bias_gelu_reference, x, w, b),
                       library_ms=partial(torch._addmm_activation, b, x, wt,
                                          use_gelu=True))
            if expect == "sm90":
                # the same operands on the earlier body, held to the same
                # gate and timed beside the sm90 body as cp_async_ms
                old = cp_async_body(x, w, b, torch.empty_like(got))
                torch.cuda.synchronize()
                check(bool(((old.float() - want.float()).abs() <= tol).all()),
                      f"K2 bf16 ({m}, {k}, {n}) cp_async body: beyond its "
                      f"tolerance")
                fns["cp_async_ms"] = partial(cp_async_body, x, w, b,
                                             torch.empty_like(got))
            shapes.append(call_times(shape, fns))
            print(f"K2 fused_dense_gelu {name} ({m}, {k}, {n}) {expect} "
                  f"body: max_abs_err="
                  f"{err:.3e}; per call with launch gaps: kernel "
                  f"{shape['call_ms']:.5f} ms, plain "
                  f"{shape['plain_call_ms']:.5f} ms, _addmm_activation "
                  f"{shape['library_call_ms']:.5f} ms"
                  + (f", cp_async body {shape['cp_async_call_ms']:.5f} ms"
                     if expect == "sm90" else "")
                  + f"; bound {b_ms:.5f} ms ({b_by})", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 5: K3
# ----------------------------------------------------------------------

def flash_scene(torch, gen, b, t, h, d, dtype, boundary=False):
    """q, k, v [b, t, h, d]; the same three read as strided thirds of
    one fused [b, t, 3*h*d] projection, as MultiHeadAttention reads them;
    a kv_mask with valid lengths uniform in [t/4, t] and batch 0 fully
    padded; a bias at each of the four broadcast shapes [1|b, 1|h, t, t];
    the dropout seed triple (seed, q offset, k offset).  `boundary` adds
    the edges of the padded-key skips (K4b's blocks of 128 keys, 64 per
    warpgroup; K3's and K4a's tiles of 64 keys): batch 1's last valid key
    is the first key of a block (of a warpgroup's half and a tile at t =
    128), batch 2 has two whole padded blocks (one valid key at t < 384:
    its other tiles are all padding)."""
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda"
                      ).to(dtype)
    fused = tuple(a.reshape(b, t, h, d) for a in qkv.split(h * d, dim=-1))
    lens = torch.randint(t // 4, t + 1, (b,), generator=gen, device="cuda")
    lens[0] = 0
    if boundary:
        lens[1] = 129 if t > 128 else 65
        lens[2] = t - 256 if t >= 384 else 1
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(
        torch.int32)
    biases = {f"{bb}x{hh}": 0.5 * torch.randn(bb, hh, t, t, generator=gen,
                                                device="cuda")
              for bb, hh in ((1, h), (b, 1), (b, h), (1, 1))}
    seed3 = torch.tensor([1234, 3, 7], dtype=torch.int32, device="cuda")
    return (q, k, v), fused, mask, biases, seed3, int(lens.sum())


def flash_variants(scene, b):
    """Phase 5's cases of one flash_scene: {label: ((q, k, v), kwargs)}:
    a kv_mask alone, with a bias at each broadcast, causal, dropout, q/k/v
    read in place from a fused qkv, and all of them together."""
    qkv, fused, mask, biases, seed3, _ = scene
    variants = {"mask": (qkv, dict(kv_mask=mask))}
    for shp, bias in biases.items():
        variants[f"bias[{shp}]+mask"] = (qkv, dict(kv_mask=mask, bias=bias))
    variants["causal+mask"] = (qkv, dict(kv_mask=mask, causal=True))
    variants["dropout0.1+mask"] = (qkv, dict(kv_mask=mask, seed3=seed3,
                                             dropout=0.1))
    variants["fused-qkv+mask"] = (fused, dict(kv_mask=mask))
    variants[f"fused-qkv+bias[{b}x1]+causal+dropout0.1+mask"] = (
        fused, dict(kv_mask=mask, bias=biases[f"{b}x1"], causal=True,
                    seed3=seed3, dropout=0.1))
    return variants


def check_flash_fwd(torch, scene, b, t, dtype, what="", extra=None):
    """Hold K3 against its plain version in every case of `scene`, and
    in the `extra` cases ({label: ((q, k, v), kwargs)}): out per
    element, lse to 1e-4, zeros on the fully padded batch row 0 where a
    case has the kv_mask.  Returns ({label: (out err, lse err)},
    {label: out err as a share of its tolerance})."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    errs, shares = {}, {}
    for label, (args, kw) in {**flash_variants(scene, b),
                              **(extra or {})}.items():
        out, lse = flash_fwd(*args, **kw)
        rout, rlse = flash_fwd_reference(*args, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - rout.float()).abs()
        e_out = float(diff.max())
        e_lse = float((lse - rlse).abs().max())
        if dtype == torch.bfloat16:
            # each side rounds the probabilities to bf16 (the kernel
            # unnormalized, the plain version normalized: up to 2^-8
            # relative each, so 2^-7 of sum_j p_j|v_j| between them) and
            # the output once (2^-7 of |out| between them); lse comes from
            # f32 scores either way
            mag, _ = flash_fwd_reference(
                *(a.float() for a in args[:2]), args[2].float().abs(), **kw)
            tol = 2.0 ** -7 * (rout.float().abs() + mag) + 1e-6
        else:
            # the same f32 arithmetic, the softmax summed online in
            # another order
            tol = torch.full_like(diff, 1e-4)
        share = float((diff / tol).max())
        check(share <= 1.0 and e_lse <= 1e-4,
              f"K3 {name} b={b} t={t}{what} {label}: out err {e_out} "
              f"({share:.3f} of its tolerance), lse err {e_lse} (tol 1e-4)")
        check("kv_mask" not in kw or bool((out[0] == 0).all()),
              f"K3 {name}{what} {label}: a fully padded row must give zeros")
        errs[label] = (e_out, e_lse)
        shares[label] = share
    return errs, shares


#: seed of the scenes that hold the flash kernels at the edges of their
#: padded-key-tile skip: drawn from a generator of their own, so that no
#: other phase's inputs change with them
BOUNDARY_SEED = 5


def phase_flash(torch, gen):
    """K3 at the BERT paths' shapes, timed on the `mask` case; then the
    skip's edges (flash_scene's `boundary` rows) in every case, at those
    shapes and at a t that ends inside a 128-row block."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )
    shapes = []
    h, d = 12, 64
    for b, t in ((8, 128), (32, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            scene = flash_scene(torch, gen, b, t, h, d, dtype)
            (q, k, v), _, mask, _, _, n_valid = scene
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            errs, shares = check_flash_fwd(torch, scene, b, t, dtype)
            item = q.element_size()
            n_bytes = 4 * b * t * h * d * item + b * h * t * 4 + b * t * 4
            # the products over the valid keys only
            b_ms, b_by = bound(n_bytes, 4 * h * d * t * n_valid,
                               BF16_FLOPS if dtype == torch.bfloat16
                               else F32_FLOPS)
            bool_mask = mask.bool()[:, None, None, :]
            shape = dict(name="flash_fwd", dtype=name, b=b, t=t, h=h, d=d,
                         variant="mask", max_abs_err=max(
                             max(e) for e in errs.values()),
                         errors={k_: list(e) for k_, e in errs.items()},
                         out_err_share_of_tol=shares,
                         bound_ms=b_ms, bound_by=b_by)
            shapes.append(call_times(shape, dict(
                ms=partial(flash_fwd, q, k, v, kv_mask=mask),
                plain_ms=partial(flash_fwd_reference, q, k, v,
                                 kv_mask=mask),
                library_ms=partial(
                    F.scaled_dot_product_attention, q.transpose(1, 2),
                    k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=bool_mask))))
            print(f"K3 flash_fwd {name} b={b} t={t} h={h} d={d}: (out, lse) "
                  f"max abs err {errs}; out err as a share of its "
                  f"tolerance {shares}; per call with launch gaps (mask): "
                  f"kernel {shape['call_ms']:.5f} ms, plain "
                  f"{shape['plain_call_ms']:.5f} ms, sdpa "
                  f"{shape['library_call_ms']:.5f} ms; bound {b_ms:.5f} ms "
                  f"({b_by})", flush=True)
    bgen = torch.Generator(device="cuda")
    bgen.manual_seed(BOUNDARY_SEED)
    boundary = {}
    for b, t in ((8, 128), (32, 512), (4, 200)):
        for dtype in (torch.bfloat16, torch.float32):
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            scene = flash_scene(torch, bgen, b, t, h, d, dtype, boundary=True)
            errs, shares = check_flash_fwd(torch, scene, b, t, dtype,
                                           " boundary")
            boundary[f"{name} b={b} t={t}"] = dict(
                max_abs_err=max(max(e) for e in errs.values()),
                max_err_share_of_tol=max(shares.values()))
            print(f"K3 flash_fwd {name} b={b} t={t} boundary rows: (out, "
                  f"lse) max abs err {errs}; out err as a share of its "
                  f"tolerance {shares}", flush=True)
    return shapes, boundary


# ----------------------------------------------------------------------
# phase 5b: K1b
# ----------------------------------------------------------------------

def sum_gate(diff, mag):
    """Per-element gate for an f32 sum of many terms taken in another
    order: 1e-6 of the magnitude of the terms summed, plus 1e-6."""
    return bool((diff <= 1e-6 * mag + 1e-6).all())


def phase_layer_norm_bwd(torch, gen):
    from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_fwd,
    )
    shapes = []
    # rows 16384: the BERT fine-tune batch of 32 x 512 (the main path);
    # 100 and 8: rows that fill no block of the kernel
    for rows in (16384, 100, 8):
        x = torch.randn(rows, D_MODEL, generator=gen, device="cuda")
        scale = 1 + 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        g = torch.randn(rows, D_MODEL, generator=gen, device="cuda")
        _, mean, rstd = layer_norm_fwd(x, scale, bias, 1e-6)
        got = layer_norm_bwd(x, scale, mean, rstd, g)
        want = layer_norm_bwd_reference(x, scale, mean, rstd, g)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        xhat = (x - mean) * rstd
        # dx: f32 row reductions of d = 768 terms in another order;
        # dscale/dbias: f32 sums over the rows in another order, gated
        # per column against the magnitude of the terms summed
        check(errs[0] <= 1e-5
              and sum_gate((got[1] - want[1]).abs(), (g * xhat).abs().sum(0))
              and sum_gate((got[2] - want[2]).abs(), g.abs().sum(0)),
              f"K1b rows={rows}: max abs err (dx, dscale, dbias) {errs}")
        n_bytes = 3 * rows * D_MODEL * 4 + 3 * D_MODEL * 4 + 2 * rows * 4
        b_ms, b_by = bound(n_bytes, 12 * rows * D_MODEL)
        shape = dict(name="layer_norm_bwd", rows=rows, d=D_MODEL,
                     max_abs_err=max(errs), errors=errs, bound_ms=b_ms,
                     bound_by=b_by)
        shapes.append(call_times(shape, dict(
            ms=partial(layer_norm_bwd, x, scale, mean, rstd, g),
            plain_ms=partial(layer_norm_bwd_reference, x, scale, mean, rstd,
                             g),
            library_ms=partial(torch.ops.aten.native_layer_norm_backward, g,
                               x, [D_MODEL], mean, rstd, scale, bias,
                               [True, True, True]))))
        print(f"K1b layer_norm_bwd rows={rows} d={D_MODEL}: max_abs_err "
              f"(dx, dscale, dbias) {errs}; per call with launch gaps: "
              f"kernel {shape['call_ms']:.5f} ms, plain "
              f"{shape['plain_call_ms']:.5f} ms, native_layer_norm_backward "
              f"{shape['library_call_ms']:.5f} ms; bound {b_ms:.5f} ms "
              f"({b_by})", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 5c: K4a, K4b, K5
# ----------------------------------------------------------------------

def bwd_magnitudes(torch, q, k, v, dout, lse, delta, kv_mask=None, bias=None,
                   seed3=None, causal=False, dropout=0.0, bh0=0,
                   out_mag=False):
    """Sums of |terms| of each backward product in f32 (dq: |ds||k| scale,
    dk: |ds||q| scale, dv: |p~||dO|, dbias: |ds| over the replicas), for
    the bf16 gates.  `bh0` is the first row's b*h index in the call the
    inputs were sliced from (one head of a larger call: the dropout hash
    reads it); with `out_mag`, returns (the forward's |p~||v|, the
    list)."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        drop_keep_mask,
    )
    b, t, h, d = q.shape
    scale = d ** -0.5

    def bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).float()

    qf, kf, vf, gf = bh(q), bh(k), bh(v), bh(dout)
    s = torch.einsum("btd,bsd->bts", qf, kf) * scale
    if bias is not None:
        s = s + bias.expand(b, h, t, t).reshape(b * h, t, t)
    keep = (kv_mask != 0).repeat_interleave(h, 0)[:, None, :] \
        if kv_mask is not None else torch.ones_like(s, dtype=torch.bool)
    if causal:
        keep = keep & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("btd,bsd->bts", gf, vf)
    # sum_d |dO||v|, the scale of dp's own f32 rounding
    dp_abs = torch.einsum("btd,bsd->bts", gf.abs(), vf.abs())
    pv = p
    if dropout > 0.0:
        ar = torch.arange(t, device="cuda")
        bhs = bh0 + torch.arange(b * h, device="cuda")
        kd = drop_keep_mask(seed3[0].long(), bhs[:, None, None],
                            seed3[1].long() + ar[:, None],
                            seed3[2].long() + ar[None], dropout)
        pv = torch.where(kd, p / (1 - dropout), 0.0)
        dp = torch.where(kd, dp / (1 - dropout), 0.0)
        dp_abs = torch.where(kd, dp_abs / (1 - dropout), 0.0)
    # |ds| plus its f32 rounding: where a row attends one key (causal row
    # 0), dp - delta cancels to ~0 and what is left is the rounding of
    # the d-term sum dp on each side, at most d 2^-24 sum|dO||v|; 2^-8
    # of that sum, times the gate's 2^-7, covers it 8-fold at d = 64
    ds = p * ((dp - delta[..., None]).abs() + 2.0 ** -8 * dp_abs)

    def back(x):
        return x.reshape(b, h, t, d).permute(0, 2, 1, 3)

    mags = [back(torch.einsum("bts,bsd->btd", ds, kf.abs()) * scale),
            back(torch.einsum("bts,btd->bsd", ds, qf.abs()) * scale),
            back(torch.einsum("bts,btd->bsd", pv.abs(), gf.abs()))]
    if bias is not None:
        full = ds.reshape(b, h, t, t)
        dims = [i for i in (0, 1) if bias.shape[i] == 1]
        mags.append(full.sum(dim=dims, keepdim=True) if dims else full)
    if out_mag:
        return back(torch.einsum("bts,bsd->btd", pv.abs(), vf.abs())), mags
    return mags


def dbias_zero_at_padding(dbias, padded):
    """Whether the bias's gradient is exactly 0 at every key each of its
    plane's replicas pads (`padded` [b, t]: True at a padded key): a
    [b, ...] bias plane per batch row, a [1, ...] one where every batch
    row pads.  K5 neither loads nor computes a replica's key tile with
    no valid key, and ds = 0 at a masked key."""
    pads = padded if dbias.shape[0] == padded.shape[0] \
        else padded.all(0, keepdim=True)
    return all(bool((dbias[i][..., pads[i]] == 0).all())
               for i in range(dbias.shape[0]))


def check_flash_bwd(torch, gen, scene, b, t, dtype, what="", extra=None):
    """Hold K4a, K4b and K5 against their plain version in every case of
    phase 5 plus a loss on the lse, the fine-tune's own case and the
    `extra` cases, each from the kernels' own forward and a cotangent
    drawn from `gen`: per element; where a case has the kv_mask, zeros
    on the fully padded batch row 0 and dk and dv exactly 0 at every
    padded key.  Returns ({label: max abs err of dq, dk, dv[, dbias]},
    {label: the worst as a share of its tolerance})."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd,
        flash_bwd_reference,
        flash_fwd,
    )
    qkv, fused, mask, biases, seed3, _ = scene
    h = qkv[0].shape[2]
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    variants = {"mask": (qkv, dict(kv_mask=mask))}
    for shp, bias in biases.items():
        variants[f"bias[{shp}]+mask"] = (qkv, dict(kv_mask=mask,
                                                   bias=bias))
    variants["causal+mask"] = (qkv, dict(kv_mask=mask, causal=True))
    variants["dropout0.1+mask"] = (qkv, dict(
        kv_mask=mask, seed3=seed3, dropout=0.1))
    variants["lse-loss+mask"] = (qkv, dict(kv_mask=mask))
    variants["fused-qkv+mask"] = (fused, dict(kv_mask=mask))
    # the fine-tune's own case: fused qkv, dropout and a key mask
    variants["fused-qkv+dropout0.1+mask"] = (fused, dict(
        kv_mask=mask, seed3=seed3, dropout=0.1))
    variants[f"fused-qkv+bias[{b}x1]+causal+dropout0.1+mask"] = (
        fused, dict(kv_mask=mask, bias=biases[f"{b}x1"],
                    causal=True, seed3=seed3, dropout=0.1))
    variants.update(extra or {})
    errs, shares = {}, {}
    for label, (args, kw) in variants.items():
        out, lse = flash_fwd(*args, **kw)
        dout = torch.randn(out.shape, generator=gen,
                           device="cuda").to(dtype)
        delta = (dout.float() * out.float()).sum(-1).permute(
            0, 2, 1).reshape(b * h, t)
        if label.startswith("lse-loss"):
            delta = delta - torch.randn(delta.shape, generator=gen,
                                        device="cuda")
        delta = delta.contiguous()
        grad_bias = "bias" in kw
        got = flash_bwd(*args, dout, lse, delta, **kw,
                        bias_grad=grad_bias)
        want = flash_bwd_reference(*args, dout, lse, delta, **kw,
                                   bias_grad=grad_bias)
        torch.cuda.synchronize()
        got, want = got[:3 + grad_bias], want[:3 + grad_bias]
        diffs = [(a.float() - w.float()).abs()
                 for a, w in zip(got, want)]
        if dtype == torch.bfloat16:
            # both sides round ds and p~ to bf16 before their
            # products (from f32 values computed in other orders:
            # at most one ulp apart, 2^-7 relative) and the
            # gradient once (one ulp of |ref|); dbias stays f32
            mags = bwd_magnitudes(torch, *args, dout, lse, delta,
                                  **kw)
            tols = [2.0 ** -7 * (w.float().abs() + m) + 1e-6
                    for w, m in zip(want, mags)]
        else:
            # the same f32 arithmetic summed in other orders
            tols = [torch.full_like(x, 1e-4) for x in diffs]
        ratios = [float((x / tl).max()) for x, tl in zip(diffs, tols)]
        share = max(ratios)
        e = [float(x.max()) for x in diffs]
        worst = ratios.index(share)
        at = int((diffs[worst] / tols[worst]).argmax())
        check(share <= 1.0, f"K4a/K4b/K5 {name} b={b} t={t}{what} "
              f"{label}: max abs err (dq, dk, dv[, dbias]) {e}, {share:.3f} of "
              f"the tolerance, worst in output {worst} at flat index "
              f"{at}: kernel {float(got[worst].flatten()[at])}, plain "
              f"{float(want[worst].flatten()[at])}, tolerance "
              f"{float(tols[worst].flatten()[at])}")
        errs[label] = e
        shares[label] = share
        if "kv_mask" not in kw:
            continue
        check(all(bool((a[0] == 0).all()) for a in got[:3]),
              f"flash bwd {name}{what} {label}: a fully padded batch row "
              "must give zero dq, dk, dv")
        padded = kw["kv_mask"] == 0
        check(all(bool((a[padded] == 0).all()) for a in got[1:3]),
              f"flash bwd {name}{what} {label}: dk and dv must be exactly "
              "zero at every padded key")
        if grad_bias:
            check(dbias_zero_at_padding(got[3], padded),
                  f"flash bwd {name}{what} {label}: dbias must be exactly "
                  "zero at every key all of a plane's replicas pad")
    return errs, shares


def phase_flash_bwd(torch, gen):
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd_dbias,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_reference,
        flash_fwd,
    )
    shapes = {"flash_bwd_dq": [], "flash_bwd_dkv": [],
              "flash_bwd_dbias": []}
    h, d = 12, 64
    for b, t in ((8, 128), (32, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            scene = flash_scene(torch, gen, b, t, h, d, dtype, boundary=True)
            qkv, fused, mask, biases, seed3, n_valid = scene
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            errs, shares = check_flash_bwd(torch, gen, scene, b, t, dtype)
            q, k, v = qkv
            item = q.element_size()
            out, lse = flash_fwd(q, k, v, kv_mask=mask)
            dout = torch.randn(out.shape, generator=gen, device="cuda"
                               ).to(dtype)
            delta = (dout.float() * out.float()).sum(-1).permute(
                0, 2, 1).reshape(b * h, t).contiguous()
            peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
            head_bytes = b * t * h * d * item
            # products over the valid keys only (this run's kv_mask)
            prods = 2 * h * d * t * n_valid
            bargs = (q, k, v, dout, lse, delta)
            bool_mask = mask.bool()[:, None, None, :]
            lib = sdpa_backward(torch, F, q, k, v, dout, bool_mask)
            for kname, fn, n_prod, n_bytes, kw in (
                    ("flash_bwd_dq", flash_bwd_dq, 3,
                     5 * head_bytes + 2 * b * h * t * 4 + b * t * 4,
                     dict(kv_mask=mask)),
                    ("flash_bwd_dkv", flash_bwd_dkv, 4,
                     6 * head_bytes + 2 * b * h * t * 4 + b * t * 4,
                     dict(kv_mask=mask))):
                errs_k = {lb: e[:3] for lb, e in errs.items()}
                b_ms, b_by = bound(n_bytes, n_prod * prods, peak)
                shape = dict(name=kname, dtype=name, b=b, t=t, h=h, d=d,
                             variant="mask",
                             max_abs_err=max(max(e) for e in errs_k.values()),
                             errors=errs_k, err_share_of_tol=shares,
                             bound_ms=b_ms, bound_by=b_by,
                             library="SDPA backward (dq, dk, dv together), "
                                     "boolean mask, forward subtracted")
                shapes[kname].append(call_times(shape, dict(
                    ms=partial(fn, *bargs, **kw),
                    plain_ms=partial(flash_bwd_reference, *bargs, **kw),
                    **lib)))
            # K5 at the learnable-bias path's shape: a [1, h, t, t] f32
            # bias, no kv_mask
            bias = biases[f"1x{h}"]
            out, lse = flash_fwd(q, k, v, bias=bias)
            delta = (dout.float() * out.float()).sum(-1).permute(
                0, 2, 1).reshape(b * h, t).contiguous()
            bargs = (q, k, v, dout, lse, delta)
            b_ms, b_by = bound(4 * head_bytes + 2 * b * h * t * 4
                               + 2 * bias.numel() * 4, 2 * 2 * h * d * t * t
                               * b, peak)
            db_errs = {lb: e[3] for lb, e in errs.items() if len(e) == 4}
            shape = dict(name="flash_bwd_dbias", dtype=name, b=b, t=t, h=h,
                         d=d, variant=f"bias[1x{h}]",
                         max_abs_err=max(db_errs.values()), errors=db_errs,
                         bound_ms=b_ms, bound_by=b_by,
                         library="SDPA backward with a float bias needing "
                                 "its gradient (dq, dk, dv, dbias), "
                                 "forward subtracted")
            shapes["flash_bwd_dbias"].append(call_times(shape, dict(
                ms=partial(flash_bwd_dbias, *bargs, bias=bias),
                plain_ms=partial(flash_bwd_reference, *bargs, bias=bias,
                                 bias_grad=True),
                **sdpa_backward(torch, F, q, k, v, dout,
                                bias.to(dtype, copy=True).requires_grad_(
                                    True)))))
            for s in shapes.values():
                subtract_forward(s[-1], "library_call_ms")
            tail = {kn: (f"kernel {s[-1]['call_ms']:.5f}, plain "
                         f"{s[-1]['plain_call_ms']:.5f}, sdpa bwd "
                         f"{s[-1]['library_call_ms']:.5f}")
                    for kn, s in shapes.items()}
            print(f"K4a/K4b/K5 flash backward {name} b={b} t={t} h={h} d={d}:"
                  f" max abs err (dq, dk, dv[, dbias]) {errs}; share of the "
                  f"tolerance {shares}; per call with launch gaps (ms) "
                  f"{tail}", flush=True)
    # a t that ends inside a block of 128 queries or keys, from the
    # boundary scenes' own generator (the scenes above stay as they were)
    bgen = torch.Generator(device="cuda")
    bgen.manual_seed(BOUNDARY_SEED + 1)
    ragged = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        b, t = 4, 200
        scene = flash_scene(torch, bgen, b, t, h, d, dtype, boundary=True)
        errs, shares = check_flash_bwd(torch, bgen, scene, b, t, dtype,
                                       " ragged")
        ragged[f"{name} b={b} t={t}"] = dict(
            max_abs_err=[max(e[i] for e in errs.values()) for i in range(3)],
            max_err_share_of_tol=max(shares.values()))
        print(f"K4a/K4b/K5 flash backward {name} b={b} t={t} (ragged t): max "
              f"abs err (dq, dk, dv[, dbias]) {errs}; share of the tolerance "
              f"{shares}", flush=True)
    return shapes, ragged


#: seed of the scene at b*h past 65535, drawn from a generator of its own
WIDE_SEED = 11
#: its batch: 5462 rows of 12 heads, b*h = 65544
WIDE_B = 5462
#: batch rows a slice of the plain version takes
WIDE_SLICE = 512


def phase_flash_wide(torch):
    """K3, K4a, K4b and K5 at b*h = 65544 (BERT's 12 heads at batch
    5462), past the 65535 that a grid.y of b*h took: bf16, t = 128, a
    kv_mask (lengths uniform in [t/4, t], batch row 0 fully padded, row
    1 one valid key into its second 64-key tile), with a [b, 1, t, t]
    bias and then a [b, h, t, t] one (65544 planes for K5).  Each
    kernel against its plain version under phase 5's and 5c's gates, the
    plain version run over slices of WIDE_SLICE batch rows (each row's
    attention, and its planes of these biases' gradients, are its own)."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd,
        flash_bwd_reference,
        flash_fwd,
        flash_fwd_reference,
    )
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(WIDE_SEED)
    b, t, h, d = WIDE_B, 128, 12, 64
    q, k, v = (torch.randn(b, t, h, d, generator=wgen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(t // 4, t + 1, (b,), generator=wgen, device="cuda")
    lens[0], lens[1] = 0, 65
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(
        torch.int32)
    dout = torch.randn(b, t, h, d, generator=wgen, device="cuda").to(
        torch.bfloat16)
    res = {}
    for label, lead in (("bias[bx1]+mask", (b, 1)),
                        ("bias[bxh]+mask", (b, h))):
        bias = 0.5 * torch.randn(*lead, t, t, generator=wgen, device="cuda")
        kw = dict(kv_mask=mask, bias=bias)
        out, lse = flash_fwd(q, k, v, **kw)
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(b * h, t).contiguous()
        got = flash_bwd(q, k, v, dout, lse, delta, **kw, bias_grad=True)
        torch.cuda.synchronize()
        fwd_share = lse_err = 0.0
        bwd_share = [0.0] * 4
        errs = [0.0] * 5
        for i0 in range(0, b, WIDE_SLICE):
            i1 = min(b, i0 + WIDE_SLICE)
            rs, hs = slice(i0, i1), slice(i0 * h, i1 * h)
            args = (q[rs], k[rs], v[rs])
            ckw = dict(kv_mask=mask[rs], bias=bias[rs])
            rout, rlse = flash_fwd_reference(*args, **ckw)
            # phase 5's bf16 gate (check_flash_fwd)
            mag, _ = flash_fwd_reference(args[0].float(), args[1].float(),
                                         args[2].float().abs(), **ckw)
            diff = (out[rs].float() - rout.float()).abs()
            fwd_share = max(fwd_share, float((diff / (
                2.0 ** -7 * (rout.float().abs() + mag) + 1e-6)).max()))
            errs[0] = max(errs[0], float(diff.max()))
            lse_err = max(lse_err, float((lse[hs] - rlse).abs().max()))
            # phase 5c's bf16 gates (check_flash_bwd)
            bargs = (*args, dout[rs], lse[hs], delta[hs])
            want = flash_bwd_reference(*bargs, **ckw, bias_grad=True)
            mags = bwd_magnitudes(torch, *bargs, **ckw)
            for j in range(4):
                diff = (got[j][rs].float() - want[j].float()).abs()
                tol = 2.0 ** -7 * (want[j].float().abs() + mags[j]) + 1e-6
                bwd_share[j] = max(bwd_share[j], float((diff / tol).max()))
                errs[1 + j] = max(errs[1 + j], float(diff.max()))
            del rout, rlse, mag, want, mags
        padded = mask == 0
        check(fwd_share <= 1.0 and lse_err <= 1e-4 and max(bwd_share) <= 1.0,
              f"flash b*h={b * h} {label}: share of the tolerance out "
              f"{fwd_share:.3f}, (dq, dk, dv, dbias) {bwd_share}; lse err "
              f"{lse_err} (tol 1e-4)")
        check(bool((out[0] == 0).all())
              and all(bool((g[0] == 0).all()) for g in got[:3]),
              f"flash b*h={b * h} {label}: a fully padded row must give "
              "zeros")
        check(all(bool((g[padded] == 0).all()) for g in got[1:3])
              and dbias_zero_at_padding(got[3], padded),
              f"flash b*h={b * h} {label}: dk, dv and dbias must be exactly "
              "zero at every padded key")
        res[label] = dict(b=b, h=h, t=t, bh=b * h,
                          max_abs_err_out_dq_dk_dv_dbias=errs,
                          lse_err=lse_err, out_share_of_tol=fwd_share,
                          grad_shares_of_tol=bwd_share)
        print(f"K3/K4a/K4b/K5 bf16 at b*h={b * h} t={t} {label}: "
              f"{res[label]}", flush=True)
        del bias, out, lse, delta, got
        torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# phase 5d: the Hopper bodies launched from several host threads at once
# ----------------------------------------------------------------------

#: seed of phase 5d's inputs, drawn from a generator of their own
THREADS_SEED = 7
#: rounds a thread launches each Hopper body, t alternating 128 / 512
THREADS_ROUNDS = 200


def phase_threads(torch):
    """The Hopper bodies (K2's sm90, K3's, K4a's, K4b's and K5's, which
    read through TMA tensor maps, and K6's split body, with its bulk
    copies and per-lane counters) launched back to back from 6 new host
    threads, the flash kernels at t = 128 and 512 in turn as phase 7's
    serving threads send them.  Thread i makes no CUDA call before its
    first launch, of the i-th kernel: a thread with no current context
    must launch as well as any.  Every launch must go through and give
    what the same call gave alone, bit for bit (each body sums in a
    fixed order).  Returns launches and mismatches."""
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd_dbias,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
        body,
        fused_dense_gelu,
    )
    tgen = torch.Generator(device="cuda")
    tgen.manual_seed(THREADS_SEED)
    h, d = 12, 64
    calls = []      # per t: [(label, call, its result alone)]
    x = torch.randn(1024, D_MODEL, generator=tgen, device="cuda").to(
        torch.bfloat16)
    w = (0.02 * torch.randn(4 * D_MODEL, D_MODEL, generator=tgen,
                            device="cuda")).to(torch.bfloat16)
    bias = torch.randn(4 * D_MODEL, generator=tgen, device="cuda").to(
        torch.bfloat16)
    check(body(x, w) == "sm90", "phase 5d: K2's operands must take sm90")
    # K6's scene from a generator of its own: the others' inputs stay
    pgen = torch.Generator(device="cuda")
    pgen.manual_seed(THREADS_SEED + 1)
    sc, _ = paged_scene(torch, pgen, False, torch.float16)
    paged = partial(paged_decode, sc["q"], sc["new_k"], sc["new_v"],
                    sc["k_pool"], sc["v_pool"], sc["block_tables"],
                    sc["ctx_len"])
    for t in (128, 512):
        (q, k, v), _, mask, biases, _, _ = flash_scene(
            torch, tgen, 8, t, h, d, torch.bfloat16)
        dout = torch.randn(q.shape, generator=tgen, device="cuda").to(q.dtype)
        out, lse = flash_fwd(q, k, v, kv_mask=mask)
        delta = ((dout.float() * out.float()).sum(-1).permute(0, 2, 1)
                 .reshape(-1, t).contiguous())
        grads = (q, k, v, dout, lse, delta)
        ops = [("K3", partial(flash_fwd, q, k, v, kv_mask=mask)),
               ("K4a", partial(flash_bwd_dq, *grads, kv_mask=mask)),
               ("K4b", partial(flash_bwd_dkv, *grads, kv_mask=mask)),
               ("K2", partial(fused_dense_gelu, x, w, bias)),
               ("K5", partial(flash_bwd_dbias, *grads, kv_mask=mask,
                              bias=biases[f"1x{h}"])),
               ("K6", paged)]
        calls.append([(label, fn, fn()) for label, fn in ops])
    n = len(calls[0])
    torch.cuda.synchronize()

    def same(a, b):
        if isinstance(a, tuple):
            return torch.stack([same(x_, y_) for x_, y_ in zip(a, b)]).all()
        return (a == b).all()

    def run(i):
        diffs = []
        for j in range(THREADS_ROUNDS):
            ops = calls[(i + j) % 2]
            for label, fn, want in ops[i:] + ops[:i]:
                diffs.append(same(fn(), want))
        return int((~torch.stack(diffs)).sum())

    t0 = time.perf_counter()
    errors, bad = [], 0
    with ThreadPoolExecutor(n) as pool:
        for f in [pool.submit(run, i) for i in range(n)]:
            try:
                bad += f.result()
            except RuntimeError as e:
                errors.append(str(e))
    check(not errors, f"Hopper bodies from {n} threads: {len(errors)} of "
          f"{n} threads raised, first: {errors[:1]}")
    check(bad == 0, f"Hopper bodies from {n} threads: {bad} launches "
          "differ from the same call made alone")
    res = dict(threads=n, kernels=[label for label, _, _ in calls[0]],
               launches=n * n * THREADS_ROUNDS, mismatches=bad,
               seconds=time.perf_counter() - t0)
    print(f"K3/K4a/K4b/K2/K5 bf16 (flash b=8 t=128|512, K5 at a [1, 12, t, "
          f"t] bias, K2 1024x768x3072) and K6 (phase 3's scene, f16 pool) "
          f"from {n} host threads: {res}", flush=True)
    return res


def sdpa_backward(torch, F, q, k, v, dout, mask):
    """{"library_ms": forward + backward, "library_fwd_ms": forward} of
    F.scaled_dot_product_attention at these inputs, for `call_times`:
    the library yardstick of the flash backward kernels is their
    difference (`subtract_forward`; timed only, the port never calls
    it).  A float `mask` that needs its gradient asks SDPA for the
    bias's gradient too.  q, k, v and dout go in SDPA's own contiguous
    [b, h, t, d] layout."""
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    go = dout.transpose(1, 2).contiguous()
    ins = (qs, ks, vs) + ((mask,) if mask.requires_grad else ())

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        torch.autograd.grad(o, ins, go)

    return {"library_ms": fwd_bwd, "library_fwd_ms": fwd}


def subtract_forward(shape: dict, key: str) -> None:
    """shape[key], timed as SDPA forward + backward, minus the forward
    alone (kept beside it), where the shape has such a pair."""
    fwd = key.replace("library", "library_fwd")
    if fwd in shape:
        shape[key] -= shape[fwd]


# ----------------------------------------------------------------------
# phase 7: slice 2, BERT classification serving
# ----------------------------------------------------------------------

BERT_BATCHES = (1, 5, 32, 48)
BERT_LENGTHS = (128, 512)
#: rounds of every (batch, t) each of the 4 threads sends
BERT_REPS = 5


def bert_request(rng, n: int, t: int, vocab: int):
    """n sequences of t tokens (ids, segments, mask) with valid lengths
    uniform in [t/4, t] and the padding masked; returns (inputs, valid
    tokens)."""
    import numpy as np
    ids = rng.integers(0, vocab, (n, t)).astype(np.int32)
    seg = (np.arange(t)[None] >= t // 2).astype(np.int32).repeat(n, 0)
    lens = rng.integers(t // 4, t + 1, n)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return (ids, seg, mask), int(lens.sum())


def serve_bert(torch, im, model, seed: int, label: str, flash: bool):
    """Send BERT_REPS rounds of every (batch, t) from 4 threads through
    `im.predict`; check the launch counts per forward; returns the
    summary and the requests with their served outputs."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch.ops import kernels
    rng = np.random.default_rng(seed)
    vocab = model.bert.token_embed.num_embeddings
    plans = [[(n, t) + bert_request(rng, n, t, vocab)
              for _ in range(BERT_REPS) for t in BERT_LENGTHS
              for n in BERT_BATCHES] for _ in range(4)]
    for plan in plans:
        rng.shuffle(plan)

    def run(plan):
        done = []
        for n, t, inputs, valid in plan:
            t0 = time.perf_counter()
            out = im.predict(*inputs)
            done.append((n, t, inputs, valid, out,
                         time.perf_counter() - t0))
        return done

    served0 = im.records_served
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        done = [r for f in [pool.submit(run, p) for p in plans]
                for r in f.result()]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    mb = im.max_batch_size
    forwards = sum(-(-n // mb) for n, *_ in done)
    n_seq = sum(n for n, *_ in done)
    check(im.records_served - served0 == n_seq,
          f"{label}: records_served moved by {im.records_served - served0},"
          f" {n_seq} sequences were sent")
    n_blk = len(model.bert.blocks)
    want = dict({name: 0 for name in counts},
                layer_norm_fwd=(2 * n_blk + 1) * forwards,
                fused_dense_gelu=n_blk * forwards,
                flash_fwd=n_blk * forwards if flash else 0)
    check(counts == want, f"{label}: launches {counts}, expected {want} "
          f"for {forwards} forwards")
    bodies = k2_bodies(label, counts)
    lat = {}
    for n, t, _, _, _, sec in done:
        lat.setdefault(f"{n}x{t}", []).append(sec * 1e3)
    summary = dict(
        label=label, predict_calls=len(done), sequences=n_seq,
        forwards=forwards, valid_tokens=sum(r[3] for r in done),
        wall_s=wall, sequences_per_s=n_seq / wall,
        valid_tokens_per_s=sum(r[3] for r in done) / wall,
        predict_ms_p50={k_: statistics.median(v)
                        for k_, v in sorted(lat.items())},
        launches=counts, k2_launches_by_body=bodies)
    return summary, done


def check_bert_logits(torch, model, done, tol: float, label: str):
    """Recompute one request of each (batch, t) through the plain
    versions; the served logits must agree within `tol`, and the argmax
    wherever the top-2 gap exceeds it."""
    seen, worst, n_cmp, n_top = set(), 0.0, 0, 0
    with torch.inference_mode():
        for n, t, inputs, _, out, _ in done:
            if (n, t) in seen:
                continue
            seen.add((n, t))
            ref = model(*(torch.from_numpy(a).cuda() for a in inputs),
                        impl="reference").float()
            got = torch.from_numpy(out).cuda()
            check(bool(torch.isfinite(got).all()),
                  f"{label}: non-finite served logits")
            worst = max(worst, float((got - ref).abs().max()))
            top2 = torch.topk(ref, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol
            check(bool((got.argmax(-1) == ref.argmax(-1))[clear].all()),
                  f"{label}: a served argmax differs from the recompute's "
                  f"where the top-2 gap exceeds {tol}")
            n_cmp += n
            n_top += int(clear.sum())
    check(worst <= tol, f"{label}: served logits differ from the plain "
          f"recompute by {worst} > {tol}")
    return dict(logits_max_abs_err=worst, logits_tol=tol,
                rows_compared=n_cmp, argmax_checked=n_top)


def phase_bert(torch, seed: int, card: str):
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.serving.inference_model import (
        InferenceModel,
    )
    import numpy as np
    cfg = dict(BERT_BASE, num_classes=2)
    t0 = time.perf_counter()
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    models = {}
    for label, kw in (("bf16 flash", dict(attn_impl="flash")),
                      ("bf16 einsum", dict(attn_impl="einsum")),
                      ("f32 flash", dict(attn_impl="flash",
                                         compute_dtype=torch.float32))):
        m = BERTClassifier(**cfg, device="cuda", **kw)
        m.load_state_dict(state)
        models[label] = m.eval()
    del state
    n_params = sum(p.numel() for p in models["bf16 flash"].parameters())
    print(f"slice 2: BERTClassifier at BERT-base widths, {n_params} params "
          f"(f32), built in {time.perf_counter() - t0:.1f} s", flush=True)

    runs = []
    for label, tol in (("bf16 flash", 0.05), ("bf16 einsum", None)):
        im = InferenceModel(supported_concurrent_num=4, max_batch_size=32
                            ).load_module(models[label])
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed + 1)
        for t in BERT_LENGTHS:             # every bucket the traffic uses
            for n in (1, 8, 32, 16):
                im.predict(*bert_request(rng, n, t, cfg["vocab"])[0])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        summary, done = serve_bert(torch, im, models[label], seed + 2,
                                   label, label.endswith("flash"))
        summary["warmup_s"] = warm_s
        if tol is not None:
            summary.update(check_bert_logits(torch, models[label], done,
                                             tol, label))
        runs.append(summary)
        p50 = {k_: round(v, 3) for k_, v in summary["predict_ms_p50"].items()}
        print(f"slice 2 [{card}] {label}{'' if tol else ' (comparison)'}: "
              f"{summary['predict_calls']} predict calls from 4 threads, "
              f"{summary['sequences']} sequences, {summary['forwards']} "
              f"forwards in {summary['wall_s']:.3f} s = "
              f"{summary['sequences_per_s']:.1f} sequences/s, "
              f"{summary['valid_tokens_per_s']:.0f} valid tokens/s; "
              f"predict p50 ms by batch x t {p50}; launches "
              f"{summary['launches']}"
              + (f"; logits max abs err {summary['logits_max_abs_err']:.3e}"
                 f" over {summary['rows_compared']} rows (tol {tol})"
                 if tol else ""), flush=True)

    # f32 compute: the same path with f32 kernels, at a tight tolerance
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=32
                        ).load_module(models["f32 flash"])
    rng = np.random.default_rng(seed + 3)
    done = []
    for n, t in zip((5, 32), BERT_LENGTHS):
        inputs, valid = bert_request(rng, n, t, cfg["vocab"])
        done.append((n, t, inputs, valid, im.predict(*inputs), 0.0))
    # f32 throughout; the kernels sum in other orders than cuBLAS and
    # the plain softmax, through 12 post-LN blocks: 1e-4, about 60x the
    # 1.7e-6 read on an H100
    f32 = check_bert_logits(torch, models["f32 flash"], done, 1e-4,
                            "f32 flash")
    print(f"slice 2 [{card}] f32 flash: logits max abs err "
          f"{f32['logits_max_abs_err']:.3e} over {f32['rows_compared']} "
          "rows (tol 0.0001)", flush=True)
    runs.append(dict(label="f32 flash", **f32))
    del models["f32 flash"], models["bf16 einsum"], im
    return runs, models["bf16 flash"]


def bert_profile(torch, model, seed: int, iters: int = 5):
    """Where one t = 512, batch-32 forward's time goes: host wall per
    forward without the profiler, then device time by device op from a
    profiled window."""
    import numpy as np
    (ids, seg, mask), _ = bert_request(np.random.default_rng(seed), 32,
                                       512, model.bert.token_embed
                                       .num_embeddings)
    args = [torch.from_numpy(a).cuda() for a in (ids, seg, mask)]

    def fwd():
        with torch.inference_mode():
            return model(*args)

    fwd()
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    dev, per, _ = device_ms(fwd, iters=iters)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return dict(batch=32, t=512, wall_ms_per_forward=wall,
                device_ms_per_forward=dev,
                device_busy_share=(dev / wall if dev else None),
                top_device_ops_ms_per_forward=[(n[:100], v)
                                               for n, v in top])


# ----------------------------------------------------------------------
# phases 8 and 9: slice 3, BERT-base fine-tune through Estimator.fit,
# and the learnable-bias path
# ----------------------------------------------------------------------

TRAIN_BATCH, TRAIN_T = 32, 512
#: warm-up steps, then timed steps, all on the same batch
TRAIN_WARM, TRAIN_TIMED = 2, 10


def train_batch(rng, n: int, t: int, vocab: int):
    """bert_request's inputs with labels of a learnable rule: 1 where
    the first token id is below vocab / 2."""
    (ids, seg, mask), valid = bert_request(rng, n, t, vocab)
    return (ids, seg, mask), (ids[:, 0] < vocab // 2).astype(np.int32), \
        valid


def first_step_grads(torch, model, inputs, labels, impl, gen_state):
    """{param name: gradient} of one fine-tune step's loss through
    `impl`, dropout drawn from a generator at `gen_state` (a fork, so
    the kernel and plain paths draw the same masks and flash seeds)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.set_state(gen_state)
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(*inputs, impl=impl, generator=gen)
    F.cross_entropy(logits, labels).backward()
    torch.cuda.synchronize()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def grad_rel_err(torch, got, want):
    """max over parameters of max|got - want| / max|want|, and the
    parameter where it is reached.  The q, k and v thirds of a fused
    qkv projection count as parameters of their own, so a fault in one
    third (dK lands in the key third alone) is held to that third's
    largest gradient.  The key third of a qkv bias is the exception: the
    softmax cancels it, so its gradient is rounding on both sides and is
    held to the whole bias's largest gradient.  Also the worst error of
    each kind: the q, k and v thirds, and the other parameters."""
    check(got.keys() == want.keys(), "the kernel and plain paths gave "
          "gradients to different parameters")
    worst, where = 0.0, None
    by_kind = dict.fromkeys(("q", "k", "v", "other"), 0.0)
    for n, w in want.items():
        check(bool(torch.isfinite(got[n]).all()), f"non-finite grad of {n}")
        parts = zip(("q", "k", "v"), got[n].chunk(3), w.chunk(3)) \
            if n.split(".")[-2] == "qkv" else [("", got[n], w)]
        for third, g, w3 in parts:
            scale = w if n.endswith("qkv.bias") and third == "k" else w3
            err = float((g - w3).abs().max()) / max(float(scale.abs().max()),
                                                    1e-30)
            kind = third or "other"
            by_kind[kind] = max(by_kind[kind], err)
            if err >= worst:
                worst, where = err, f"{n}[{third}]" if third else n
    return worst, where, by_kind


def check_first_step(torch, model, inputs, labels, tol, label):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    state = gen.get_state()
    got = first_step_grads(torch, model, inputs, labels, "auto", state)
    want = first_step_grads(torch, model, inputs, labels, "reference", state)
    err, where, by_kind = grad_rel_err(torch, got, want)
    check(err <= tol, f"{label}: first-step gradients through the kernels "
          f"differ from the plain path by {err:.3e} of the largest "
          f"gradient (at {where}; worst by kind {by_kind}), over the gate "
          f"{tol}")
    model.zero_grad(set_to_none=True)
    return dict(grad_rel_err=err, grad_worst_param=where,
                grad_rel_err_by_kind=by_kind, grad_tol=tol,
                params_with_grad=len(want))


def phase_train(torch, seed: int, card: str):
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    cfg = dict(BERT_BASE, num_classes=2)
    vocab = cfg["vocab"]
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    rng = np.random.default_rng(seed + 11)
    inputs, y, valid = train_batch(rng, TRAIN_BATCH, TRAIN_T, vocab)
    on_card = [torch.from_numpy(a).cuda() for a in inputs]
    y_card = torch.from_numpy(y).long().cuda()

    # first-step gradients, kernels vs plain versions, same masks: an
    # f32-compute model (batch 8) at a tight gate, then the bf16 model
    f32 = BERTClassifier(**cfg, attn_impl="flash",
                         compute_dtype=torch.float32, device="cuda")
    f32.load_state_dict(state)
    # f32 throughout; the kernels sum in other orders than cuBLAS and the
    # plain softmax, through 12 blocks forward and back: 1e-4 of the
    # largest gradient, about 30x the 3.2e-6 read on an H100
    f32_check = check_first_step(torch, f32, [a[:8] for a in on_card],
                                 y_card[:8], 1e-4, "f32 model")
    del f32
    model = BERTClassifier(**cfg, attn_impl="flash", device="cuda")
    model.load_state_dict(state)
    del state
    # bf16 rounds the dense outputs and attention operands at other
    # places on each side (the flash kernels round unnormalized
    # probabilities, the plain version normalized ones), compounded
    # through 12 blocks forward and back.  The worst part is the last
    # block's query third: only the [CLS] query reaches the loss there,
    # so its gradient is one row's sum of bf16-rounded ds, which cancels
    # to near 0 (read at 0.156 of that third's largest gradient on an
    # H100): 0.3 of each part's largest gradient, about 2x that.  The f32
    # model and phase 5c's per-element gates hold the kernels tightly.
    bf16_check = check_first_step(torch, model, on_card, y_card, 0.3,
                                  "bf16 model")
    print(f"slice 3 [{card}] first-step gradients vs the plain path: f32 "
          f"model {f32_check}; bf16 model {bf16_check}", flush=True)

    n_steps = TRAIN_WARM + TRAIN_TIMED
    data = {"x": [np.concatenate([a] * n_steps) for a in inputs],
            "y": np.concatenate([y] * n_steps)}
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=2e-5,
                               metrics=["accuracy"], seed=seed)
    # a CUDA event as each step is queued, without a host wait: the
    # gaps between them are the steps' periods as fit runs them
    eng = est.engine
    marks = []

    def marked_step(batch, step=eng.train_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(batch)

    eng.train_step = marked_step
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del eng.train_step
    n_blk = cfg["n_block"]
    want = {"layer_norm_fwd": (2 * n_blk + 1) * n_steps,
            "layer_norm_bwd": (2 * n_blk + 1) * n_steps,
            "fused_dense_gelu": n_blk * n_steps, "flash_fwd": n_blk * n_steps,
            "flash_bwd_dq": n_blk * n_steps, "flash_bwd_dkv": n_blk * n_steps,
            "flash_bwd_dbias": 0, "paged_decode": 0}
    check(counts == want, f"slice 3: launches {counts}, expected {want} for "
          f"{n_steps} steps")
    bodies = k2_bodies("slice 3", counts)
    steps = eng.last_steps
    losses = [s["loss"] for s in steps]
    check(all(np.isfinite(losses)) and len(steps) == n_steps,
          f"slice 3: step losses {losses}")
    # a sanity check on the repeated batch, not a measure
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"slice 3: the loss did not fall on the repeated batch: {losses}")
    times = [a.elapsed_time(b) / 1e3
             for a, b in zip(marks[TRAIN_WARM:-1], marks[TRAIN_WARM + 1:])]
    p50 = statistics.median(times)
    padded = TRAIN_BATCH * TRAIN_T
    n_params = sum(p.numel() for p in model.parameters())
    flops_per_token = 6 * n_params + 12 * n_blk * cfg["hidden_size"] \
        * TRAIN_T
    summary = dict(
        label="bf16 flash fine-tune", batch=TRAIN_BATCH, t=TRAIN_T,
        params=n_params, steps=n_steps, timed_steps=len(times),
        wall_s=wall, step_ms_p50=p50 * 1e3,
        step_ms=[s * 1e3 for s in times],
        padded_tokens_per_s=padded / p50, valid_tokens_per_s=valid / p50,
        losses=losses, accuracy=est.train_summary[-1]["accuracy"],
        launches=counts, k2_launches_by_body=bodies,
        launches_per_step={k: v / n_steps for k, v in counts.items()},
        bert_train_mfu=flops_per_token * padded / p50 / BF16_FLOPS,
        first_step_f32=f32_check, first_step_bf16=bf16_check)

    # evaluate: forward kernels only
    kernels.reset_launch_counts()
    ev = est.evaluate({"x": list(inputs), "y": y}, batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    ev_counts = kernels.launch_counts()
    want_ev = dict(want, layer_norm_fwd=2 * n_blk + 1, layer_norm_bwd=0,
                   fused_dense_gelu=n_blk, flash_fwd=n_blk, flash_bwd_dq=0,
                   flash_bwd_dkv=0)
    check(ev_counts == want_ev, f"slice 3 evaluate: launches {ev_counts}, "
          f"expected {want_ev}")
    k2_bodies("slice 3 evaluate", ev_counts)
    summary["evaluate"] = dict(ev, launches=ev_counts)
    print(f"slice 3 [{card}] BERT-base fine-tune, batch {TRAIN_BATCH} x t = "
          f"{TRAIN_T} ({valid} valid tokens), Adam 2e-5: step p50 "
          f"{summary['step_ms_p50']:.3f} ms over {len(times)} timed steps = "
          f"{summary['padded_tokens_per_s']:.0f} padded tokens/s, "
          f"{summary['valid_tokens_per_s']:.0f} valid tokens/s, "
          f"bert_train_mfu {summary['bert_train_mfu']:.4f} (of 989 TFLOP/s "
          f"bf16); losses {[round(x, 4) for x in losses]}; launches per step "
          f"{summary['launches_per_step']}; evaluate {summary['evaluate']}",
          flush=True)
    return summary, est, (on_card, y_card)


def train_profile(torch, est, batch, iters: int = 3):
    """Where one fine-tune step's time goes: host wall per step without
    the profiler, then device time by device op and the host's top ops
    from a profiled window."""
    on_card, y_card = batch
    eng = est.engine
    host = {"features": tuple(a.cpu().numpy() for a in on_card),
            "labels": (y_card.int().cpu().numpy(),),
            "mask": np.ones(len(y_card), np.float32)}

    def step():
        eng.train_step(eng.put_batch(host))

    step()
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    dev, per, prof = device_ms(step, iters=iters)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:14]
    # every device event summed: the per-op medians undercount ops whose
    # launches differ in size (copies, adds over tensors of every shape)
    from torch.autograd import DeviceType
    dev_all = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3 / iters
    # host reads inside the step (the window's own closing
    # cudaDeviceSynchronize is not counted)
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize",
                             "aten::_local_scalar_dense")) / iters
    host_ops = sorted(((e.key, e.self_cpu_time_total / 1e3 / iters,
                        e.count / iters) for e in prof.key_averages()),
                      key=lambda t: -t[1])[:10]
    return dict(batch=len(y_card), t=on_card[0].shape[1],
                wall_ms_per_step=wall, device_ms_per_step=dev,
                device_busy_share=(dev / wall if dev else None),
                device_ms_per_step_all_events=dev_all,
                host_syncs_per_step=syncs,
                top_device_ops_ms_per_step=[(n[:100], v) for n, v in top],
                top_host_ops_self_ms_and_calls_per_step=[
                    (n[:100], ms, c) for n, ms, c in host_ops])


def phase_bias_path(torch, seed: int, card: str):
    """K5 on its path: a learnable T5 bias (`RelativePositionBias`,
    [1, 12, 512, 512]) fed as the attention mask of a 2-block encoder at
    BERT-base widths (flash, bf16, dropout 0.1) with a pooled head,
    trained a few Adam steps."""
    import torch.nn.functional as F
    from torch import nn

    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        RelativePositionBias,
        TransformerEncoder,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    widths = {k: BERT_BASE[k] for k in ("vocab", "hidden_size", "n_head",
                                         "intermediate_size",
                                         "max_position_len")}

    class BiasedEncoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.rel = RelativePositionBias(widths["n_head"], device="cuda")
            self.enc = TransformerEncoder(**widths, n_block=2,
                                          with_pooler=True,
                                          attn_impl="flash", device="cuda")
            self.head = nn.Linear(widths["hidden_size"], 2, device="cuda")

        def forward(self, ids, impl="auto", generator=None):
            bias = self.rel(ids.shape[1])
            _, pooled = self.enc(ids, None, None, bias, impl, generator)
            return self.head(pooled)

    torch.manual_seed(seed)
    model = BiasedEncoder()
    rng = np.random.default_rng(seed + 13)
    (ids, _, _), y, _ = train_batch(rng, TRAIN_BATCH, TRAIN_T,
                                    widths["vocab"])
    ids_card = torch.from_numpy(ids).cuda()
    y_card = torch.from_numpy(y).long().cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    grads = {}
    for impl in ("auto", "reference"):
        g = torch.Generator(device="cuda")
        g.set_state(gen.get_state())
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(ids_card, impl=impl, generator=g),
                        y_card).backward()
        grads[impl] = model.rel.weight.grad.detach().clone()
    diff = (grads["auto"] - grads["reference"]).abs().max()
    err = float(diff) / max(float(grads["reference"].abs().max()), 1e-30)
    # bf16 operands rounded at other places on each side (as the BERT
    # model's gate); the table's gradient sums every [t, t] cell's dbias
    check(err <= 0.1, f"bias path: the bias table's gradient differs from "
          f"the plain path by {err:.3e} of its largest element")
    model.zero_grad(set_to_none=True)
    n_steps = 3
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=1e-4,
                               seed=seed)
    kernels.reset_launch_counts()
    est.fit((np.concatenate([ids] * n_steps), np.concatenate([y] * n_steps)),
            epochs=1, batch_size=TRAIN_BATCH, shuffle=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts["flash_bwd_dbias"] == 2 * n_steps
          and counts["flash_bwd_dq"] == 2 * n_steps,
          f"bias path: launches {counts}, expected 2 K5 and 2 K4a per step "
          f"over {n_steps} steps")
    out = dict(label="learnable bias, 2 blocks", steps=n_steps,
               table_grad_rel_err=err, launches=counts,
               losses=[s["loss"] for s in est.engine.last_steps])
    print(f"bias path [{card}]: {out}", flush=True)
    return out, est, ((ids_card,), y_card)


# ----------------------------------------------------------------------
# phase 11: recommendation training
# ----------------------------------------------------------------------

#: bench.py's NCF cell (bench.py:65-79 and :163-176): NeuralCF at full
#: width, 30 steps of 65536 rows an epoch from the DEVICE store
NCF_CELL = dict(user_count=200_000, item_count=50_000, class_num=2,
                user_embed=64, item_embed=64, hidden_layers=(256, 256, 128),
                mf_embed=64)
NCF_BATCH = 65536
NCF_STEPS = 30
#: timed windows of (3 `fit` epochs; 30 plain steps), best of each taken
REC_WINDOWS = 5
#: the MovieLens-1M column layout of the reference's
#: apps/recommendation-wide-n-deep notebook; the batch is this script's
WND_COLUMNS = dict(
    wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
    wide_cross_cols=["age-gender"], wide_cross_dims=[100],
    indicator_cols=["genres", "gender"], indicator_dims=[19, 3],
    embed_cols=["userId", "itemId"], embed_in_dims=[6041, 3953],
    embed_out_dims=[64, 64], continuous_cols=["age"])
WND_HIDDEN = (40, 20, 10)
WND_BATCH = 16384
#: the JAX class's defaults (the reference's), with history, over 50,000
#: items (this script's choice, as is the batch)
SESSION_CELL = dict(item_count=50_000, item_embed=100,
                    rnn_hidden_layers=(40, 20), session_length=10,
                    include_history=True, mlp_hidden_layers=(40, 20),
                    history_length=5)
SESSION_BATCH = 4096
#: epochs of 30 steps the WideAndDeep and SessionRecommender data hold
REC_STEPS = 30
RANK_USERS = RANK_ITEMS = 100
RANK_TOP = 10


def ncf_data(n: int):
    """bench.py:72-77's generator: ids from 1, labels (u + i) % 2."""
    rng = np.random.default_rng(0)
    u = rng.integers(1, NCF_CELL["user_count"] + 1, n).astype(np.int32)
    i = rng.integers(1, NCF_CELL["item_count"] + 1, n).astype(np.int32)
    return u, i, ((u + i) % 2).astype(np.int32)


def wnd_data(rng, n: int):
    """Synthetic rows in the notebook's layout: ids inside each column's
    dim, the age as MovieLens-1M codes it; label (user + item) % 2."""
    cols = WND_COLUMNS
    gender = rng.integers(0, cols["wide_base_dims"][1], n)
    user = rng.integers(1, cols["embed_in_dims"][0], n)
    item = rng.integers(1, cols["embed_in_dims"][1], n)
    x = np.stack([rng.integers(0, cols["wide_base_dims"][0], n), gender,
                  rng.integers(0, cols["wide_cross_dims"][0], n),
                  rng.integers(0, cols["indicator_dims"][0], n), gender,
                  user, item,
                  rng.choice([1, 18, 25, 35, 45, 50, 56], n)], axis=1)
    return [x.astype(np.float32)], ((user + item) % 2).astype(np.int32)


def session_data(rng, n: int):
    count = SESSION_CELL["item_count"]
    s = rng.integers(1, count + 1, (n, SESSION_CELL["session_length"]))
    h = rng.integers(1, count + 1, (n, SESSION_CELL["history_length"]))
    y = rng.integers(1, count + 1, n)
    return [s.astype(np.int32), h.astype(np.int32)], y.astype(np.int32)


def rec_fit(torch, model, x, y, batch: int, epochs: int = 1,
            store: str = "DEVICE", optimizer: str = "adam",
            learning_rate=1e-3):
    """`epochs` of `optimizer` (Adam 1e-3 unless given; a None rate is
    the optimizer's default) through `model.estimator()`
    (Estimator.from_torch) on `store`, no shuffle; the Estimator."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    prev, OrcaContext.train_data_store = OrcaContext.train_data_store, store
    try:
        est = model.estimator(optimizer=optimizer,
                              learning_rate=learning_rate, metrics=[])
        est.fit({"x": x, "y": y}, epochs=epochs, batch_size=batch,
                shuffle=False)
    finally:
        OrcaContext.train_data_store = prev
    return est


def card_vs_cpu(torch, build, x, y, batch: int, label: str, card: str,
                optimizer: str = "adam", learning_rate=1e-3):
    """Gate (a): 3 steps at f32 from the same weights, the model on the
    card against the port on the CPU (an explicit reference run, not a
    fallback), a `fit` of one step, then one of two.  The same arithmetic
    summed in other orders (cuBLAS and cuDNN against the CPU's; TF32
    off): the per-step losses within 1e-5 absolute, and every parameter after the
    first step within 1e-5 (rounding of ~1e-11 in the gradients times
    Adam's gain near its eps, up to 1/eps).  After that step the two
    sides' weights differ by that much, and a ReLU whose pre-activation
    lies that close to zero may switch on one side only, replacing a
    gradient of ~1e-8 (a row of a mean over 65536 samples, near Adam's
    eps) by another; so the parameters after 3 steps are reported, not
    gated (on the CPU alone, two summation orders of NCF at batch 65536
    part so at step 3).  Returns the starting state."""
    state = {k: v.clone() for k, v in build("cpu").state_dict().items()}
    losses, first, last = [], [], []
    t0 = time.perf_counter()
    for device in ("cpu", "cuda"):
        model = build(device)
        model.load_state_dict(state)
        est = rec_fit(torch, model, [a[:batch] for a in x], y[:batch], batch,
                      optimizer=optimizer, learning_rate=learning_rate)
        steps = [s["loss"] for s in est.engine.last_steps]
        first.append({k: v.detach().cpu().double()
                      for k, v in model.state_dict().items()})
        est.fit({"x": [a[batch:3 * batch] for a in x],
                 "y": y[batch:3 * batch]}, batch_size=batch, shuffle=False)
        steps += [s["loss"] for s in est.engine.last_steps]
        last.append({k: v.detach().cpu().double()
                     for k, v in model.state_dict().items()})
        losses.append(steps)
        del model, est
    seconds = time.perf_counter() - t0

    def diffs(pair):
        return {k: (pair[1][k] - v).abs() for k, v in pair[0].items()}
    loss_err = max(abs(a - b) for a, b in zip(*losses))
    step1 = {k: float(d.max()) for k, d in diffs(first).items()}
    step3 = {k: (float(d.max()), int((d > 1e-5).sum()))
             for k, d in diffs(last).items()}
    moved = max(float((v - state[k].double()).abs().max())
                for k, v in first[0].items())
    check(len(losses[0]) == len(losses[1]) == 3 and loss_err <= 1e-5
          and max(step1.values()) <= 1e-5 and moved > 1e-4,
          f"{label} gate (a): card vs CPU at f32: losses {losses}, loss err "
          f"{loss_err}, param errs after step 1 {step1}, moved {moved}")
    print(f"{label} [{card}] gate (a) card vs CPU, f32: losses {losses[1]}; "
          f"max |loss diff| {loss_err:.3e} over 3 steps, max |param diff| "
          f"after step 1 {max(step1.values()):.3e} (gate 1e-5 each; params "
          f"moved up to {moved:.3e}); after step 3, not gated, (max |diff|, "
          f"elements past 1e-5): {step3}; {seconds:.2f} s", flush=True)
    return state, dict(losses=losses[1], loss_err=loss_err,
                       param_err_step1=max(step1.values()),
                       param_err_and_count_past_1e5_step3=step3,
                       seconds=seconds)


def best_fit_s(torch, est, x, y, batch: int, epochs: int, windows=None,
               between=None, data=None):
    """The shortest of `windows` (REC_WINDOWS) `fit` calls of `epochs`
    (each ends by reading its stats, a wait on the card) on `data`, or
    {"x": x, "y": y}; `between` runs after each."""
    best = float("inf")
    for _ in range(windows or REC_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.fit({"x": x, "y": y} if data is None else data, epochs=epochs,
                batch_size=batch, shuffle=False)
        best = min(best, time.perf_counter() - t0)
        if between is not None:
            between()
    return best


def fit_step_profile(torch, est, x, y, batch: int, steps: int, data=None):
    """Where a `fit` step's time goes: device time per step by device op
    and every device event summed, from a profiled one-epoch `fit` on
    `data` (or {"x": x, "y": y}), and the host reads inside it."""
    from torch.autograd import DeviceType
    _, per, prof = device_ms(
        lambda: est.fit({"x": x, "y": y} if data is None else data, epochs=1,
                        batch_size=batch, shuffle=False), iters=1)
    dev_all = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3 / steps
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize",
                             "aten::_local_scalar_dense")) / steps
    top = sorted(per.items(), key=lambda kv: -kv[1])[:14]
    return dict(device_ms_per_step_all_events=dev_all,
                host_syncs_per_step=syncs,
                top_device_ops_ms_per_step=[(n[:100], v / steps)
                                            for n, v in top])


def ncf_bound(n_params: int, n_embed: int, batch: int):
    """An NCF step's least time: the larger of the bytes a step must move
    (parameters and both Adam moments read and written once, the batch
    read once) over HBM, and the MLP's products (forward, and the two of
    the backward) over the bf16 peak; beside it the bytes this design
    moves, counting each once: Adam reading the gradients too (7 x 4 B a
    parameter), the dense embedding gradients' fill and the scatter of
    the batch's rows, and the two `_foreach_norm` passes."""
    widths = [NCF_CELL["user_embed"] + NCF_CELL["item_embed"],
              *NCF_CELL["hidden_layers"]]
    macs = sum(a * b for a, b in zip(widths, widths[1:])) + \
        NCF_CELL["class_num"] * (widths[-1] + NCF_CELL["mf_embed"])
    flops = 3 * 2 * macs * batch
    # the batch's rows of the four f32 tables
    rows = batch * 4 * (widths[0] + 2 * NCF_CELL["mf_embed"])
    least = 24 * n_params + 16 * batch
    design = 28 * n_params + 4 * n_embed + 2 * rows + 8 * n_params
    b_ms, b_by = bound(least, flops, BF16_FLOPS)
    return dict(bound_ms=b_ms, bound_by=b_by, least_bytes=least,
                flops=flops, design_bytes=design,
                design_bytes_ms=design / HBM_BYTES_PER_S * 1e3)


def check_ranking(torch, model, seed: int, card: str):
    """`recommend_for_user` over RANK_USERS x RANK_ITEMS pairs: RANK_TOP
    items a user, the output in descending (prediction, probability)."""
    from analytics_zoo_tpu_torch.models.recommendation import (
        UserItemFeature,
    )
    rng = np.random.default_rng(seed + 17)
    users = rng.choice(np.arange(1, NCF_CELL["user_count"] + 1), RANK_USERS,
                       replace=False)
    items = rng.choice(np.arange(1, NCF_CELL["item_count"] + 1), RANK_ITEMS,
                       replace=False)
    pairs = [UserItemFeature(u, i, None) for u in users for i in items]
    t0 = time.perf_counter()
    top = model.recommend_for_user(pairs, max_items=RANK_TOP,
                                   batch_size=NCF_BATCH)
    wall = time.perf_counter() - t0
    counts = {}
    for p in top:
        counts[p.user_id] = counts.get(p.user_id, 0) + 1
    keys = [(p.prediction, p.probability) for p in top]
    check(sorted(counts) == sorted(int(u) for u in users)
          and set(counts.values()) == {RANK_TOP}
          and keys == sorted(keys, reverse=True)
          and all(p.prediction in (1, 2) and 0.5 <= p.probability <= 1.0
                  for p in top),
          f"ranking: counts {sorted(set(counts.values()))} over "
          f"{len(counts)} users, or the order is not descending")
    print(f"ranking [{card}]: recommend_for_user over {len(pairs)} pairs, "
          f"{RANK_TOP} a user for {len(counts)} users, order descending by "
          f"(prediction, probability), in {wall:.3f} s; the first "
          f"{top[:2]}", flush=True)
    return dict(pairs=len(pairs), users=len(counts), top=RANK_TOP,
                wall_s=wall)


def phase_recommendation(torch, seed: int, card: str):
    """Phase 11: NCF at bench.py's cell through `Estimator.fit` from the
    DEVICE store (gates (a) card vs CPU at f32, (b) DEVICE vs DRAM at
    bf16, (c) the loss falls, (d) a second fit hits the cache), timed
    beside a plain PyTorch loop; WideAndDeep and SessionRecommender at
    their layouts (gate (a), samples/s); the ranking surface once."""
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.models.recommendation import (
        ColumnFeatureInfo,
        NeuralCF,
        SessionRecommender,
        WideAndDeep,
    )
    from analytics_zoo_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    prev = OrcaContext.train_data_store, OrcaContext.device_cache_bytes
    OrcaContext.train_data_store = "DEVICE"
    OrcaContext.device_cache_bytes = 1 << 30
    out = {}

    def ncf(device, dtype=torch.bfloat16):
        torch.manual_seed(seed)
        return NeuralCF(**NCF_CELL, compute_dtype=dtype, device=device)

    u, i, y = ncf_data(NCF_BATCH * NCF_STEPS)
    x = [u, i]
    state, gate_a = card_vs_cpu(torch, lambda device: ncf(device,
                                                          torch.float32),
                                x, y, NCF_BATCH, "NCF", card)

    # gate (b): one epoch from the same weights on each store, bf16
    model = ncf("cuda")
    model.load_state_dict(state)
    dram = ncf("cuda")
    dram.load_state_dict(state)
    est = rec_fit(torch, model, x, y, NCF_BATCH)
    dram_est = rec_fit(torch, dram, x, y, NCF_BATCH, store="DRAM")
    dev_losses = [s["loss"] for s in est.engine.last_steps]
    dram_losses = [s["loss"] for s in dram_est.engine.last_steps]
    store_err = max(abs(a - b) for a, b in zip(dev_losses, dram_losses))
    # the same batches through the same bf16 arithmetic on one card; only
    # where each batch is read from differs
    check(len(dev_losses) == len(dram_losses) == NCF_STEPS
          and store_err <= 1e-6 and len(est._device_cache) == 1,
          f"NCF gate (b): DEVICE {dev_losses} vs DRAM {dram_losses}")
    # gates (c), (d): two more warm-up epochs in a second fit on the
    # same arrays, a cache hit; the loss falls over the three
    est.fit({"x": x, "y": y}, epochs=2, batch_size=NCF_BATCH, shuffle=False)
    warm = [s["loss"] for s in est.train_summary]
    check(est.device_cache_hits == 1 and len(est._device_cache) == 1,
          f"NCF gate (d): cache hits {est.device_cache_hits}")
    check(len(warm) == 3 and all(np.isfinite(warm)) and warm[2] < warm[0],
          f"NCF gate (c): epoch losses {warm} did not fall")
    print(f"NCF [{card}] gate (b) DEVICE vs DRAM, bf16, {NCF_STEPS} steps: "
          f"max |loss diff| {store_err:.3e} (gate 1e-6); gate (c) epoch "
          f"losses {warm}; gate (d) cache hits {est.device_cache_hits}",
          flush=True)

    # the plain loop (bench.py:80's counterpart): the same model and
    # optimizer, NCF_STEPS distinct batches resident on the card
    raw = ncf("cuda")
    raw.load_state_dict(state)
    opt = torch.optim.Adam(raw.parameters(), lr=1e-3, fused=True)
    batches = [tuple(torch.from_numpy(a[s * NCF_BATCH:(s + 1) * NCF_BATCH])
                     .cuda().long() for a in (u, i, y))
               for s in range(NCF_STEPS)]

    def raw_steps(n=NCF_STEPS):
        for k in range(n):
            ub, ib, yb = batches[k % NCF_STEPS]
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(raw(ub, ib), yb)
            loss.backward()
            opt.step()
        return float(loss.detach())     # a read: the steps are done

    raw_steps(5)
    raw_times = []

    def time_raw():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw_steps()
        raw_times.append(time.perf_counter() - t0)

    fit_s = best_fit_s(torch, est, x, y, NCF_BATCH, 3, between=time_raw)
    check(est.device_cache_hits == 1 + REC_WINDOWS,
          f"NCF: a timed fit re-uploaded ({est.device_cache_hits} hits)")
    OrcaContext.train_data_store = "DRAM"
    dram_s = best_fit_s(torch, dram_est, x, y, NCF_BATCH, 1, windows=3)
    OrcaContext.train_data_store = "DEVICE"
    samples = NCF_BATCH * NCF_STEPS
    raw_s = min(raw_times)
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = sum(p.numel() for n, p in model.named_parameters()
                  if "embed" in n)
    step_ms = fit_s / (3 * NCF_STEPS) * 1e3
    prof = fit_step_profile(torch, est, x, y, NCF_BATCH, NCF_STEPS)
    prof["device_busy_share_of_fit_step"] = \
        prof["device_ms_per_step_all_events"] / step_ms
    (dds, _), = est._device_cache.values()
    out["ncf"] = dict(
        cell=NCF_CELL, batch=NCF_BATCH, steps_per_epoch=NCF_STEPS,
        params=n_params, dataset_bytes=dds.nbytes,
        fit_samples_per_s=3 * samples / fit_s,
        raw_samples_per_s=samples / raw_s,
        estimator_vs_raw=(3 * samples / fit_s) / (samples / raw_s),
        dram_samples_per_s=samples / dram_s, fit_step_ms=step_ms,
        raw_step_ms=raw_s / NCF_STEPS * 1e3,
        dram_step_ms=dram_s / NCF_STEPS * 1e3, gate_a=gate_a,
        gate_b_max_loss_diff=store_err, gate_c_epoch_losses=warm,
        gate_d_cache_hits=est.device_cache_hits, step_profile=prof,
        **ncf_bound(n_params, n_embed, NCF_BATCH))
    r = out["ncf"]
    print(f"NCF [{card}] bench.py's cell ({n_params} params, batch "
          f"{NCF_BATCH} x {NCF_STEPS} steps, {r['dataset_bytes']} bytes on "
          f"the card): fit {r['fit_samples_per_s']:.0f} samples/s "
          f"({step_ms:.4f} ms a step, best of {REC_WINDOWS} x 3 epochs), "
          f"plain loop {r['raw_samples_per_s']:.0f} samples/s "
          f"({r['raw_step_ms']:.4f} ms), estimator_vs_raw "
          f"{r['estimator_vs_raw']:.4f}; DRAM store "
          f"{r['dram_samples_per_s']:.0f} samples/s ({r['dram_step_ms']:.4f} "
          f"ms); device {prof['device_ms_per_step_all_events']:.4f} ms a "
          f"step (busy {prof['device_busy_share_of_fit_step']:.3f}); bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['least_bytes']} "
          f"bytes, {r['flops']} FLOPs), this design's bytes "
          f"{r['design_bytes']} = {r['design_bytes_ms']:.4f} ms", flush=True)
    print(f"NCF fit step profile [{card}]: {json.dumps(prof)}", flush=True)
    out["ranking"] = check_ranking(torch, model, seed, card)
    del raw, opt, batches, dram, dram_est

    # WideAndDeep at the notebook's layout, SessionRecommender at the
    # JAX defaults: gate (a), then samples/s on the DEVICE store
    rng = np.random.default_rng(seed + 13)
    cells = (
        ("wide_and_deep", WND_BATCH, wnd_data(rng, WND_BATCH * REC_STEPS),
         lambda device, dtype: WideAndDeep(
             ColumnFeatureInfo(**WND_COLUMNS), hidden_layers=WND_HIDDEN,
             compute_dtype=dtype, device=device)),
        # all f32, as the JAX module
        ("session_recommender", SESSION_BATCH,
         session_data(rng, SESSION_BATCH * REC_STEPS),
         lambda device, dtype: SessionRecommender(**SESSION_CELL,
                                                  device=device)))
    for name, batch, (xs, ys), make in cells:
        def build(device, dtype=torch.bfloat16, make=make):
            torch.manual_seed(seed)
            return make(device, dtype)
        state, gate = card_vs_cpu(
            torch, lambda device, build=build: build(device, torch.float32),
            xs, ys, batch, name, card)
        model = build("cuda")
        model.load_state_dict(state)
        est = rec_fit(torch, model, xs, ys, batch)
        best = best_fit_s(torch, est, xs, ys, batch, 1)
        losses = [s["loss"] for s in est.train_summary]
        check(all(np.isfinite(losses)) and est.device_cache_hits
              == REC_WINDOWS, f"{name}: losses {losses}, cache hits "
              f"{est.device_cache_hits}")
        step_ms = best / REC_STEPS * 1e3
        prof = fit_step_profile(torch, est, xs, ys, batch, REC_STEPS)
        prof["device_busy_share_of_fit_step"] = \
            prof["device_ms_per_step_all_events"] / step_ms
        out[name] = dict(batch=batch, steps_per_epoch=REC_STEPS,
                         params=sum(p.numel() for p in model.parameters()),
                         samples_per_s=batch * REC_STEPS / best,
                         step_ms=step_ms, epoch_losses=losses, gate_a=gate,
                         step_profile=prof)
        print(f"{name} [{card}] batch {batch}, {out[name]['params']} params: "
              f"{out[name]['samples_per_s']:.0f} samples/s through fit on "
              f"the DEVICE store ({step_ms:.4f} ms a step, best of "
              f"{REC_WINDOWS} epochs; device "
              f"{prof['device_ms_per_step_all_events']:.4f} ms a step, busy "
              f"{prof['device_busy_share_of_fit_step']:.3f}); epoch losses "
              f"{losses}", flush=True)
        print(f"{name} fit step profile [{card}]: {json.dumps(prof)}",
              flush=True)
        del model, est
    launches = kernels.launch_counts()
    check(not any(launches.values()),
          f"phase 11 launched a kernel of another path: {launches}")
    out["launches"] = launches
    OrcaContext.train_data_store, OrcaContext.device_cache_bytes = prev
    return out


# ----------------------------------------------------------------------
# phase 13: the data path (XShards, prefetch depth, the DISK tier)
# ----------------------------------------------------------------------

#: phase 13 (a)-(c): bench.py's NCF cell fed as XShards of 7 dict shards
#: (they do not divide the 30 batches: batches carry rows across edges)
DATA_SHARDS = 7
#: phase 13 (b): the host-input prefetch depths compared
DATA_DEPTHS = (0, 2)
#: phase 13 (d): 12 x 32 BERT rows in shards of uneven sizes
BERT_SHARD_ROWS = (100, 70, 90, 64, 60)
#: phase 13 (e): the optimizers written here, each at its registry rate
NEW_OPTIMIZERS = ("rmsprop", "adagrad", "adadelta")
#: phase 13 (e): steps of the one-logit fits with the new losses
LOSS_FIT_STEPS = 8


class _Warnings:
    """The messages `analytics_zoo_tpu_torch` logs at WARNING and above
    inside the block."""

    def __enter__(self):
        import logging

        class Keep(logging.Handler):
            def __init__(self, out):
                super().__init__(logging.WARNING)
                self.out = out

            def emit(self, record):
                self.out.append(record.getMessage())

        self.messages = []
        self.logger = logging.getLogger("analytics_zoo_tpu_torch")
        self.handler = Keep(self.messages)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def data_ncf_fit(torch, seed: int, data, store: str, depth: int,
                 optimizer="adam"):
    """One epoch of bench.py's cell from phase 11's starting weights
    through `Estimator.fit` on `store` at prefetch `depth`, no shuffle:
    (the Estimator, its per-step losses)."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    OrcaContext.train_data_store = store
    OrcaContext.host_input_prefetch = depth
    torch.manual_seed(seed)
    model = NeuralCF(**NCF_CELL, compute_dtype=torch.bfloat16, device="cuda")
    est = model.estimator(optimizer=optimizer, learning_rate=1e-3,
                          metrics=[])
    est.fit(data, epochs=1, batch_size=NCF_BATCH, shuffle=False)
    return est, [s["loss"] for s in est.engine.last_steps]


def skipped_step_on_card(torch, est, x, y, label: str):
    """One train step whose gradients are made non-finite (a hook
    multiplies one parameter's gradient by inf): the weights and the
    optimizer state stay bitwise as they were, the step is counted as
    skipped, and no host read happens inside it (profiled)."""
    from torch.profiler import ProfilerActivity, profile
    eng = est.engine
    model = eng.model
    before = params_of(model)
    state = {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in eng.opt.state.items()}
    batch = eng.put_batch({"features": tuple(a[:NCF_BATCH] for a in x),
                           "labels": (y[:NCF_BATCH],),
                           "mask": np.ones(NCF_BATCH, np.float32)})
    first = next(p for p in model.parameters() if p.requires_grad)
    hook = first.register_hook(lambda g: g * float("inf"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = eng.train_step(batch)
    hook.remove()
    # the profiler's own closing cudaDeviceSynchronize is not counted
    reads = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize",
                             "aten::_local_scalar_dense", "aten::item"))
    kept = all(torch.equal(p, before[n])
               for n, p in model.named_parameters())
    kept_state = all(torch.equal(v, state[id(p)][k])
                     for p, s in eng.opt.state.items() for k, v in s.items())
    skipped = float(stats["_nan_steps"])
    check(kept and kept_state and skipped == 1.0 and reads == 0,
          f"{label}: a non-finite step changed the weights ({not kept}) or "
          f"the optimizer state ({not kept_state}), skipped {skipped}, host "
          f"reads inside the step {reads}")
    return dict(weights_kept=kept, state_kept=kept_state,
                host_reads_in_step=reads)


def phase_data_path(torch, seed: int, card: str, rec: dict, train: dict):
    """Phase 13: Orca's data path on the card.  (a) bench.py's NCF cell
    from XShards of 7 dict shards (DRAM store) against the fit from the
    arrays, and under the DEVICE store (streamed, with JAX's warning);
    (b) host-input prefetch depth 0 against 2: bitwise losses under
    deterministic algorithms, samples/s through `fit`, the busy share,
    the pinned ring; (c) the DISK tier: bitwise losses, the spill
    directory gone with the XShards, samples/s; (e) RMSprop, Adagrad and
    Adadelta under phase 11's gate (a), a skipped non-finite step, and
    fits with binary_crossentropy and mse; no kernel launched in (a)-(c)
    and (e); (d) BERT-base fine-tuned from XShards of uneven shards:
    launches per step exact, losses bitwise those of a dict-input fit."""
    import gc
    import os

    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.data import XShards
    prev = (OrcaContext.train_data_store, OrcaContext.host_input_prefetch,
            OrcaContext.device_cache_bytes)
    OrcaContext.device_cache_bytes = 1 << 30
    out = {}
    samples = NCF_BATCH * NCF_STEPS
    u, i, y = ncf_data(samples)
    arrays = {"x": [u, i], "y": y}
    OrcaContext.train_data_store = "DRAM"
    shards = XShards.partition(arrays, num_shards=DATA_SHARDS)
    kernels.reset_launch_counts()

    # (a) XShards against the arrays, both streamed from the host
    _, from_arrays = data_ncf_fit(torch, seed, arrays, "DRAM", 2)
    est_xs, from_xs = data_ncf_fit(torch, seed, shards, "DRAM", 2)
    err_a = max(abs(a - b) for a, b in zip(from_xs, from_arrays))
    check(len(from_xs) == len(from_arrays) == NCF_STEPS and err_a <= 1e-6,
          f"phase 13 (a): XShards {from_xs} vs arrays {from_arrays}")
    with _Warnings() as warned:
        est_dev, from_dev = data_ncf_fit(torch, seed, shards, "DEVICE", 2)
    streamed = any("ignored for streaming input" in m
                   for m in warned.messages)
    err_dev = max(abs(a - b) for a, b in zip(from_dev, from_xs))
    check(streamed and not est_dev._device_cache
          and est_dev.device_cache_hits == 0 and err_dev <= 1e-6,
          f"phase 13 (a): DEVICE store with XShards: warned {streamed}, "
          f"cache {len(est_dev._device_cache)} entries, "
          f"{est_dev.device_cache_hits} hits, losses {from_dev}")
    del est_dev
    out["a"] = dict(shards=DATA_SHARDS, steps=NCF_STEPS,
                    max_loss_diff_vs_arrays=err_a,
                    device_store_streamed_with_warning=streamed,
                    device_store_max_loss_diff=err_dev, losses=from_xs)
    print(f"data path [{card}] (a) NCF from {DATA_SHARDS} XShards, "
          f"{NCF_STEPS} steps of {NCF_BATCH}: max |loss diff| vs the arrays "
          f"{err_a:.3e} (gate 1e-6); DEVICE store streamed with the "
          f"warning, no cache entry, max |loss diff| {err_dev:.3e}",
          flush=True)

    # (b) prefetch depth: bitwise under deterministic algorithms
    with deterministic(torch):
        det = {d: data_ncf_fit(torch, seed, shards, "DRAM", d)[1]
               for d in DATA_DEPTHS}
    check(det[0] == det[2], f"phase 13 (b): depth 0 losses {det[0]} vs "
          f"depth 2 {det[2]}")
    # samples/s through fit: one Estimator a depth, windows in turns
    ests = {("xshards", d): data_ncf_fit(torch, seed, shards, "DRAM", d)[0]
            for d in DATA_DEPTHS}
    for d in DATA_DEPTHS:
        ests[("arrays", d)] = data_ncf_fit(torch, seed, arrays, "DRAM", d)[0]
    best = dict.fromkeys(ests, float("inf"))
    for _ in range(REC_WINDOWS):
        for (kind, d), est in ests.items():
            OrcaContext.host_input_prefetch = d
            data = shards if kind == "xshards" else arrays
            best[(kind, d)] = min(best[(kind, d)], best_fit_s(
                torch, est, None, None, NCF_BATCH, 1, windows=1, data=data))
    rates = {f"{kind}_depth{d}": samples / s for (kind, d), s in best.items()}
    ring = ests[("xshards", 2)].engine.ring.stats()
    profiles = {}
    for d in DATA_DEPTHS:
        OrcaContext.host_input_prefetch = d
        step_ms = best[("xshards", d)] / NCF_STEPS * 1e3
        prof = fit_step_profile(torch, ests[("xshards", d)], None, None,
                                NCF_BATCH, NCF_STEPS, data=shards)
        prof["fit_step_ms"] = step_ms
        prof["device_busy_share_of_fit_step"] = \
            prof["device_ms_per_step_all_events"] / step_ms
        profiles[d] = prof
    ncf = rec["ncf"]
    out["b"] = dict(bitwise_equal_depths=True, losses_depth0=det[0],
                    samples_per_s=rates,
                    phase11_dram_samples_per_s=ncf["dram_samples_per_s"],
                    phase11_device_samples_per_s=ncf["fit_samples_per_s"],
                    busy_share={d: profiles[d]
                                ["device_busy_share_of_fit_step"]
                                for d in DATA_DEPTHS},
                    profiles=profiles, pinned_ring=ring)
    print(f"data path [{card}] (b) prefetch depth 0 vs 2: losses bitwise "
          f"equal over {NCF_STEPS} steps (deterministic algorithms); "
          f"samples/s through fit (best of {REC_WINDOWS} one-epoch "
          f"windows, in turns): XShards depth 0 "
          f"{rates['xshards_depth0']:.0f}, depth 2 "
          f"{rates['xshards_depth2']:.0f}, arrays depth 0 "
          f"{rates['arrays_depth0']:.0f}, depth 2 "
          f"{rates['arrays_depth2']:.0f}; phase 11 in this run: DRAM store "
          f"{ncf['dram_samples_per_s']:.0f}, DEVICE store "
          f"{ncf['fit_samples_per_s']:.0f}; busy share depth 0 "
          f"{out['b']['busy_share'][0]:.3f}, depth 2 "
          f"{out['b']['busy_share'][2]:.3f}; pinned ring {ring}", flush=True)
    for d in DATA_DEPTHS:
        print(f"data path fit step profile depth {d} [{card}]: "
              f"{json.dumps(profiles[d])}", flush=True)
    del ests, est_xs

    # (c) the DISK tier: shards pickled to a temp dir, loaded on the
    # IO thread
    OrcaContext.train_data_store = "DISK_2"
    disk = XShards.partition(arrays, num_shards=DATA_SHARDS)
    spill = disk._store._dir
    spilled = len(os.listdir(spill))
    with deterministic(torch):
        _, from_disk = data_ncf_fit(torch, seed, disk, "DISK_2", 2)
    check(from_disk == det[2], f"phase 13 (c): DISK tier losses {from_disk} "
          f"vs the DRAM tier's {det[2]}")
    est_disk, _ = data_ncf_fit(torch, seed, disk, "DISK_2", 2)
    disk_s = best_fit_s(torch, est_disk, None, None, NCF_BATCH, 1,
                        data=disk)
    del disk, est_disk
    gc.collect()
    gone = not os.path.exists(spill)
    check(spilled == DATA_SHARDS and gone, f"phase 13 (c): {spilled} files "
          f"spilled, directory removed {gone}")
    out["c"] = dict(bitwise_equal_dram_tier=True, spilled_files=spilled,
                    spill_dir_removed=gone, samples_per_s=samples / disk_s)
    print(f"data path [{card}] (c) DISK_2 tier: {spilled} shards pickled, "
          f"losses bitwise equal to the DRAM tier's, the spill directory "
          f"removed with the XShards; {samples / disk_s:.0f} samples/s "
          f"through fit (best of {REC_WINDOWS})", flush=True)

    # (e) the optimizers written here, on the card against the CPU
    OrcaContext.train_data_store = "DRAM"
    OrcaContext.host_input_prefetch = 2
    out["e"] = {}
    for name in NEW_OPTIMIZERS:
        def build(device, name=name):
            torch.manual_seed(seed)
            return NeuralCF(**NCF_CELL, compute_dtype=torch.float32,
                            device=device)
        state, gate = card_vs_cpu(torch, build, [u, i], y, NCF_BATCH,
                                  f"NCF {name}", card, optimizer=name,
                                  learning_rate=None)
        model = build("cuda")
        model.load_state_dict(state)
        est = rec_fit(torch, model, [a[:NCF_BATCH] for a in (u, i)],
                      y[:NCF_BATCH], NCF_BATCH, store="DRAM", optimizer=name,
                      learning_rate=None)
        gate["skipped_step"] = skipped_step_on_card(torch, est, [u, i], y,
                                                    f"NCF {name}")
        out["e"][name] = gate
        print(f"data path [{card}] (e) {name}: a non-finite step left the "
              f"weights and the optimizer state bitwise, no host read in "
              f"the step", flush=True)
        del model, est
    n_rows = NCF_BATCH * LOSS_FIT_STEPS
    for loss in ("binary_crossentropy", "mse"):
        torch.manual_seed(seed)
        model = NeuralCF(**dict(NCF_CELL, class_num=1),
                         compute_dtype=torch.bfloat16, device="cuda")
        est = model.estimator(loss=loss, optimizer="adam",
                              learning_rate=1e-3, metrics=[])
        est.fit(XShards.partition({"x": [u[:n_rows], i[:n_rows]],
                                   "y": y[:n_rows].astype(np.float32)},
                                  num_shards=DATA_SHARDS),
                epochs=3, batch_size=NCF_BATCH, shuffle=True)
        epochs = [s["loss"] for s in est.train_summary]
        check(all(np.isfinite(epochs)) and epochs[2] < epochs[0],
              f"phase 13 (e): {loss} epoch losses {epochs} did not fall")
        out["e"][loss] = dict(epoch_losses=epochs)
        print(f"data path [{card}] (e) one-logit NCF with {loss} from "
              f"XShards, 3 epochs of {LOSS_FIT_STEPS} steps: epoch losses "
              f"{epochs}", flush=True)
        del model, est
    out["f"] = bn_skip_on_card(torch, seed, card)
    launches = kernels.launch_counts()
    check(not any(launches.values()),
          f"phase 13 (a)-(c), (e), (f) launched a kernel: {launches}")
    out["launches_recommendation"] = launches

    # (d) BERT-base fine-tuned from XShards of uneven shards
    out["d"] = phase_data_bert(torch, seed, card, train)
    (OrcaContext.train_data_store, OrcaContext.host_input_prefetch,
     OrcaContext.device_cache_bytes) = prev
    return out


#: ResNet-50's BatchNorm widths (stem, then each stage's bottlenecks
#: and its downsample): 53 layers, 159 buffers
RESNET50_BN = ([64] + [64, 64, 256] * 3 + [256] + [128, 128, 512] * 4
               + [512] + [256, 256, 1024] * 6 + [1024] + [512, 512, 2048] * 3
               + [2048])


def bn_skip_on_card(torch, seed: int, card: str) -> dict:
    """Phase 13 (f): a BatchNorm model's non-finite step on the card
    leaves its running stats and count as the finite steps left them
    (DRAM and DEVICE stores), and what the engine's buffer snapshot and
    restore cost a step on ResNet-50's 53 BatchNorm layers."""
    from torch import nn

    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    from analytics_zoo_tpu_torch.orca.learn.spmd import (
        restore_buffers,
        snapshot_buffers,
    )
    rng = np.random.default_rng(seed + 60)
    n, batch = 1024, 256
    x = rng.normal(size=(n, 64)).astype(np.float32)
    x[2 * batch:3 * batch] = np.nan           # the third step's rows
    y = rng.integers(0, 10, n).astype(np.int32)
    out = {}
    prev = OrcaContext.train_data_store
    try:
        for store in ("DRAM", "DEVICE"):
            OrcaContext.train_data_store = store
            torch.manual_seed(seed)
            m = nn.Sequential(nn.Linear(64, 256), nn.BatchNorm1d(256),
                              nn.ReLU(), nn.Linear(256, 10)).cuda()
            est = Estimator.from_torch(
                m, loss="sparse_categorical_crossentropy", optimizer="sgd",
                learning_rate=0.1)
            est.fit({"x": x, "y": y}, epochs=1, batch_size=batch,
                    shuffle=False)
            bn = m[1]
            nan_steps = est.train_summary[-1].get("nan_steps", 0)
            finite = bool(torch.isfinite(bn.running_mean).all()
                          and torch.isfinite(bn.running_var).all())
            # four steps, the third skipped: the count is 3
            check(nan_steps == 1 and int(bn.num_batches_tracked) == 3
                  and finite,
                  f"phase 13 (f) {store}: {nan_steps} skipped steps, count "
                  f"{int(bn.num_batches_tracked)}, running stats finite "
                  f"{finite}")
            pred = est.predict({"x": x[:batch]}, batch_size=batch)
            check(bool(np.isfinite(pred).all()),
                  f"phase 13 (f) {store}: non-finite predictions after the "
                  "skipped step")
            out[store] = dict(nan_steps=nan_steps,
                              num_batches_tracked=int(
                                  bn.num_batches_tracked))
            del m, est
    finally:
        OrcaContext.train_data_store = prev
    # the snapshot and restore of ResNet-50's BatchNorm buffers, on a
    # skipped step (where keeps the old values)
    bns = nn.Sequential(*(nn.BatchNorm2d(c) for c in RESNET50_BN)).cuda()
    skipped = torch.zeros((), dtype=torch.bool, device="cuda")
    n_buf = sum(1 for _ in bns.buffers())

    def snap_restore():
        restore_buffers(bns, snapshot_buffers(bns), skipped)

    host_ms = cuda_ms(snap_restore, iters=100, warm=10)
    dev_ms, _, _ = device_ms(snap_restore, iters=20)
    out["snapshot_resnet50_bn"] = dict(layers=len(RESNET50_BN),
                                       buffers=n_buf, call_ms=host_ms,
                                       device_ms=dev_ms)
    print(f"data path [{card}] (f) a BatchNorm model's non-finite step left "
          f"its running stats and count (DRAM and DEVICE stores); the "
          f"buffer snapshot and restore on ResNet-50's {len(RESNET50_BN)} "
          f"BatchNorm layers ({n_buf} buffers): {host_ms:.4f} ms a step "
          f"between CUDA events, {dev_ms} ms of device work", flush=True)
    return out


def phase_data_bert(torch, seed: int, card: str, train: dict):
    """Phase 13 (d): phase 8's model and recipe fed XShards of 12 x 32
    rows in shards of BERT_SHARD_ROWS, against a dict-input fit over the
    same rows (both under deterministic algorithms); launches per step
    exact; step p50 from CUDA events as each step is queued."""
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.data import XShards
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    cfg = dict(BERT_BASE, num_classes=2)
    vocab, n_blk = cfg["vocab"], cfg["n_block"]
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    steps = sum(BERT_SHARD_ROWS) // TRAIN_BATCH
    rng = np.random.default_rng(seed + 29)
    (ids, seg, mask), y, _ = train_batch(rng, steps * TRAIN_BATCH, TRAIN_T,
                                         vocab)
    edges = np.cumsum((0,) + BERT_SHARD_ROWS)
    shards = XShards([{"x": (ids[a:b], seg[a:b], mask[a:b]), "y": y[a:b]}
                      for a, b in zip(edges, edges[1:])])

    def fit(data, marks=None):
        model = BERTClassifier(**cfg, attn_impl="flash", device="cuda")
        model.load_state_dict(state)
        est = Estimator.from_torch(
            model, loss="sparse_categorical_crossentropy", optimizer="adam",
            learning_rate=2e-5, metrics=["accuracy"], seed=seed)
        if marks is not None:
            eng = est.engine

            def marked_step(batch, step=eng.train_step):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                return step(batch)
            eng.train_step = marked_step
        est.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False)
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        torch.cuda.synchronize()
        return [s["loss"] for s in est.engine.last_steps]

    with deterministic(torch):
        want = fit({"x": [ids, seg, mask], "y": y})
        free_card(torch)
        kernels.reset_launch_counts()
        got = fit(shards)
        counts = kernels.launch_counts()
    free_card(torch)
    per_step = {"layer_norm_fwd": 2 * n_blk + 1,
                "layer_norm_bwd": 2 * n_blk + 1, "fused_dense_gelu": n_blk,
                "flash_fwd": n_blk, "flash_bwd_dq": n_blk,
                "flash_bwd_dkv": n_blk, "flash_bwd_dbias": 0,
                "paged_decode": 0}
    want_counts = {k: v * steps for k, v in per_step.items()}
    check(counts == want_counts, f"phase 13 (d): launches {counts}, "
          f"expected {want_counts} for {steps} steps")
    bodies = k2_bodies("phase 13 (d)", counts)
    check(got == want and len(got) == steps and all(np.isfinite(got)),
          f"phase 13 (d): XShards losses {got} vs the dict input's {want}")
    # the step period with PyTorch's default algorithms, as phase 8 times
    # it, XShards and the dict input over the same rows in turns
    periods = {"xshards": [], "dict": []}
    for kind in ("xshards", "dict", "dict", "xshards"):
        marks = []
        fit(shards if kind == "xshards" else {"x": [ids, seg, mask], "y": y},
            marks)
        free_card(torch)
        periods[kind].append([a.elapsed_time(b) for a, b in zip(
            marks[TRAIN_WARM:-1], marks[TRAIN_WARM + 1:])])
    p50 = {k: min(statistics.median(t) for t in v)
           for k, v in periods.items()}
    out = dict(shard_rows=list(BERT_SHARD_ROWS), steps=steps,
               losses=got, bitwise_equal_dict_input=True, launches=counts,
               launches_per_step={k: v / steps for k, v in counts.items()},
               k2_launches_by_body=bodies, step_ms_p50=p50["xshards"],
               dict_input_step_ms_p50=p50["dict"], step_ms=periods,
               phase8_step_ms_p50=train["step_ms_p50"])
    print(f"data path [{card}] (d) BERT-base fine-tune from XShards of "
          f"{list(BERT_SHARD_ROWS)} rows, batch {TRAIN_BATCH} x t = "
          f"{TRAIN_T}, {steps} steps: losses bitwise those of the dict "
          f"input (deterministic algorithms); launches per step "
          f"{out['launches_per_step']}; step p50 {p50['xshards']:.3f} ms, "
          f"the dict input over the same rows {p50['dict']:.3f} ms (the "
          f"better of 2 fits each, in turns, {len(periods['dict'][0])} "
          f"steps a fit); phase 8's repeated batch in this run "
          f"{train['step_ms_p50']:.3f} ms", flush=True)
    return out


# ----------------------------------------------------------------------
# phase 12: the BERT-base fine-tune with the full fit surface
# ----------------------------------------------------------------------

#: remat configurations of phase 12: (label, remat, remat_policy)
REMAT_CASES = (("off", False, None), ("none", True, None),
               ("dots", True, "dots"), ("dots_all", True, "dots_all"))
#: the batches phase 12 (c) times each configuration at (phase 8's batch
#: of 32, and it repeated 4 times)
REMAT_BATCHES = (32, 128)
FIT_WARM, FIT_TIMED = 2, 8
#: phase 12 (d): AdamWeightDecay(2e-5) under Warmup(5, 20), 20 steps
SCHED_LR, SCHED_WARMUP, SCHED_STEPS = 2e-5, 5, 20
#: phase 12 (e): 2 epochs of 10 steps, a raise at train.step hit 15
RESUME_EPOCHS, RESUME_STEPS, RESUME_FAULT_HIT = 2, 10, 15


def fit_surface_model(torch, cfg, state, remat=False, policy=None):
    from analytics_zoo_tpu_torch.models.bert import BERTClassifier
    model = BERTClassifier(**cfg, attn_impl="flash", remat=remat,
                           remat_policy=policy, device="cuda")
    model.load_state_dict(state)
    return model


def fit_surface_estimator(model, seed: int, optimizer=None, **kw):
    """The Estimator of phase 12: phase 8's Adam 2e-5 unless given
    another optimizer."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator, optimizers
    return Estimator.from_torch(
        model, loss="sparse_categorical_crossentropy",
        optimizer=optimizer or optimizers.Adam(2e-5),
        metrics=["accuracy"], seed=seed, **kw)


def free_card(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def max_abs_diff(torch, got: dict, want: dict) -> float:
    """max over parameters of max |got - want| (gradients or params)."""
    check(got.keys() == want.keys(), "different parameter sets")
    return max(float((got[n].float() - want[n].float()).abs().max())
               for n in want)


def remat_step(torch, cfg, state, seed, inputs, y, remat, policy):
    """One fine-tune step through `TrainEngine.train_step` from the
    weights `state` and a fresh engine's generator (seeded by `seed`):
    (gradients, the generator's state after the step, launches)."""
    from analytics_zoo_tpu_torch.ops import kernels
    model = fit_surface_model(torch, cfg, state, remat, policy)
    est = fit_surface_estimator(model, seed)
    eng = est.engine
    host = {"features": tuple(inputs), "labels": (y,),
            "mask": np.ones(len(y), np.float32)}
    batch = eng.put_batch(host)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    eng.train_step(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    bodies = k2_bodies(f"phase 12 (b) remat {remat} {policy}", counts)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    gen_state = eng.generator.get_state()
    del model, est, eng, batch
    free_card(torch)
    return grads, gen_state, counts, bodies


def timed_fit(torch, est, data, batch: int):
    """`fit` of FIT_WARM + FIT_TIMED steps with a CUDA event as each step
    is queued (phase 8's timing), the peak of allocated card memory over
    it (reset before) and the launches it made: (step times in s, peak
    bytes, bytes allocated before, launches)."""
    from analytics_zoo_tpu_torch.ops import kernels
    eng = est.engine
    marks = []

    def marked_step(b, step=eng.train_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(b)

    eng.train_step = marked_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    est.fit(data, epochs=1, batch_size=batch, shuffle=False)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.launch_counts()
    del eng.train_step
    times = [a.elapsed_time(b) / 1e3
             for a, b in zip(marks[FIT_WARM:-1], marks[FIT_WARM + 1:])]
    return times, peak, base, counts


def remat_launches_want(n_blk: int, remat: bool, steps: int) -> dict:
    """Launches of `steps` fine-tune steps: with remat every block's two
    LayerNorms, fc1 + GELU and flash forward run again in the backward."""
    again = n_blk if remat else 0
    return {"layer_norm_fwd": (2 * n_blk + 1 + 2 * again) * steps,
            "layer_norm_bwd": (2 * n_blk + 1) * steps,
            "fused_dense_gelu": (n_blk + again) * steps,
            "flash_fwd": (n_blk + again) * steps,
            "flash_bwd_dq": n_blk * steps, "flash_bwd_dkv": n_blk * steps,
            "flash_bwd_dbias": 0, "paged_decode": 0}


def warmup_lr(step: int, dtype) -> float:
    """optax's warmup_cosine_decay_schedule(0, SCHED_LR, SCHED_WARMUP,
    SCHED_STEPS) at count `step` (0-based), each operation in `dtype`
    (np.float32 as optax computes it, the cosine of the f32 angle
    rounded once; np.float64 for the exact value)."""
    f = dtype
    c = f(step)
    if c < SCHED_WARMUP:
        frac = f(1) - c / f(SCHED_WARMUP)
        return float(f(0.0 - SCHED_LR) * frac + f(SCHED_LR))
    decay = SCHED_STEPS - SCHED_WARMUP
    c = min(c - f(SCHED_WARMUP), f(decay))
    angle = f(np.pi) * c / f(decay)
    cos = f(np.cos(np.float64(angle)))
    return float(f(SCHED_LR) * (f(0.5) * (f(1) + cos)))


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms on (warning where an op has
    none): on the card the CUDA embedding backward sums the segment
    table's 8,192 duplicate rows a step in a varying order otherwise,
    the one gradient of the step two runs do not reproduce bit for bit,
    and Adam spreads that into every weight within a few steps."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def params_of(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def ckpt_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def phase_fit_surface(torch, seed: int, card: str):
    """Phase 12: BERT-base fine-tuning (phase 8's model and batch) with
    the rest of the fit surface: (a) remat replays the step, (b) its
    launches per step, (c) peak memory and step time per remat policy at
    two batches, (d) a Warmup schedule, (e) a checkpointed fit that
    fails once and resumes, with the save and load costs, (f)
    validation data."""
    import os
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import optimizers
    from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
        load_checkpoint,
    )
    from analytics_zoo_tpu_torch.resilience import (
        get_background_checkpointer,
    )
    cfg = dict(BERT_BASE, num_classes=2)
    n_blk = cfg["n_block"]
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    state = {k: v.cuda() for k, v in state.items()}
    rng = np.random.default_rng(seed + 11)       # phase 8's batch
    inputs, y, valid = train_batch(rng, TRAIN_BATCH, TRAIN_T, cfg["vocab"])
    out = dict(batch=TRAIN_BATCH, t=TRAIN_T, valid_tokens=valid, card=card)

    # (a), (b): the first step with remat off twice (the spread), then
    # under each policy; gradients, generator state and launches.  The
    # spread of PyTorch's default algorithms is recorded first; the gate
    # runs with its deterministic ones
    pair = [remat_step(torch, cfg, state, seed, inputs, y, False, None)[0]
            for _ in range(2)]
    default_spread = {n: float((pair[1][n] - pair[0][n]).abs().max())
                      for n in pair[0]
                      if not torch.equal(pair[1][n], pair[0][n])}
    del pair
    free_card(torch)
    steps = {}
    with deterministic(torch):
        for label, remat, policy in (REMAT_CASES[0],) + REMAT_CASES:
            key = label if label not in steps else "off_again"
            steps[key] = remat_step(torch, cfg, state, seed, inputs, y,
                                    remat, policy)
    ref_grads, ref_state = steps["off"][0], steps["off"][1]
    spread = max_abs_diff(torch, steps["off_again"][0], ref_grads)
    check(torch.equal(steps["off_again"][1], ref_state),
          "phase 12 (a): two no-remat steps left the generator in "
          "different states")
    replay = {}
    for label, remat, policy in REMAT_CASES:
        grads, gen_state, counts, bodies = steps[label]
        err = max_abs_diff(torch, grads, ref_grads)
        check(err <= spread, f"phase 12 (a) remat {label}: gradients "
              f"differ from no remat by {err:.3e}, over the determinism "
              f"spread {spread:.3e}")
        check(torch.equal(gen_state, ref_state),
              f"phase 12 (a) remat {label}: the generator's state after "
              "the step differs from no remat's")
        want = remat_launches_want(n_blk, remat, 1)
        check(counts == want, f"phase 12 (b) remat {label}: launches "
              f"{counts}, expected {want}")
        replay[label] = dict(max_abs_grad_diff=err, launches=counts,
                             k2_launches_by_body=bodies)
    out["replay"] = dict(determinism_spread=spread,
                         default_algorithms_spread_by_param=default_spread,
                         by_policy=replay)
    del steps, ref_grads
    free_card(torch)
    print(f"phase 12 (a, b) [{card}] remat replay: determinism spread "
          f"{spread:.3e} (PyTorch's default algorithms: {default_spread}); "
          f"{json.dumps(replay)}", flush=True)

    # (c): peak memory and step time per configuration at two batches
    n_steps = FIT_WARM + FIT_TIMED
    mem = {}
    for batch in REMAT_BATCHES:
        reps = batch // TRAIN_BATCH
        x = [np.concatenate([a] * (reps * n_steps)) for a in inputs]
        data = {"x": x, "y": np.concatenate([y] * (reps * n_steps))}
        rows = {}
        for label, remat, policy in REMAT_CASES:
            model = fit_surface_model(torch, cfg, state, remat, policy)
            est = fit_surface_estimator(model, seed)
            times, peak, base, counts = timed_fit(torch, est, data, batch)
            want = remat_launches_want(n_blk, remat, n_steps)
            check(counts == want, f"phase 12 (c) remat {label} batch "
                  f"{batch}: launches {counts}, expected {want}")
            k2_bodies(f"phase 12 (c) remat {label}", counts)
            losses = [s["loss"] for s in est.engine.last_steps]
            check(all(np.isfinite(losses)), f"phase 12 (c): losses {losses}")
            p50 = statistics.median(times)
            rows[label] = dict(
                step_ms_p50=p50 * 1e3, step_ms=[t * 1e3 for t in times],
                peak_bytes=peak, bytes_before=base,
                step_peak_bytes=peak - base,
                padded_tokens_per_s=batch * TRAIN_T / p50,
                launches=counts)
            if batch == TRAIN_BATCH and label == "none":
                out["launches"] = counts          # the path's own count
            del model, est
            free_card(torch)
        # the peak over the fit less what was allocated before it (the
        # weights): gradients, Adam's moments, activations, temporaries
        peaks = {k: r["step_peak_bytes"] for k, r in rows.items()}
        check(peaks["none"] < peaks["dots"] <= peaks["dots_all"]
              < peaks["off"], f"phase 12 (c) batch {batch}: peak memory "
              f"{peaks} out of order none < dots <= dots_all < off")
        mem[batch] = rows
        print(f"phase 12 (c) [{card}] batch {batch} x t = {TRAIN_T}: " +
              "; ".join(f"{k} p50 {r['step_ms_p50']:.3f} ms, peak "
                        f"{r['peak_bytes'] / 2**30:.3f} GiB (over the "
                        f"weights {r['step_peak_bytes'] / 2**30:.3f})"
                        for k, r in rows.items()), flush=True)
    out["memory_and_time"] = mem

    # (d): the Warmup schedule over a 20-step fit
    kernels.reset_launch_counts()
    model = fit_surface_model(torch, cfg, state)
    est = fit_surface_estimator(model, seed, optimizers.AdamWeightDecay(
        SCHED_LR, learningrate_schedule=optimizers.Warmup(
            SCHED_WARMUP, SCHED_STEPS)))
    initial = params_of(model)
    after_first = {}
    eng = est.engine

    def first_step(b, step=eng.train_step):
        stats = step(b)
        if not after_first:
            after_first.update(params_of(model))
        return stats

    eng.train_step = first_step
    data = {"x": [np.concatenate([a] * SCHED_STEPS) for a in inputs],
            "y": np.concatenate([y] * SCHED_STEPS)}
    est.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False,
            profile=True)
    del eng.train_step
    lrs = [r["lr"] for r in est.profile_stats]

    def ulps(got, want):
        return [abs(g - w) / float(np.spacing(np.float32(w))) if w else
                (0.0 if g == 0.0 else float("inf"))
                for g, w in zip(got, want)]

    # optax's f32 formula is itself up to ~20 f32 ulps from the exact
    # value where 1 + cos cancels (the cosine's tail): the card is held
    # to the f32 formula on the host, and its distance from the f64
    # value is reported
    want = [warmup_lr(i, np.float32) for i in range(SCHED_STEPS)]
    exact = [warmup_lr(i, np.float64) for i in range(SCHED_STEPS)]
    off_f32, off_f64 = ulps(lrs, want), ulps(lrs, exact)
    check(len(lrs) == SCHED_STEPS and max(off_f32) <= 4,
          f"phase 12 (d): learning rates {lrs} against optax's f32 formula "
          f"{want}: {max(off_f32)} f32 ulps apart, over 4")
    unmoved = max_abs_diff(torch, after_first, initial)
    check(unmoved == 0.0, f"phase 12 (d): the step at lr 0 moved the "
          f"parameters by up to {unmoved:.3e}")
    moved = max_abs_diff(torch, params_of(model), initial)
    check(moved > 0.0, "phase 12 (d): 20 steps did not move the weights")
    out["schedule"] = dict(lrs=lrs, want_f32=want, want_f64=exact,
                           max_ulps_from_f32=max(off_f32),
                           ulps_from_f64=off_f64,
                           first_step_moved=unmoved, moved=moved,
                           step_ms=[r["step_time_s"] * 1e3
                                    for r in est.profile_stats])
    del model, est, eng, initial, after_first
    free_card(torch)
    print(f"phase 12 (d) [{card}] Warmup({SCHED_WARMUP}, {SCHED_STEPS}) at "
          f"{SCHED_LR}: lrs {lrs}, at most {max(off_f32):.2f} f32 ulps from "
          f"optax's f32 formula on the host ({max(off_f64):.2f} from its "
          f"f64 value); the lr-0 step moved nothing", flush=True)

    # (e): checkpoint, failure and resume; (f): validation data
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    prev = (OrcaContext.failure_retry_interval_s,
            OrcaContext.background_checkpointing,
            os.environ.get("ZOO_ASYNC_CHECKPOINT"))
    try:
        OrcaContext.failure_retry_interval_s = 0.0
        data = {"x": [np.concatenate([a] * RESUME_STEPS) for a in inputs],
                "y": np.concatenate([y] * RESUME_STEPS)}

        def resume_estimator(model_dir=None):
            return fit_surface_estimator(
                fit_surface_model(torch, cfg, state), seed,
                optimizers.AdamWeightDecay(
                    SCHED_LR, learningrate_schedule=optimizers.Warmup(
                        2, RESUME_EPOCHS * RESUME_STEPS)),
                model_dir=model_dir)

        ref = resume_estimator()
        t0 = time.perf_counter()
        with deterministic(torch):
            ref.fit(data, epochs=RESUME_EPOCHS, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        ref_params = params_of(ref.get_model())
        del ref
        free_card(torch)
        model_dir = os.path.join(tmp, "run")
        est = resume_estimator(model_dir)
        OrcaContext.fault_plan = {"faults": [
            {"site": "train.step", "at": RESUME_FAULT_HIT,
             "action": "raise"}]}
        t0 = time.perf_counter()
        try:
            with deterministic(torch):
                est.fit(data, epochs=RESUME_EPOCHS, batch_size=TRAIN_BATCH)
        finally:
            OrcaContext.fault_plan = None
        torch.cuda.synchronize()
        fit_wall = time.perf_counter() - t0
        diff = max_abs_diff(torch, params_of(est.get_model()), ref_params)
        check(est.retries == 1 and est.epoch == RESUME_EPOCHS,
              f"phase 12 (e): retries {est.retries}, epoch {est.epoch}")
        check(diff <= spread, f"phase 12 (e): the resumed fit's parameters "
              f"differ from an uninterrupted fit's by {diff:.3e}, over the "
              f"determinism spread {spread:.3e}")
        versions = sorted(n for n in os.listdir(model_dir)
                          if n.startswith("ckpt-") and "." not in n)
        check(versions == [f"ckpt-{RESUME_STEPS}",
                           f"ckpt-{RESUME_EPOCHS * RESUME_STEPS}"],
              f"phase 12 (e): checkpoints {versions}")
        shutil.rmtree(os.path.join(model_dir, versions[0]))
        last = os.path.join(model_dir, versions[1])
        # the save's critical path, sync then background, of the same
        # state (each overwrites the last version: one stays on disk)
        os.environ["ZOO_ASYNC_CHECKPOINT"] = "0"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.save_checkpoint()
        sync_s = time.perf_counter() - t0
        del os.environ["ZOO_ASYNC_CHECKPOINT"]
        OrcaContext.background_checkpointing = True
        writer = get_background_checkpointer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.save_checkpoint()
        background_s = time.perf_counter() - t0
        writer.drain()
        t0 = time.perf_counter()
        host_state = load_checkpoint(last)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        est.engine.load_state_dict(host_state)
        torch.cuda.synchronize()
        to_card_s = time.perf_counter() - t0
        del host_state
        nbytes = ckpt_bytes(last)
        final = params_of(est.get_model())
        check(max_abs_diff(torch, final, ref_params) <= spread,
              "phase 12 (e): a load of the last checkpoint changed the "
              "parameters")
        del est
        free_card(torch)
        fresh = resume_estimator(model_dir)
        got = fresh.resume_latest()
        resumed = max_abs_diff(torch, params_of(fresh.get_model()), final)
        check(got == last and fresh.epoch == RESUME_EPOCHS
              and resumed == 0.0,
              f"phase 12 (e): resume_latest gave {got}, epoch "
              f"{fresh.epoch}, parameters {resumed:.3e} apart")
        out["resume"] = dict(
            retries=1, epochs=RESUME_EPOCHS, steps_per_epoch=RESUME_STEPS,
            fault_hit=RESUME_FAULT_HIT, max_abs_param_diff=diff,
            checkpoint_bytes=nbytes, save_sync_s=sync_s,
            save_background_critical_path_s=background_s,
            background_snapshot_s=writer.last_snapshot_s,
            background_write_s=writer.last_write_s,
            load_read_s=read_s, load_to_card_s=to_card_s,
            uninterrupted_fit_wall_s=ref_wall,
            interrupted_fit_wall_s=fit_wall, resumed_epoch=fresh.epoch)
        print(f"phase 12 (e) [{card}] {RESUME_EPOCHS} x {RESUME_STEPS}-step "
              f"fit, a raise at train.step hit {RESUME_FAULT_HIT}: retries 1,"
              f" parameters {diff:.3e} from the uninterrupted fit; "
              f"checkpoint {nbytes} bytes: save sync {sync_s:.3f} s, "
              f"background {background_s:.3f} s on the critical path "
              f"(write {writer.last_write_s:.3f} s on the writer thread); "
              f"load {read_s:.3f} s read + {to_card_s:.3f} s to the card; "
              f"resume_latest restored epoch {fresh.epoch}", flush=True)

        # (f): validation after each epoch equals evaluate after it, on
        # a fresh Adam fit (the resumed schedule has reached lr 0)
        del fresh
        free_card(torch)
        fresh = fit_surface_estimator(fit_surface_model(torch, cfg, state),
                                      seed)
        vrng = np.random.default_rng(seed + 12)
        vx, vy, _ = train_batch(vrng, 2 * TRAIN_BATCH, TRAIN_T,
                                cfg["vocab"])
        val = {"x": list(vx), "y": vy}
        small = {"x": [np.concatenate([a] * 2) for a in inputs],
                 "y": np.concatenate([y] * 2)}
        rows = []
        for _ in range(2):
            fresh.fit(small, epochs=1, batch_size=TRAIN_BATCH,
                      validation_data=val)
            ev = fresh.evaluate(val, batch_size=TRAIN_BATCH)
            row = fresh.val_summary[-1]
            rel = abs(row["loss"] - ev["loss"]) / abs(ev["loss"])
            check(rel <= 1e-6 and row["accuracy"] == ev["accuracy"],
                  f"phase 12 (f): val_summary {row} against evaluate {ev}")
            rows.append(dict(row, evaluate_loss=ev["loss"], rel_diff=rel))
        check(len(fresh.val_summary) == 2,
              f"phase 12 (f): {len(fresh.val_summary)} validation rows for "
              "2 epochs")
        out["validation"] = rows
        print(f"phase 12 (f) [{card}] val_summary {rows}", flush=True)
        del fresh
    finally:
        (OrcaContext.failure_retry_interval_s,
         OrcaContext.background_checkpointing) = prev[:2]
        if prev[2] is None:
            os.environ.pop("ZOO_ASYNC_CHECKPOINT", None)
        else:
            os.environ["ZOO_ASYNC_CHECKPOINT"] = prev[2]
        get_background_checkpointer().drain(raise_on_error=False)
        shutil.rmtree(tmp, ignore_errors=True)
        free_card(torch)
    return out, (cfg, state, inputs, y)


def fit_surface_profiles(torch, out: dict, ctx, seed: int, card: str):
    """Where a batch-32 step's time goes under each remat configuration
    (host wall, device work by op), after every timed phase: a profiler
    session leaves tracing costs on the host that slow the steps timed
    after it."""
    cfg, state, inputs, y = ctx
    batch = ([torch.from_numpy(a).cuda() for a in inputs],
             torch.from_numpy(y).long().cuda())
    rows = out["memory_and_time"][TRAIN_BATCH]
    for label, remat, policy in REMAT_CASES:
        est = fit_surface_estimator(
            fit_surface_model(torch, cfg, state, remat, policy), seed)
        rows[label]["step_profile"] = train_profile(torch, est, batch)
        del est
        free_card(torch)
    print(f"phase 12 step profiles [{card}] batch {TRAIN_BATCH}: " +
          "; ".join(f"{k} wall {r['step_profile']['wall_ms_per_step']:.3f} "
                    f"ms, device work "
                    f"{r['step_profile']['device_ms_per_step_all_events']:.3f}"
                    f" ms" for k, r in rows.items()), flush=True)


# ----------------------------------------------------------------------
# phase 6: slice 1, generation serving
# ----------------------------------------------------------------------

def decode_profile(torch, engine, vocab: int, seed: int, steps: int = 5):
    """Where a decode step's time goes, with every lane busy (prompts of
    200 tokens): host wall per step without the profiler, then device
    time per step, by device op, from a profiled window."""
    import numpy as np
    rng = np.random.default_rng(seed)
    streams = [engine.submit(rng.integers(0, vocab, 200).tolist(),
                             max_new_tokens=3 * steps + 2)
               for _ in range(engine.max_slots)]
    engine.step()                 # admit + prefill every lane, 1 decode
    check(len(engine.scheduler.running()) == engine.max_slots,
          "decode profile: not every lane was admitted in one round")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    dev, per, prof = device_ms(engine.step, iters=steps)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count
                    / steps) for e in prof.key_averages()),
                  key=lambda t: -t[1])[:12]
    engine.run_until_idle()
    check(all(len(s.tokens()) == 3 * steps + 2 for s in streams),
          "decode profile: a request was cut short")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return dict(lanes=engine.max_slots, prompt_len=200,
                wall_ms_per_step=wall, device_ms_per_step=dev,
                device_busy_share=(dev / wall if dev else None),
                top_device_ops_ms_per_step=[(n[:100], v) for n, v in top],
                top_host_ops_self_ms_and_calls_per_step=[
                    (n[:100], ms, c) for n, ms, c in host])


def logits_gate(torch, model, streams, prompts, outs, tol: float,
                label: str):
    """Recompute every finished stream once through the plain versions:
    the served logits (`keep_logits`) finite and within `tol` of the
    recompute, and each served token the recompute's argmax wherever its
    top-2 gap exceeds `tol`.  Returns (max abs err, positions compared,
    positions whose argmax was checked)."""
    worst, n_cmp, n_top = 0.0, 0, 0
    with torch.no_grad():
        for s, prompt, out in zip(streams, prompts, outs):
            seq = prompt + out
            ids = torch.tensor([seq], dtype=torch.int32, device="cuda")
            pos = torch.arange(len(seq), device="cuda")[None]
            ref, _, _ = model(ids, pos, token_mask=torch.ones_like(ids),
                              impl="reference")
            ref = ref[0, len(prompt) - 1:len(seq) - 1]
            got = torch.stack(s.seq.logits)
            check(bool(torch.isfinite(got).all()),
                  f"{label}: non-finite served logits")
            worst = max(worst, float((got - ref).abs().max()))
            top2 = torch.topk(ref, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol
            agree = torch.tensor(out, device="cuda") == ref.argmax(-1)
            check(bool(agree[clear].all()),
                  f"{label}: a served token is not the recompute's argmax "
                  f"where the top-2 gap exceeds {tol}")
            n_cmp += got.shape[0]
            n_top += int(clear.sum())
    check(worst <= tol, f"{label}: served logits differ from the plain "
          f"recompute by {worst} > {tol}")
    return worst, n_cmp, n_top


def serve(torch, model, n_requests: int, kv_quantization, seed: int,
          label: str, tol: float, cache_dtype=None):
    """Serve `n_requests` greedy requests through the background loop
    (the KV pool at `cache_dtype`, f32 by default), check launch counts,
    K6's body and the served logits; returns (summary, engine)."""
    import numpy as np

    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine

    n_block = model.n_block
    engine = GenerationEngine(model, max_slots=8, block_size=16,
                              max_context=1024,
                              cache_dtype=cache_dtype or torch.float32,
                              kv_quantization=kv_quantization,
                              keep_logits=True, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, n_requests)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    streams = [engine.submit(p, max_new_tokens=64) for p in prompts]
    engine.ensure_started()
    try:
        outs = [s.tokens() for s in streams]
    finally:
        engine.stop()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for s, out in zip(streams, outs):
        check(s.finish_reason == "length" and len(out) == 64,
              f"{label}: a request ended {s.finish_reason!r} after "
              f"{len(out)} tokens")
    n_pre, n_dec = engine.n_prefills, engine.n_decode_steps
    check(n_pre >= n_requests and n_dec > 0,
          f"{label}: {n_pre} prefills, {n_dec} decode steps")
    want_ln = (2 * n_block + 1) * (n_pre + n_dec)
    want_pd = n_block * n_dec
    check(counts["layer_norm_fwd"] == want_ln,
          f"{label}: K1 launched {counts['layer_norm_fwd']} times, "
          f"expected {want_ln}")
    check(counts["paged_decode"] == want_pd,
          f"{label}: K6 launched {counts['paged_decode']} times, "
          f"expected {want_pd}")
    bodies = dict(paged_decode.launches_by_body)
    check(bodies["split"] == want_pd,
          f"{label}: K6 launches by body {bodies}; all {want_pd} must take "
          "the split body")

    worst, n_cmp, n_top = logits_gate(torch, model, streams, prompts, outs,
                                      tol, label)

    n_tok = sum(len(o) for o in outs)
    dec = sorted(engine.decode_seconds)
    by_bucket = {}
    for b, sec in engine.prefill_seconds:
        by_bucket.setdefault(b, []).append(sec * 1e3)
    summary = dict(
        label=label, requests=n_requests, kv_quantization=kv_quantization,
        cache_dtype=str(cache_dtype or torch.float32),
        generated_tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        warmup_s=warm_s, prefills=n_pre, decode_steps=n_dec,
        preemptions=engine.scheduler.n_preemptions,
        decode_step_ms_p50=statistics.median(dec) * 1e3,
        prefill_ms_p50_by_bucket={b: statistics.median(v)
                                  for b, v in sorted(by_bucket.items())},
        launches=counts, logits_max_abs_err=worst, logits_compared=n_cmp,
        argmax_checked=n_top)
    return summary, engine


def phase_slice(torch, n_requests: int, seed: int, card: str):
    from analytics_zoo_tpu_torch.convert import (
        causal_lm_from_flax,
        init_causal_lm_params,
    )
    from analytics_zoo_tpu_torch.serving.generation import (
        GPT2_SMALL,
        CausalLM,
    )
    t0 = time.perf_counter()
    params = init_causal_lm_params(GPT2_SMALL, seed=seed)
    model = CausalLM(**GPT2_SMALL, device="cuda")
    model.load_state_dict(causal_lm_from_flax(params, GPT2_SMALL))
    del params
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: CausalLM at GPT-2 small widths, {n_params} params, f32, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    # f32 pool: served logits vs the plain recompute within 1e-3 (f32
    # throughout; kernels and matmul shapes differ from the recompute)
    f32, engine = serve(torch, model, n_requests, None, seed, "f32", 1e-3)
    # int8 pool: each cached K/V element is rounded by up to amax/254,
    # so the served logits drift from the full-precision recompute by
    # more than the kernels' own error (held to 1e-4 in phase 3); this
    # bound checks that drift stays small
    int8, _ = serve(torch, model, max(4, n_requests // 3), "int8",
                    seed + 1, "int8", 0.5)
    # f16 pool (bench.py's generation configuration): each cached K/V
    # element is rounded to within 2^-11 of its value, an eighth of the
    # int8 pool's amax/254 (about 2^-8 of the row's largest value), so
    # the drift from the f32 recompute is held to an eighth of the int8
    # bound
    f16, _ = serve(torch, model, max(4, n_requests // 3), None, seed + 2,
                   "f16", 0.5 / 8, cache_dtype=torch.float16)
    runs = [f32, int8, f16]
    for r in runs:
        pre = {b: round(v, 3)
               for b, v in r["prefill_ms_p50_by_bucket"].items()}
        print(f"slice [{card}] {r['label']}: {r['requests']} requests, "
              f"{r['generated_tokens']} tokens in {r['wall_s']:.3f} s = "
              f"{r['tokens_per_s']:.1f} tokens/s; decode step p50 "
              f"{r['decode_step_ms_p50']:.3f} ms over {r['decode_steps']} "
              f"steps; prefill ms p50 by bucket "
              f"{pre}; "
              f"{r['prefills']} prefills, {r['preemptions']} preemptions; "
              f"launches {r['launches']}; logits max abs err "
              f"{r['logits_max_abs_err']:.3e} over "
              f"{r['logits_compared']} positions", flush=True)
    return runs, engine


# ----------------------------------------------------------------------
# phase 14: the rest of the generation engine (prefix caching, chunked
# prefill, the host KV tier, speculative decoding)
# ----------------------------------------------------------------------

#: phase 6's engine geometry, which every scene of phase 14 keeps
GB_GEOM = dict(max_slots=8, block_size=16, max_context=1024)
#: phase 6's bounds on served logits against the plain recompute
GB_TOL_F32, GB_TOL_INT8 = 1e-3, 0.5
#: the speculation scenes' k (bench.py's speculation window)
GB_SPEC_K = 4
#: (c): spare blocks above one lane's full context in the cut pool, and
#: the distinct 256-token prefixes whose traffic returns
GB_TIER_SPARE, GB_TIER_PREFIXES = 8, 8
#: timed windows of each engine of a comparison, taken in turns (on,
#: off, on, off, ...): the host's clock stalls now and then for tens of
#: ms (a full collection of Python's garbage collector is one cause,
#: recorded by `gb_drive`), so one window of each side does not compare
GB_TURNS = 3


def gb_engine(torch, model, **kw):
    """A generation engine at phase 6's geometry on the card, every
    feature named (off unless `kw` turns it on), logits kept; warmed,
    with the warm-up's seconds."""
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine
    args = dict(GB_GEOM, prefix_caching=False, chunked_prefill=False,
                speculative_decoding=False, kv_host_tier=0,
                kv_quantization=None, keep_logits=True, device="cuda")
    args.update(kw)
    engine = GenerationEngine(model, **args)
    t0 = time.perf_counter()
    engine.warmup()
    return engine, time.perf_counter() - t0


_GB_FORWARDS = ("n_prefills", "n_chunks", "n_decode_steps",
                "n_verify_steps")


def gb_drive(torch, engine, reqs, label: str, arrive=None) -> dict:
    """Serve `reqs` ((prompt, max_new_tokens)) by stepping the engine
    until idle, the launch counts set to 0 just before and read just
    after; `arrive` (step index -> more requests) submits requests
    mid-run.  Checks the launches exactly (`gb_launch_check`) and that
    every request ran to its length.  Returns streams, tokens (outs),
    wall s, launches, forwards, the peak of shared blocks, each round's
    host ms with the forwards it ran (rounds), and the garbage
    collector's pauses in the run ((generation, ms) in gc_ms)."""
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    before = {k: getattr(engine, k) for k in _GB_FORWARDS}
    gc_pauses, gc_t0 = [], []

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[:] = [time.perf_counter()]
        elif gc_t0:
            gc_pauses.append((info["generation"],
                              1e3 * (time.perf_counter() - gc_t0[0])))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    streams = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    shared_peak, rounds = 0, []
    while engine.scheduler.has_work():
        r0 = time.perf_counter()
        f0 = [getattr(engine, k) for k in _GB_FORWARDS]
        check(engine.step(), f"{label}: a round ran no device work")
        rounds.append((1e3 * (time.perf_counter() - r0),
                       [getattr(engine, k) - f
                        for k, f in zip(_GB_FORWARDS, f0)]))
        shared_peak = max(shared_peak, engine.cache.allocator.n_shared())
        for p, n in (arrive or {}).get(len(rounds), ()):
            streams.append(engine.submit(p, max_new_tokens=n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    counts = kernels.launch_counts()
    outs = [s.tokens() for s in streams]
    fwd = {k: getattr(engine, k) - before[k] for k in _GB_FORWARDS}
    gb_launch_check(label, counts, dict(paged_decode.launches_by_body),
                    fwd, engine.model.n_block)
    for s, (p, n) in zip(streams, list(reqs) + [
            r for v in (arrive or {}).values() for r in v]):
        check(s.finish_reason == "length" and len(s.seq.generated) == n,
              f"{label}: a request ended {s.finish_reason!r} after "
              f"{len(s.seq.generated)} of {n} tokens")
    return dict(streams=streams, outs=outs, wall=wall, launches=counts,
                forwards=fwd, shared_peak=shared_peak, rounds=rounds,
                gc_ms=gc_pauses)


def gb_launch_check(label: str, counts: dict, bodies: dict, fwd: dict,
                    n_block: int) -> None:
    """K1 2L + 1 launches per forward (whole prefill, chunk, decode and
    verify alike), K6 L per decode step, all on its split body, no
    other kernel."""
    want = dict.fromkeys(counts, 0)
    want["layer_norm_fwd"] = (2 * n_block + 1) * sum(fwd.values())
    want["paged_decode"] = n_block * fwd["n_decode_steps"]
    check(counts == want, f"{label}: launches {counts}, expected {want} "
          f"from forwards {fwd}")
    check(bodies["split"] == want["paged_decode"],
          f"{label}: K6 launches by body {bodies}")


def ms_pcts(values) -> dict:
    v = np.sort(np.asarray(values, dtype=np.float64)) * 1e3
    return dict(p50=float(np.percentile(v, 50)),
                p99=float(np.percentile(v, 99)), max=float(v[-1]),
                n=int(v.size))


def merge_launches(runs) -> dict:
    out = {}
    for r in runs:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def gc_summary(runs) -> dict:
    pauses = [ms for r in runs for g, ms in r["gc_ms"] if g == 2]
    return dict(full_collections=len(pauses),
                full_collection_ms=sorted(pauses, reverse=True)[:6])


def idle_check(engine, label: str) -> dict:
    """An idle engine holds only the prefix tree's blocks, none shared:
    no lane reference leaked."""
    a = engine.cache.allocator
    cached = engine.prefix_cache.n_blocks if engine.prefix_cache else 0
    held = a.capacity - a.available()
    check(held == cached and a.n_shared() == 0,
          f"{label}: idle pool holds {held} blocks, {a.n_shared()} shared, "
          f"against {cached} in the prefix tree")
    return dict(blocks_held=held, blocks_cached=cached)


def gb_prefix(torch, model, seed: int):
    """(a) bench.py's prefix traffic (`bench.py:1309`): requests sharing
    one 256-token system prompt, each with a distinct 16-token tail, 16
    new tokens, f16 pool with int8 KV; one warm request, then windows of
    12 (new tails each window, the same for both engines) in turns, on
    the engine with prefix caching + chunked prefill and on the one with
    both off."""
    rng = np.random.default_rng(seed + 140)
    sys_prompt = rng.integers(0, 512, 256).tolist()

    def window():
        return [(sys_prompt + rng.integers(0, 512, 16).tolist(), 16)
                for _ in range(12)]
    warm = window()[:1]
    windows = [window() for _ in range(GB_TURNS)]
    engines, runs = {}, {True: [], False: []}
    for on in (True, False):
        label = f"phase 14 (a) cache {'on' if on else 'off'}"
        engine, warm_s = gb_engine(torch, model, cache_dtype=torch.float16,
                                   kv_quantization="int8",
                                   prefix_caching=on, chunked_prefill=on)
        engines[on] = (engine, warm_s, label,
                       gb_drive(torch, engine, warm, label + " warm"))
    for reqs in windows:
        for on in (True, False):
            engine, _, label, _ = engines[on]
            runs[on].append(gb_drive(torch, engine, reqs, label))
    out = {}
    for on in (True, False):
        engine, warm_s, label, w = engines[on]
        t = runs[on]
        err, n_cmp, n_top = logits_gate(
            torch, model, w["streams"] + [s for r in t for s in r["streams"]],
            [p for p, _ in warm + [q for reqs in windows for q in reqs]],
            w["outs"] + [o for r in t for o in r["outs"]], GB_TOL_INT8, label)
        rates = [sum(map(len, r["outs"])) / r["wall"] for r in t]
        ttft = [s.token_times[0] - s.submitted_at
                for r in t for s in r["streams"]]
        res = dict(tokens_per_s=statistics.median(rates),
                   tokens_per_s_windows=rates, warmup_s=warm_s,
                   ttft_ms=ms_pcts(ttft), launches=merge_launches(t),
                   forwards=[r["forwards"] for r in t],
                   shared_blocks_peak=max(r["shared_peak"] for r in t),
                   first_round_ms=[r["rounds"][0][0] for r in t],
                   prefill_ms_p50=1e3 * statistics.median(
                       sec for _, sec in engine.prefill_seconds),
                   decode_ms_p50=1e3 * statistics.median(
                       engine.decode_seconds),
                   gc=gc_summary(t), logits_max_abs_err=err,
                   logits_compared=n_cmp, argmax_checked=n_top,
                   idle=idle_check(engine, label),
                   pool=engine._kv_pool_stats())
        if on:
            pc = engine.prefix_cache
            res.update(hit_rate=pc.hit_rate(), hit_tokens=pc.n_hit_tokens,
                       blocks_cached=pc.n_blocks, chunks=engine.n_chunks)
            check(res["hit_rate"] >= 0.8, f"{label}: hit rate "
                  f"{res['hit_rate']:.3f} < 0.8 (bench.py's gate)")
        out["on" if on else "off"] = res
    del engines
    torch.cuda.empty_cache()
    out["on_vs_off_tokens_per_s"] = (out["on"]["tokens_per_s"]
                                     / out["off"]["tokens_per_s"])
    return out


def gb_interleave(torch, model, seed: int):
    """(b) Seven lanes decode (64-token prompts, 128 new tokens) while
    one 900-token prompt arrives after 8 rounds, prefill_token_budget
    256 (chunk cap 256), f32 pool; with chunked prefill on and off, the
    same requests, GB_TURNS - 1 runs of each in turns."""
    rng = np.random.default_rng(seed + 141)
    short = [(rng.integers(0, model.vocab, 64).tolist(), 128)
             for _ in range(7)]
    long_req = (rng.integers(0, model.vocab, 900).tolist(), 16)
    engines = {c: gb_engine(torch, model, chunked_prefill=c,
                            prefill_token_budget=256) for c in (True, False)}
    runs = {True: [], False: []}
    for _ in range(GB_TURNS - 1):
        for chunked in (True, False):
            label = f"phase 14 (b) chunked {'on' if chunked else 'off'}"
            runs[chunked].append(gb_drive(
                torch, engines[chunked][0], short, label,
                arrive={8: [long_req]}))
    first = runs[True][0]["outs"][:7]
    for chunked in (True, False):
        for r in runs[chunked]:
            check(r["outs"][:7] == first, "phase 14 (b): the decoding "
                  "lanes' streams differ with chunked prefill on and off")
    out = {}
    for chunked in (True, False):
        label = f"phase 14 (b) chunked {'on' if chunked else 'off'}"
        engine, warm_s = engines[chunked]
        t = runs[chunked]
        err, n_cmp, n_top = logits_gate(
            torch, model, [s for r in t for s in r["streams"]],
            ([p for p, _ in short] + [long_req[0]]) * len(t),
            [o for r in t for o in r["outs"]], GB_TOL_F32, label)
        gaps, long_ttft = [], []
        for r in t:
            t_arrive = r["streams"][-1].submitted_at
            long_ttft.append(1e3 * (r["streams"][-1].token_times[0]
                                    - t_arrive))
            gaps += [b - a for s in r["streams"][:7]
                     for a, b in zip(s.token_times, s.token_times[1:])
                     if b > t_arrive]
        out["on" if chunked else "off"] = dict(
            gap_ms=ms_pcts(gaps), long_ttft_ms=long_ttft,
            wall_s=[r["wall"] for r in t], warmup_s=warm_s,
            chunks=engine.n_chunks, launches=merge_launches(t),
            forwards=[r["forwards"] for r in t],
            slowest_rounds_ms=[sorted(
                ((round(ms, 3), i, f) for i, (ms, f)
                 in enumerate(r["rounds"])), reverse=True)[:6]
                for r in t],
            gc=gc_summary(t), logits_max_abs_err=err,
            logits_compared=n_cmp, argmax_checked=n_top)
    del engines
    torch.cuda.empty_cache()
    return out


def gb_host_tier(torch, model, seed: int):
    """(c) The pool cut to one lane's full context plus GB_TIER_SPARE
    blocks, a host tier for GB_TIER_PREFIXES prefixes: one request for
    each prefix (256 tokens + a 16-token tail, 16 new, f16 pool with
    int8 KV), all at once, so that the later admissions evict the
    earlier prefixes; then the traffic returns to every prefix, with new
    tails.  A restore needs a free block (it never evicts), so the
    restores come where lanes finishing together have freed their last,
    partial blocks."""
    from analytics_zoo_tpu_torch.serving.generation.host_tier import (
        dma_events,
        reset_dma,
    )
    bs = GB_GEOM["block_size"]
    per_lane = GB_GEOM["max_context"] // bs
    rng = np.random.default_rng(seed + 142)
    prefixes = [rng.integers(0, model.vocab, 256).tolist()
                for _ in range(GB_TIER_PREFIXES)]
    L, h = model.n_block, model.n_head
    d = model.hidden_size // h
    block_bytes = L * 2 * bs * h * d + L * 2 * bs * 4     # int8 + scales
    tier_bytes = GB_TIER_PREFIXES * (288 // bs) * block_bytes
    label = "phase 14 (c)"
    engine, warm_s = gb_engine(
        torch, model, cache_dtype=torch.float16, kv_quantization="int8",
        prefix_caching=True, chunked_prefill=True,
        num_blocks=per_lane + 1 + GB_TIER_SPARE, kv_host_tier=tier_bytes)
    reset_dma()
    rounds, all_streams, all_reqs = [], [], []
    for wave in range(2):
        reqs = [(pre + rng.integers(0, model.vocab, 16).tolist(), 16)
                for pre in prefixes]
        r0, s0 = engine.n_host_restores, engine.prefix_cache.n_evictions
        t = gb_drive(torch, engine, reqs, f"{label} wave {wave}")
        streams = t["streams"]
        rounds.append(dict(wave=wave, wall_s=t["wall"],
                           launches=t["launches"], forwards=t["forwards"],
                           restored=engine.n_host_restores - r0,
                           evicted=engine.prefix_cache.n_evictions - s0,
                           prefix_tokens=[s.seq.prefix_tokens
                                          for s in streams]))
        all_streams += streams
        all_reqs += reqs
    err, n_cmp, n_top = logits_gate(
        torch, model, all_streams, [p for p, _ in all_reqs],
        [s.seq.generated for s in all_streams], GB_TOL_INT8, label)
    pc, tier = engine.prefix_cache, engine.host_tier
    check(engine.n_host_restores > 0, f"{label}: no block was restored")
    staged = engine.n_host_restores_staged
    check(0 < staged < engine.n_host_restores,
          f"{label}: restores {engine.n_host_restores}, {staged} of them "
          "staged: both paths must run")
    events = dma_events()

    def rates(kind, flag=None):
        ev = [e for e in events if e["kind"] == kind
              and (flag is None or e.get("staged") == flag)]
        return dict(n=len(ev), bytes_each=sorted({e["nbytes"] for e in ev}),
                    ms=ms_pcts([e["dur_s"] for e in ev]) if ev else None,
                    gb_per_s_median=(float(np.median(
                        [e["nbytes"] / e["dur_s"] / 1e9 for e in ev]))
                        if ev else None))
    out = dict(num_blocks=engine.cache.num_blocks, tier_bytes=tier_bytes,
               warmup_s=warm_s, requests=rounds,
               restores=engine.n_host_restores, restores_staged=staged,
               spilled=tier.n_spilled, tier_evictions=tier.n_evictions,
               tier_entries=len(tier), tier_bytes_used=tier.bytes_used,
               spill_syncs=pc.n_spill_syncs, evictions=pc.n_evictions,
               hit_rate=pc.hit_rate(), spill=rates("host_spill"),
               restore_sync=rates("host_restore", False),
               restore_staged=rates("host_restore", True),
               logits_max_abs_err=err, logits_compared=n_cmp,
               argmax_checked=n_top, idle=idle_check(engine, label))
    check(pc.n_spill_syncs == pc.n_evictions > 0,
          f"{label}: {pc.n_spill_syncs} spill syncs for {pc.n_evictions} "
          "evicted blocks")
    del engine
    torch.cuda.empty_cache()
    return out


def cycle_model(torch, seed: int, cycle_len: int = 8):
    """`CausalLM` at GPT-2 small's widths wired as bench.py's
    `_cycle_lm` (`bench.py:1448-1497`): every proj and fc2 zero, the
    position table zero, token t < hidden_size embedded as the one-hot
    at dim t, the head mapping dim t to perm[t] with weight 10, where
    perm walks 0..cycle_len-1 in one short cycle and the other embedded
    tokens in one long one.  Returns (model, perm)."""
    from analytics_zoo_tpu_torch.convert import (
        causal_lm_from_flax,
        init_causal_lm_params,
    )
    from analytics_zoo_tpu_torch.serving.generation import (
        GPT2_SMALL,
        CausalLM,
    )
    hid = GPT2_SMALL["hidden_size"]
    rng = np.random.default_rng(seed)
    rest = rng.permutation(np.arange(cycle_len, hid))
    perm = np.empty(hid, dtype=np.int64)
    for i in range(cycle_len):
        perm[i] = (i + 1) % cycle_len
    for i, t in enumerate(rest):
        perm[t] = rest[(i + 1) % len(rest)]
    p = init_causal_lm_params(GPT2_SMALL, seed=seed)
    for b in range(GPT2_SMALL["n_block"]):
        for name in (f"block_{b}_proj", f"block_{b}_fc2"):
            p[name]["kernel"][...] = 0
            p[name]["bias"][...] = 0
    p["position_embed"]["embedding"][...] = 0
    emb = np.zeros_like(p["token_embed"]["embedding"])
    head = np.zeros_like(p["lm_head"]["kernel"])
    emb[np.arange(hid), np.arange(hid)] = 1.0
    head[np.arange(hid), perm] = 10.0
    p["token_embed"]["embedding"] = emb
    p["lm_head"]["kernel"] = head
    p["lm_head"]["bias"][...] = 0
    model = CausalLM(**GPT2_SMALL, device="cuda")
    model.load_state_dict(causal_lm_from_flax(p, GPT2_SMALL))
    return model.eval(), perm


def gb_spec_pair(torch, model, reqs, label: str, tol: float, **kw):
    """Serve `reqs` with speculation on and off (everything else as
    `kw`): the first request alone on each engine to warm it, then the
    rest in GB_TURNS timed windows of each engine in turns; logits gated
    against the recompute within `tol` on both.  Returns ({on, off}
    summaries, {on, off} streams of the warm request and the first
    window)."""
    engines = {}
    for on in (True, False):
        lab = f"{label} spec {'on' if on else 'off'}"
        engine, warm_s = gb_engine(torch, model, speculative_decoding=on,
                                   speculative_k=GB_SPEC_K, **kw)
        engines[on] = (engine, warm_s, lab,
                       gb_drive(torch, engine, reqs[:1], lab + " warm"))
    runs = {True: [], False: []}
    for _ in range(GB_TURNS):
        for on in (True, False):
            engine, _, lab, _ = engines[on]
            runs[on].append(gb_drive(torch, engine, reqs[1:], lab))
    res, outs_by = {}, {}
    for on in (True, False):
        engine, warm_s, lab, w = engines[on]
        t = runs[on]
        err, n_cmp, n_top = logits_gate(
            torch, model, w["streams"] + [s for r in t for s in r["streams"]],
            [p for p, _ in reqs[:1] + reqs[1:] * len(t)],
            w["outs"] + [o for r in t for o in r["outs"]], tol, lab)
        rates = [sum(map(len, r["outs"])) / r["wall"] for r in t]
        r = dict(tokens_per_s=statistics.median(rates),
                 tokens_per_s_windows=rates,
                 wall_s=statistics.median(x["wall"] for x in t),
                 warmup_s=warm_s, launches=merge_launches(t),
                 forwards=[x["forwards"] for x in t],
                 decode_ms_p50=(1e3 * statistics.median(
                     engine.decode_seconds) if engine.decode_seconds
                     else None),
                 verify_ms_p50=(1e3 * statistics.median(
                     engine.verify_seconds) if engine.verify_seconds
                     else None),
                 gc=gc_summary(t), logits_max_abs_err=err,
                 logits_compared=n_cmp, argmax_checked=n_top,
                 idle=idle_check(engine, lab))
        if on:
            r.update(verify_rounds=engine.n_verify_steps,
                     lane_rounds=engine.n_spec_rounds,
                     proposed=engine.n_spec_proposed,
                     accepted=engine.n_spec_accepted,
                     acceptance=(engine.n_spec_accepted
                                 / max(1, engine.n_spec_proposed)),
                     parked_lane_rounds=engine.n_spec_parked)
        res["on" if on else "off"] = r
        outs_by[on] = [w["outs"] + x["outs"] for x in t]
    del engines
    torch.cuda.empty_cache()
    res["on_vs_off_tokens_per_s"] = (res["on"]["tokens_per_s"]
                                     / res["off"]["tokens_per_s"])
    return res, outs_by


def gb_step_profiles(torch, model, iters: int = 10) -> dict:
    """Where phase 14's new steps spend their time, after the timed
    phases: a 256-token chunk over 512 written tokens, a decode step and
    a k = 4 verify step of 8 lanes at 900 written tokens each (f32 pool,
    phase 6's geometry): host ms per call (back-to-back calls, one
    synchronize) and device ms per call by device op (profiler)."""
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine
    engine = GenerationEngine(model, **GB_GEOM, prefix_caching=True,
                              chunked_prefill=True,
                              speculative_decoding=True,
                              speculative_k=GB_SPEC_K, kv_host_tier=0,
                              kv_quantization=None, device="cuda")
    S, MB = engine.max_slots, engine.scheduler.max_blocks_per_seq
    dev = "cuda"
    tables = torch.arange(1, S * MB + 1, dtype=torch.int32,
                          device=dev).reshape(S, MB)
    ctx = torch.full((S,), 900, dtype=torch.int32, device=dev)
    zi = torch.zeros(S, dtype=torch.int32, device=dev)
    act = torch.ones(S, dtype=torch.bool, device=dev)
    chunk_tokens = torch.zeros((1, 256), dtype=torch.int32, device=dev)
    verify_tokens = torch.zeros((S, 1 + GB_SPEC_K), dtype=torch.int32,
                                device=dev)
    width = torch.full((S,), 1 + GB_SPEC_K, dtype=torch.int32, device=dev)
    steps = {
        "chunk_256_at_512": lambda: engine._chunk(chunk_tokens, 512, 256,
                                                  tables[0]),
        "decode_8_at_900": lambda: engine._decode(
            zi, tables, ctx, act, torch.zeros(S, device=dev), zi),
        "verify_8x5_at_900": lambda: engine._verify(
            verify_tokens, tables, ctx, width, act),
    }
    L, h = model.n_block, model.n_head
    d = model.hidden_size // h
    out = {}
    with torch.no_grad():
        for name, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / iters * 1e3
            total, per, _ = device_ms(fn, iters=iters)
            top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
            out[name] = dict(host_ms=host, device_ms=total,
                             top_device_ops_ms=[(n[:90], v) for n, v in top])
    # the verify read gathers every lane's whole table (K and V, f32) in
    # each layer: the bytes it writes, and their time at HBM's rate
    gathered = L * 2 * S * MB * engine.cache.block_size * h * d * 4
    out["verify_gather_bytes"] = gathered
    out["verify_gather_bound_ms"] = 2 * gathered / HBM_BYTES_PER_S * 1e3
    del engine
    torch.cuda.empty_cache()
    return out


def phase_generation_breadth(torch, seed: int, card: str, model):
    """Phase 14: prefix caching, chunked prefill, the host KV tier and
    speculative decoding through `GenerationEngine` on phase 6's model
    (GPT-2 small's widths, f32, 8 lanes, blocks of 16, context 1024) and
    on a wired cycle model at the same widths."""
    t0 = time.perf_counter()
    out = {}
    out["a_prefix"] = a = gb_prefix(torch, model, seed)
    print(f"phase 14 (a) [{card}] prefix caching, 12 requests after one "
          f"warm: cache on {a['on']['tokens_per_s']:.1f} tokens/s, TTFT "
          f"p50 {a['on']['ttft_ms']['p50']:.2f} ms p99 "
          f"{a['on']['ttft_ms']['p99']:.2f}; off "
          f"{a['off']['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{a['off']['ttft_ms']['p50']:.2f} p99 "
          f"{a['off']['ttft_ms']['p99']:.2f}; ratio "
          f"{a['on_vs_off_tokens_per_s']:.3f}; hit rate "
          f"{a['on']['hit_rate']:.3f}, {a['on']['hit_tokens']} hit tokens, "
          f"{a['on']['blocks_cached']} blocks cached, shared peak "
          f"{a['on']['shared_blocks_peak']}; windows on "
          f"{[round(x, 1) for x in a['on']['tokens_per_s_windows']]} off "
          f"{[round(x, 1) for x in a['off']['tokens_per_s_windows']]}; "
          f"logits err "
          f"{a['on']['logits_max_abs_err']:.3e} / "
          f"{a['off']['logits_max_abs_err']:.3e}", flush=True)
    out["b_interleave"] = b = gb_interleave(torch, model, seed)
    for k in ("on", "off"):
        g = b[k]["gap_ms"]
        print(f"phase 14 (b) [{card}] chunked {k}: decoding lanes' "
              f"inter-token gap after the 900-token prompt arrives p50 "
              f"{g['p50']:.3f} ms p99 {g['p99']:.3f} max {g['max']:.3f} "
              f"over {g['n']} gaps; the long prompt's first token after "
              f"{[round(x, 2) for x in b[k]['long_ttft_ms']]} ms; "
              f"{b[k]['chunks']} chunks; full collections {b[k]['gc']}; "
              f"logits err {b[k]['logits_max_abs_err']:.3e}", flush=True)
    out["c_host_tier"] = c = gb_host_tier(torch, model, seed)
    print(f"phase 14 (c) [{card}] host tier: {c['num_blocks']} blocks, "
          f"{c['spilled']} spills ({c['spill']['bytes_each']} bytes each, "
          f"median {c['spill']['gb_per_s_median']:.3f} GB/s, "
          f"{c['spill_syncs']} syncs), {c['restores']} restores "
          f"({c['restores_staged']} staged: median "
          f"{c['restore_staged']['gb_per_s_median']:.3f} GB/s of host "
          f"time; synchronous: median "
          f"{c['restore_sync']['gb_per_s_median']:.3f} GB/s), "
          f"{c['evictions']} evictions, restores by wave "
          f"{[r['restored'] for r in c['requests']]}; logits err "
          f"{c['logits_max_abs_err']:.3e}", flush=True)
    cmodel, perm = cycle_model(torch, seed)

    def chain(start, n):
        o = [int(start)]
        for _ in range(n - 1):
            o.append(int(perm[o[-1]]))
        return o
    sys_prompt = chain(0, 64)
    reqs = [(sys_prompt + chain(i % 8, 4), 48) for i in range(12)]
    d, outs = gb_spec_pair(torch, cmodel, reqs, "phase 14 (d)", GB_TOL_INT8,
                           cache_dtype=torch.float16, kv_quantization="int8",
                           prefix_caching=True, chunked_prefill=True)
    check(all(o == outs[False][0] for side in outs.values() for o in side),
          "phase 14 (d): cycle streams differ with speculation on and off")
    out["d_spec_cycle"] = d
    del cmodel
    torch.cuda.empty_cache()
    print(f"phase 14 (d) [{card}] speculation on the cycle model: on "
          f"{d['on']['tokens_per_s']:.1f} tokens/s, off "
          f"{d['off']['tokens_per_s']:.1f}, ratio "
          f"{d['on_vs_off_tokens_per_s']:.3f} (bench.py's gate 1.5, "
          f"reported); acceptance {d['on']['acceptance']:.3f}, "
          f"{d['on']['verify_rounds']} verify rounds, verify p50 "
          f"{d['on']['verify_ms_p50']:.3f} ms, decode p50 "
          f"{d['off']['decode_ms_p50']:.3f} ms; windows on "
          f"{[round(x, 1) for x in d['on']['tokens_per_s_windows']]} off "
          f"{[round(x, 1) for x in d['off']['tokens_per_s_windows']]}",
          flush=True)
    rng = np.random.default_rng(seed + 143)
    adv = [(rng.integers(8, model.vocab, 24).tolist(), 32)
           for _ in range(12)]
    e, _ = gb_spec_pair(torch, model, adv, "phase 14 (e)", GB_TOL_F32)
    out["e_spec_adversarial"] = e
    print(f"phase 14 (e) [{card}] speculation on random prompts: on "
          f"{e['on']['tokens_per_s']:.1f} tokens/s, off "
          f"{e['off']['tokens_per_s']:.1f} (medians of windows on "
          f"{[round(x, 1) for x in e['on']['tokens_per_s_windows']]} off "
          f"{[round(x, 1) for x in e['off']['tokens_per_s_windows']]}); "
          f"wall on / off "
          f"{e['on']['wall_s'] / e['off']['wall_s']:.3f} (bench.py's bound "
          f"1.1, reported); {e['on']['lane_rounds']} lane verify rounds, "
          f"acceptance {e['on']['acceptance']:.3f}, "
          f"{e['on']['parked_lane_rounds']} lane rounds parked in the "
          f"cooldown; logits err {e['on']['logits_max_abs_err']:.3e}",
          flush=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = merge_launches(
        [a["on"], a["off"], b["on"], b["off"], d["on"], d["off"], e["on"],
         e["off"]] + c["requests"])
    return out


def kernel_entry(name, route, source, replaces, launches, shapes,
                 main: int, checks=()):
    """One kernel's record of the result line: the numbers at its main
    path's shape (`shapes[main]`), every shape beside them; its max abs
    err also covers the untimed `checks` (max abs errs)."""
    m = shapes[main]
    entry = dict(name=name, route=route, source=source, replaces=replaces,
                 launches=launches,
                 max_abs_err=max([s["max_abs_err"] for s in shapes]
                                 + list(checks)),
                 ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                 bound_by=m["bound_by"], library_ms=m["library_ms"],
                 shapes=shapes)
    return entry


# ----------------------------------------------------------------------
# phase 15: the serving front end (ServingServer over HTTP)
# ----------------------------------------------------------------------

#: bench.py's serving cell (bench.py:731-856): per-record clients,
#: their warm-up and timed seconds, then pre-batched clients x records
#: for their seconds; the batcher's max batch and window
SRV_CLIENTS, SRV_WARM_S, SRV_TIMED_S = 64, 2.0, 6.0
SRV_BATCHED_CLIENTS, SRV_BATCHED_ROWS, SRV_BATCHED_S = 4, 512, 3.0
SRV_MAX_BATCH, SRV_WINDOW_MS = 64, 2.0
#: bench.py's queue-wait check (reported, not gated here)
SRV_QUEUE_WAIT_P50_MS = 40.0
#: (b): per-record clients x requests each at t = 128, then pre-batched
#: clients x requests of 32 x 512
SRV_BERT_CLIENTS, SRV_BERT_REQS = 16, 8
SRV_BERT_BATCHED, SRV_BERT_BATCHED_REQS = 4, 3
#: (c): phase 6's requests over /generate
SRV_GEN_REQUESTS, SRV_GEN_NEW = 12, 64
SRV_SEED = 15
HTTP_TIMEOUT_S = 60.0


def http_call(srv, method: str, path: str, body=None, headers=None):
    """(status, headers, body bytes) of one request to `srv`."""
    import urllib.error
    import urllib.request
    data = body if isinstance(body, (bytes, type(None))) \
        else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}", data=data, method=method,
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def served_metrics(srv) -> dict:
    """queue wait and predict p50 (ms) and the batches, read back
    through GET /metrics with the port's Prometheus parser."""
    from analytics_zoo_tpu_torch.observability import parse_prometheus_text
    code, _, body = http_call(srv, "GET", "/metrics")
    check(code == 200, f"GET /metrics answered {code}")
    prom = parse_prometheus_text(body.decode())
    q = {op: prom[f"serving_{op}_seconds"]["quantiles"][0.5] * 1e3
         for op in ("queue_wait", "predict", "batch_assemble")}
    return dict(queue_wait_ms_p50=q["queue_wait"],
                predict_ms_p50=q["predict"],
                batch_assemble_ms_p50=q["batch_assemble"],
                batches_total=prom["serving_batches_total"]["value"],
                records_total=prom["serving_records_served_total"]["value"])


def busy_share(torch, fn, top_host: int = 0, host: bool = True) -> dict:
    """The card's busy share while `fn()` runs: device time of every
    kernel, copy and fill in a profiled window over host wall; with
    `top_host`, that many host ops by their own time (ms, calls).
    `host=False` traces the card alone: a window of thousands of small
    steps then costs seconds to read back, not tens of seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sum(e.time_range.elapsed_us() / 1e6 for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation)
    out = dict(profiled_wall_s=wall, device_s=dev,
               device_busy_share=dev / wall if wall else None)
    if top_host:
        out["top_host_ops_self_ms_and_calls"] = [
            (e.key[:60], e.self_cpu_time_total / 1e3, e.count)
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.self_cpu_time_total)[:top_host]]
    return out


def predict_alone_ms(torch, im, inputs, iters: int = 30) -> float:
    """p50 host wall (ms) of `im.predict(*inputs)` called from this one
    thread, nothing else running."""
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        im.predict(*inputs)
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def client_burst(fn, n_threads: int, seconds: float, warm_s: float = 0.0):
    """Run `fn(k, rng)` in a loop on `n_threads` threads for warm_s +
    seconds; returns (latencies in s of the calls that started after the
    warm-up and ended inside the window, errors, the window's s)."""
    import threading
    lat, errors = [], []
    lock = threading.Lock()
    t_warm = time.monotonic() + warm_s
    t_end = t_warm + seconds

    def run(k):
        rng = np.random.default_rng(SRV_SEED + k)
        mine = []
        try:
            while True:
                t_now = time.monotonic()
                if t_now >= t_end:
                    break
                t0 = time.perf_counter()
                fn(k, rng)
                if t_now >= t_warm and time.monotonic() <= t_end:
                    mine.append(time.perf_counter() - t0)
        except Exception as e:
            with lock:
                errors.append(f"{type(e).__name__}: {e}")
        finally:
            with lock:
                lat.extend(mine)

    threads = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=warm_s + seconds + HTTP_TIMEOUT_S)
    return lat, errors, seconds


def pct_ms(lat, q: float) -> float:
    return float(np.percentile(np.asarray(lat) * 1e3, q))


def serve_ncf(torch, seed: int, card: str, out: dict):
    """(a): bench.py's serving cell on the port: NCF behind
    InferenceModel and ServingServer, per-record then pre-batched
    clients; no kernel on this path."""
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.serving import (
        InferenceModel,
        InputQueue,
        ServingServer,
    )
    torch.manual_seed(seed)
    model = NeuralCF(**NCF_CELL, compute_dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    u = rng.integers(1, NCF_CELL["user_count"] + 1, 4096).astype(np.int32)
    i = rng.integers(1, NCF_CELL["item_count"] + 1, 4096).astype(np.int32)
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=512
                        ).load_module(model)
    for b in (1, 2, 4, 8, 16, 32, 64, 512):   # every bucket the run hits
        im.predict(u[:b], i[:b])
    # the same predict alone, from one thread: what the served predict
    # costs without the clients' and handlers' threads around it
    alone = predict_alone_ms(torch, im, (u[:4], i[:4]))
    srv = ServingServer(im, max_batch_size=SRV_MAX_BATCH,
                        batch_timeout_ms=SRV_WINDOW_MS).start()
    try:
        kernels.reset_launch_counts()

        def one(k, r):
            q = queues[k]
            j = int(r.integers(0, len(u)))
            q.predict(u[j], i[j])

        queues = [InputQueue(srv.host, srv.port)
                  for _ in range(SRV_CLIENTS)]
        lat, errors, secs = client_burst(one, SRV_CLIENTS, SRV_TIMED_S,
                                         SRV_WARM_S)
        check(not errors, f"phase 15 (a): {len(errors)} client errors, "
              f"first {errors[:1]}")
        check(lat, "phase 15 (a): no request completed in the window")
        met = served_metrics(srv)
        stats = json.loads(http_call(srv, "GET", "/stats")[2])

        def batched(k, r):
            b_queues[k].predict(u[:SRV_BATCHED_ROWS], i[:SRV_BATCHED_ROWS],
                                batched=True)

        b_queues = [InputQueue(srv.host, srv.port)
                    for _ in range(SRV_BATCHED_CLIENTS)]
        b_queues[0].predict(u[:SRV_BATCHED_ROWS], i[:SRV_BATCHED_ROWS],
                            batched=True)
        b_lat, b_err, b_secs = client_burst(batched, SRV_BATCHED_CLIENTS,
                                            SRV_BATCHED_S)
        check(not b_err, f"phase 15 (a): {len(b_err)} pre-batched client "
              f"errors, first {b_err[:1]}")
        busy = busy_share(torch, lambda: client_burst(
            one, SRV_CLIENTS, 1.0))
        # 64 rows served one record a request, against one direct
        # predict of the same rows
        import threading
        got = [None] * SRV_MAX_BATCH

        def fetch(j):
            got[j] = InputQueue(srv.host, srv.port).predict(u[j], i[j])
        threads = [threading.Thread(target=fetch, args=(j,))
                   for j in range(SRV_MAX_BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        launched = kernels.launch_counts()
        want = im.predict(u[:SRV_MAX_BATCH], i[:SRV_MAX_BATCH])
        err = float(np.abs(np.stack(got) - want).max())
        check(err <= 1e-5, f"phase 15 (a): served rows differ from a "
              f"direct predict by {err} > 1e-5")
        check(not any(launched.values()),
              f"phase 15 (a): kernels launched on the NCF path: {launched}")
    finally:
        srv.stop()
    res = dict(
        clients=SRV_CLIENTS, records_per_s=len(lat) / secs,
        p50_ms=pct_ms(lat, 50), p99_ms=pct_ms(lat, 99),
        batched_clients=SRV_BATCHED_CLIENTS,
        batched_records_per_s=len(b_lat) * SRV_BATCHED_ROWS / b_secs,
        batched_p50_ms=pct_ms(b_lat, 50) if b_lat else None,
        client_errors=len(errors) + len(b_err), max_abs_err=err,
        launches=launched, batches_run=stats["batches_run"],
        mean_records_per_batch=(stats["timers"]["predict"]["records"]
                                / stats["timers"]["predict"]["calls"]),
        queue_wait_p50_within_bench_check=(
            met["queue_wait_ms_p50"] <= SRV_QUEUE_WAIT_P50_MS), **met,
        predict_alone_ms_p50_4_rows=alone, **busy)
    out["a"] = res
    print(f"phase 15 (a) [{card}] NCF served over HTTP: "
          f"{res['records_per_s']:.1f} records/s from {SRV_CLIENTS} "
          f"per-record clients, p50 {res['p50_ms']:.2f} ms, p99 "
          f"{res['p99_ms']:.2f} ms; {res['batched_records_per_s']:.1f} "
          f"records/s pre-batched ({SRV_BATCHED_CLIENTS} x "
          f"{SRV_BATCHED_ROWS}); queue wait p50 "
          f"{res['queue_wait_ms_p50']:.3f} ms (bench.py's check <= "
          f"{SRV_QUEUE_WAIT_P50_MS} ms: "
          f"{res['queue_wait_p50_within_bench_check']}), predict p50 "
          f"{res['predict_ms_p50']:.3f} ms (alone, 4 rows: {alone:.3f} ms), "
          f"{res['mean_records_per_batch']:.1f} records a batch; card busy "
          f"{res['device_busy_share']:.3f} of a profiled second; max abs "
          f"err {err:.3e}; launches {launched}",
          flush=True)
    return model


def serve_bert_http(torch, seed: int, card: str, model, phase7: dict,
                    out: dict):
    """(b): phase 7's BERT-base (bf16, flash) over /predict: per-record
    clients at t = 128, then pre-batched 32 x 512; launches exact per
    forward, every K2 launch on its sm90 body, the served logits against
    a direct predict of the same rows."""
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.serving import (
        InferenceModel,
        InputQueue,
        ServingServer,
    )
    import threading
    vocab = model.bert.token_embed.num_embeddings
    n_blk = len(model.bert.blocks)
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=32
                        ).load_module(model)
    rng = np.random.default_rng(seed + 40)
    # per client: (inputs, sequences) of each request; a per-record
    # request is one sequence without its batch dim
    per_record = [[tuple(a[0] for a in bert_request(rng, 1, 128, vocab)[0])
                   for _ in range(SRV_BERT_REQS)]
                  for _ in range(SRV_BERT_CLIENTS)]
    blocks = [bert_request(rng, 32, 512, vocab)[0]
              for _ in range(SRV_BERT_BATCHED)]
    pre_batched = [[blk] * SRV_BERT_BATCHED_REQS for blk in blocks]
    res, results = {}, {}
    # a 2-row forward at t = 128 (the per-record batches' size) and a
    # 32 x 512 one, from this one thread
    res["predict_alone_ms_p50"] = {
        "2x128": predict_alone_ms(torch, im, tuple(
            np.stack([a, a]) for a in per_record[0][0])),
        "32x512": predict_alone_ms(torch, im, blocks[0], iters=10)}
    for label, max_batch, plans, batched in (
            ("per_record_t128", 32, per_record, False),
            ("pre_batched_32x512", 1, pre_batched, True)):
        # a pre-batched request runs alone in its batch: one forward
        srv = ServingServer(im, max_batch_size=max_batch,
                            batch_timeout_ms=SRV_WINDOW_MS).start()
        lat, errors, served = [], [], []
        lock = threading.Lock()

        def run(plan, keep=True):
            q = InputQueue(srv.host, srv.port)
            try:
                for inputs in plan:
                    t0 = time.perf_counter()
                    o = q.predict(*inputs, batched=batched)
                    if keep:
                        with lock:
                            lat.append(time.perf_counter() - t0)
                            served.append((inputs, o))
            except Exception as e:
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

        def traffic(plans, keep=True):
            threads = [threading.Thread(target=run, args=(plan, keep))
                       for plan in plans]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10 * HTTP_TIMEOUT_S)

        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            traffic(plans)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            check(not errors, f"phase 15 (b) {label}: client errors "
                  f"{errors[:1]}")
            bodies = k2_bodies(f"phase 15 (b) {label}", counts)
            stats = json.loads(http_call(srv, "GET", "/stats")[2])
            met = served_metrics(srv)
            # the card's busy share over a repeat of each client's first
            # request, profiled (after the counts and timings)
            busy = busy_share(torch, lambda: traffic(
                [plan[:1] for plan in plans], keep=False))
        finally:
            srv.stop()
        forwards = stats["batches_run"]
        want = dict({name: 0 for name in counts},
                    layer_norm_fwd=(2 * n_blk + 1) * forwards,
                    fused_dense_gelu=n_blk * forwards,
                    flash_fwd=n_blk * forwards)
        check(counts == want, f"phase 15 (b) {label}: launches {counts}, "
              f"expected {want} for {forwards} batches")
        # the served logits against a direct predict of the same rows
        worst = 0.0
        for inputs, o in served:
            direct = im.predict(*(a if batched else a[None]
                                  for a in inputs))
            worst = max(worst, float(np.abs(
                o - (direct if batched else direct[0])).max()))
        check(worst <= 0.05, f"phase 15 (b) {label}: served logits differ "
              f"from a direct predict by {worst} > 0.05")
        n_seq = sum(len(inputs[0]) if batched else 1
                    for inputs, _ in served)
        res[label] = dict(
            clients=len(plans), requests=len(lat), sequences=n_seq,
            wall_s=wall, sequences_per_s=n_seq / wall,
            p50_ms=pct_ms(lat, 50), p99_ms=pct_ms(lat, 99),
            batches=forwards, launches=counts, k2_launches_by_body=bodies,
            logits_max_abs_err_vs_direct=worst, **met, **busy)
        results[label] = counts
    res["phase7_in_process_sequences_per_s"] = phase7["sequences_per_s"]
    res["phase7_in_process_predict_ms_p50"] = phase7["predict_ms_p50"]
    out["b"] = res
    for label in ("per_record_t128", "pre_batched_32x512"):
        r = res[label]
        print(f"phase 15 (b) [{card}] BERT-base {label} over HTTP: "
              f"{r['clients']} clients, {r['sequences']} sequences in "
              f"{r['wall_s']:.3f} s = {r['sequences_per_s']:.1f} "
              f"sequences/s, p50 {r['p50_ms']:.2f} ms, p99 "
              f"{r['p99_ms']:.2f} ms, {r['batches']} batches, queue "
              f"wait p50 {r['queue_wait_ms_p50']:.3f} ms, predict p50 "
              f"{r['predict_ms_p50']:.3f} ms, card busy "
              f"{r['device_busy_share']:.3f} of a profiled repeat, launches "
              f"{r['launches']}, logits vs direct "
              f"{r['logits_max_abs_err_vs_direct']:.3e} (phase 7 in process: "
              f"{phase7['sequences_per_s']:.1f} sequences/s over its mix)",
              flush=True)
    print(f"phase 15 (b) [{card}] BERT-base predict alone from one thread, "
          f"p50 ms: {res['predict_alone_ms_p50']}", flush=True)
    total = {name: sum(c[name] for c in results.values())
             for name in results["per_record_t128"]}
    return total


def serve_generate_http(torch, seed: int, card: str, model, phase6: dict,
                        out: dict):
    """(c) and (d): phase 6's f32 engine behind /generate; greedy streams
    over the port's InputQueue against `engine.generate`, launches exact,
    logits against the plain recompute; then 400 / 413, a refused
    admission with its Retry-After and the retry, and a poisoned lane."""
    import threading

    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    from analytics_zoo_tpu_torch.resilience import RetryPolicy
    from analytics_zoo_tpu_torch.serving import InputQueue, ServingServer
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine

    n_block = model.n_block
    engine = GenerationEngine(model, **GB_GEOM, keep_logits=True,
                              device="cuda")
    engine.warmup()
    served = {}
    submit = engine.submit

    def keep(*a, **kw):
        # the server's streams, for the logits gate
        s = submit(*a, **kw)
        served[s.request_id] = s
        return s
    engine.submit = keep
    rng = np.random.default_rng(seed + 50)
    prompts = [rng.integers(0, model.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, SRV_GEN_REQUESTS)]
    srv = ServingServer(generation_engine=engine).start()
    res = {}
    try:
        # (c)
        outs, meta, errors = [None] * len(prompts), [None] * len(prompts), []

        got_at = [None] * len(prompts)

        def client(j):
            q = InputQueue(srv.host, srv.port)
            try:
                toks, at = [], []
                for tok in q.generate(prompts[j], max_new_tokens=SRV_GEN_NEW,
                                      request_id=f"c-{j}",
                                      timeout=HTTP_TIMEOUT_S):
                    at.append(time.perf_counter())
                    toks.append(tok)
                outs[j], got_at[j] = toks, at
                meta[j] = (q.last_request_id, q.last_generate)
            except Exception as e:
                errors.append(f"{type(e).__name__}: {e}")

        pre0, dec0 = engine.n_prefills, engine.n_decode_steps
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(j,))
                   for j in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10 * HTTP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(not errors, f"phase 15 (c): client errors {errors[:1]}")
        n_pre = engine.n_prefills - pre0
        n_dec = engine.n_decode_steps - dec0
        want = dict({name: 0 for name in counts},
                    layer_norm_fwd=(2 * n_block + 1) * (n_pre + n_dec),
                    paged_decode=n_block * n_dec)
        check(counts == want, f"phase 15 (c): launches {counts}, expected "
              f"{want} ({n_pre} prefills, {n_dec} decode steps)")
        split = paged_decode.launches_by_body["split"]
        check(split == want["paged_decode"],
              f"phase 15 (c): {split} of {want['paged_decode']} K6 launches "
              "on the split body")
        for j, (rid, done) in enumerate(meta):
            check(rid == f"c-{j}", f"phase 15 (c): X-Request-Id {rid!r} "
                  f"echoed for c-{j}")
            check(done["n_tokens"] == SRV_GEN_NEW
                  and done["finish_reason"] == "length"
                  and done["request_id"] == rid,
                  f"phase 15 (c): done line {done}")
        worst, n_cmp, _ = logits_gate(
            torch, model, [served[f"c-{j}"] for j in range(len(prompts))],
            prompts, outs, GB_TOL_F32, "phase 15 (c)")
        http_tps = sum(len(o) for o in outs) / wall
        # a token's way from the engine's push to the client's hands: the
        # handler's chunk write, the socket, the client's parse (one
        # process, one clock)
        deliver = [g - p for j in range(len(prompts))
                   for g, p in zip(got_at[j], served[f"c-{j}"].token_times)]
        dec_ms = statistics.median(list(engine.decode_seconds)[-n_dec:]) \
            * 1e3
        # (d): errors and recovery
        code, _, _ = http_call(srv, "POST", "/generate", b"{not json")
        check(code == 400, f"phase 15 (d): a malformed body answered {code}")
        code, _, _ = http_call(srv, "POST", "/generate", {
            "tokens": [1] * GB_GEOM["max_context"],
            "max_new_tokens": SRV_GEN_NEW})
        check(code == 413, f"phase 15 (d): a prompt past max_context "
              f"answered {code}")
        OrcaContext.fault_plan = {"faults": [{
            "site": "serving.admission", "at": 2, "times": 2,
            "action": "refuse"}]}
        try:
            q = InputQueue(srv.host, srv.port)
            first = q.generate_tokens(prompts[1], max_new_tokens=SRV_GEN_NEW,
                                      timeout=HTTP_TIMEOUT_S)
            walls = list(engine.decode_seconds)
            expect = min(10.0, max(0.05, (len(engine.scheduler.waiting) + 1)
                                   * sum(walls) / len(walls)))
            code, hdrs, body = http_call(srv, "POST", "/generate", {
                "tokens": prompts[0], "max_new_tokens": SRV_GEN_NEW})
            ra = float(hdrs.get("Retry-After") or "nan")
            check(code == 503 and 0.05 <= ra <= 10.0
                  and abs(ra - expect) <= 5e-4 and ra != 0.5
                  and json.loads(body)["retry_after_s"] == round(ra, 3),
                  f"phase 15 (d): refused admission answered {code}, "
                  f"Retry-After {hdrs.get('Retry-After')} (expected "
                  f"{expect:.3f} from the decode steps)")
            retried = q.generate_tokens(
                prompts[0], max_new_tokens=SRV_GEN_NEW,
                retry=RetryPolicy(max_attempts=4), timeout=HTTP_TIMEOUT_S)
            check(retried == outs[0] and first == outs[1]
                  and q.last_retries == 1,
                  f"phase 15 (d): after {q.last_retries} retries the stream "
                  "differs from (c)'s")
        finally:
            OrcaContext.fault_plan = None
        res["refused_retry_after_s"] = ra
        # a poisoned lane among 4: pause the loop so the four requests
        # share the poisoned decode round
        engine.stop()
        victims = {}

        def lane(j):
            q = InputQueue(srv.host, srv.port)
            try:
                toks = q.generate_tokens(prompts[j],
                                         max_new_tokens=SRV_GEN_NEW,
                                         request_id=f"p-{j}",
                                         timeout=HTTP_TIMEOUT_S)
                victims[j] = (toks, q.last_generate)
            except Exception as e:
                victims[j] = (None, f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=lane, args=(j,))
                   for j in range(4)]
        for t in threads:
            t.start()
        t_end = time.monotonic() + HTTP_TIMEOUT_S
        while len(engine.scheduler.waiting) < 4:
            check(time.monotonic() < t_end, "phase 15 (d): the four "
                  "requests never queued")
            time.sleep(0.005)
        OrcaContext.fault_plan = {"faults": [{
            "site": "generation.decode", "at": 3,
            "action": "poison_request", "request_id": "p-2"}]}
        try:
            engine.ensure_started()
            for t in threads:
                t.join(timeout=10 * HTTP_TIMEOUT_S)
        finally:
            OrcaContext.fault_plan = None
        toks, done = victims[2]
        check(done["finish_reason"].startswith("error: evicted")
              and done["n_tokens"] < SRV_GEN_NEW,
              f"phase 15 (d): the victim's stream ended {done}")
        for j in (0, 1, 3):
            check(victims[j][0] == outs[j],
                  f"phase 15 (d): survivor p-{j} differs from its "
                  "unpoisoned stream")
        fifth = InputQueue(srv.host, srv.port).generate_tokens(
            prompts[4], max_new_tokens=SRV_GEN_NEW, timeout=HTTP_TIMEOUT_S)
        check(fifth == outs[4], "phase 15 (d): the request after the "
              "eviction differs from (c)'s")
        check(engine.n_evictions == 1,
              f"phase 15 (d): {engine.n_evictions} evictions")
        res["victim_tokens"] = done["n_tokens"]
    finally:
        srv.stop()
        del engine.submit
    # the in-process reference: each prompt alone through engine.generate
    for j, p in enumerate(prompts):
        check(engine.generate(p, max_new_tokens=SRV_GEN_NEW) == outs[j],
              f"phase 15 (c): the stream of c-{j} over HTTP differs from "
              "engine.generate of its prompt")
    res.update(requests=len(prompts), new_tokens=SRV_GEN_NEW,
               tokens_per_s_http=http_tps,
               phase6_tokens_per_s_in_process=phase6["tokens_per_s"],
               decode_step_ms_p50=dec_ms, prefills=n_pre, decode_steps=n_dec,
               launches=counts, logits_max_abs_err=worst,
               logits_compared=n_cmp,
               token_delivery_ms_p50=pct_ms(deliver, 50),
               token_delivery_ms_p99=pct_ms(deliver, 99))
    out["c_d"] = res
    print(f"phase 15 (c) [{card}] GPT-2 small over /generate: "
          f"{len(prompts)} requests, {http_tps:.1f} tokens/s over HTTP "
          f"(phase 6 in process: {phase6['tokens_per_s']:.1f}); decode "
          f"step p50 {dec_ms:.3f} ms; a token from the engine's push to "
          f"the client p50 {res['token_delivery_ms_p50']:.3f} ms, p99 "
          f"{res['token_delivery_ms_p99']:.3f} ms; launches {counts}; "
          f"logits max abs "
          f"err {worst:.3e} over {n_cmp} positions; streams equal "
          f"engine.generate", flush=True)
    print(f"phase 15 (d) [{card}]: 400 and 413 answered; a refused "
          f"admission gave 503 with Retry-After {ra:.3f} s and the retry "
          f"its stream; the poisoned lane stopped after "
          f"{res['victim_tokens']} tokens, its 3 neighbours and a fifth "
          "request unchanged", flush=True)
    return counts


def serve_saved_ncf(torch, card: str, model, out: dict):
    """(e): the NCF of (a) saved with save_model and served through
    start_serving(ServingConfig(modelPath=...)); /predict against
    ZooModel.predict, the port closed after stop_serving."""
    import os
    import shutil
    import socket
    import tempfile

    from analytics_zoo_tpu_torch.serving import (
        InputQueue,
        ServingConfig,
        start_serving,
        stop_serving,
    )
    tmp = tempfile.mkdtemp()
    try:
        path = model.save_model(os.path.join(tmp, "ncf"))
        rng = np.random.default_rng(SRV_SEED)
        u = rng.integers(1, NCF_CELL["user_count"] + 1, 300).astype(np.int32)
        i = rng.integers(1, NCF_CELL["item_count"] + 1, 300).astype(np.int32)
        want = model.predict({"x": [u, i]}, batch_size=128)
        servers = start_serving(ServingConfig(modelPath=path, port=0))
        try:
            srv = servers["http"]
            got = InputQueue(srv.host, srv.port).predict(u, i, batched=True)
        finally:
            stop_serving(servers)
        err = float(np.abs(got - want).max())
        check(err <= 1e-5, f"phase 15 (e): the served saved model differs "
              f"from ZooModel.predict by {err}")
        with socket.socket() as s:
            s.settimeout(5)
            closed = s.connect_ex(("127.0.0.1", srv.port)) != 0
        check(closed, "phase 15 (e): the port is still open after "
              "stop_serving")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["e"] = dict(rows=len(u), max_abs_err=err, port_closed=closed)
    print(f"phase 15 (e) [{card}]: a saved NeuralCF served through "
          f"start_serving: {len(u)} rows within {err:.3e} of "
          "ZooModel.predict; the port closed after stop_serving",
          flush=True)


def phase_serving(torch, seed: int, card: str, gpt2_model, bert_model,
                  phase6: dict, phase7: dict):
    """Phase 15: the serving front end on the card, scenes (a)-(e)."""
    out = {}
    t0 = time.perf_counter()
    ncf = serve_ncf(torch, seed, card, out)
    launches = {"serving_ncf": out["a"]["launches"]}
    launches["serving_bert"] = serve_bert_http(torch, seed, card,
                                               bert_model, phase7, out)
    launches["serving_generate"] = serve_generate_http(
        torch, seed, card, gpt2_model, phase6, out)
    serve_saved_ncf(torch, card, ncf, out)
    del ncf
    free_card(torch)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 16: int8 weight serving
# ----------------------------------------------------------------------

#: JAX's `quantize_params` on BERT-base's flax tree (`init_bert_params`,
#: 2 classes), read with the JAX package on the CPU: the bytes of the
#: f32 tree and of its quantized form
JAX_BERT_BASE_QUANT = dict(orig_bytes=437_935_112, quant_bytes=109_570_576)
#: the models served in turns in phase 16's comparisons
Q_TURNS = ("bf16", "int8", "int8", "bf16")
#: phase 16 (b): images of one ResNet-50 predict, and predicts a window
Q_IMAGES, Q_IMAGE_REPS = 32, 5
#: the side of phases 16 (b) and 17's images (ImageNet's crop)
ZOO_SIZE = 224


def peak_predict_bytes(torch, im, inputs) -> int:
    """Card memory allocated over one `im.predict(*inputs)` above what
    was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    im.predict(*inputs)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def int8_bert(torch, seed: int, card: str, bert_model):
    """(a): phase 7's BERT-base behind InferenceModel(4, 32), int8 and
    bf16 in turns at phase 7's shapes."""
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.serving import InferenceModel
    from analytics_zoo_tpu_torch.serving.quantize import resident_bytes
    t0 = time.perf_counter()
    ims = {"bf16": InferenceModel(4, 32).load_module(bert_model),
           "int8": InferenceModel(4, 32).load_module(bert_model,
                                                     quantize=True)}
    load_s = time.perf_counter() - t0
    qmodel = ims["int8"]._module
    stats = ims["int8"].quantize_stats
    check({k: stats[k] for k in JAX_BERT_BASE_QUANT} == JAX_BERT_BASE_QUANT,
          f"phase 16 (a): quantize_stats {stats}, JAX's "
          f"{JAX_BERT_BASE_QUANT}")
    vocab = bert_model.bert.token_embed.num_embeddings
    rng = np.random.default_rng(seed + 21)
    reqs = [(n, t) + bert_request(rng, n, t, vocab)
            for t in BERT_LENGTHS for n in BERT_BATCHES for _ in range(2)]
    for im in ims.values():               # every bucket, both models
        for n, t, inputs, _ in reqs[::2]:
            im.predict(*inputs)
    torch.cuda.synchronize()
    walls = {k: [] for k in ims}
    lat = {k: {} for k in ims}
    outs = {k: {} for k in ims}
    counts = None
    for label in Q_TURNS:
        im = ims[label]
        first_int8 = label == "int8" and counts is None
        if first_int8:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for n, t, inputs, valid in reqs:
            s = time.perf_counter()
            out = im.predict(*inputs)
            lat[label].setdefault(f"{n}x{t}", []).append(
                (time.perf_counter() - s) * 1e3)
            outs[label].setdefault((n, t), (inputs, valid, out))
        walls[label].append(time.perf_counter() - t0)
        if first_int8:
            counts = kernels.launch_counts()
            # by body right after the counts, before the next window
            bodies = k2_bodies("phase 16 (a)", counts)
    forwards = sum(-(-n // 32) for n, *_ in reqs)
    n_blk = len(bert_model.bert.blocks)
    want = dict({name: 0 for name in counts},
                layer_norm_fwd=(2 * n_blk + 1) * forwards,
                fused_dense_gelu=n_blk * forwards,
                flash_fwd=n_blk * forwards)
    check(counts == want, f"phase 16 (a): launches {counts}, expected "
          f"{want} for {forwards} quantized forwards")
    done = [(n, t, inputs, valid, out, 0.0)
            for (n, t), (inputs, valid, out) in outs["int8"].items()]
    gate = check_bert_logits(torch, qmodel, done, 0.05, "phase 16 (a) int8")
    agree = [outs["int8"][k][2].argmax(-1) == outs["bf16"][k][2].argmax(-1)
             for k in outs["int8"]]
    n_seq = sum(n for n, *_ in reqs)
    big = next(r[2] for r in reqs if r[:2] == (32, BERT_LENGTHS[-1]))
    peak = {k: peak_predict_bytes(torch, im, big) for k, im in ims.items()}
    res = dict(
        load_s=load_s, quantize_stats=stats,
        jax_quantize_stats=JAX_BERT_BASE_QUANT,
        resident_bytes={"int8": resident_bytes(qmodel),
                        "bf16": resident_bytes(bert_model)},
        sequences_per_s={k: n_seq / statistics.median(v)
                         for k, v in walls.items()},
        windows_s=walls,
        predict_ms_p50={k: {s: statistics.median(v)
                            for s, v in sorted(d.items())}
                        for k, d in lat.items()},
        peak_predict_bytes_32x512=peak, forwards=forwards,
        launches=counts, k2_launches_by_body=bodies,
        top1_agreement_with_bf16=float(np.mean(np.concatenate(agree))),
        **gate)
    print(f"phase 16 (a) [{card}] BERT-base int8: quantize_stats {stats} "
          f"(JAX's {JAX_BERT_BASE_QUANT}), resident bytes "
          f"{res['resident_bytes']}, loaded in {load_s:.1f} s; sequences/s "
          f"{res['sequences_per_s']} (windows in turns {walls}); predict "
          f"p50 ms {res['predict_ms_p50']}; peak bytes over a 32 x 512 "
          f"predict {peak}; launches {counts} over {forwards} forwards; "
          f"logits within {gate['logits_max_abs_err']:.3e} of the plain "
          f"recompute (tol 0.05); top-1 agreement with bf16 "
          f"{res['top1_agreement_with_bf16']:.4f}", flush=True)
    del ims, qmodel
    return res


def settle_batchnorm(torch, model, x) -> None:
    """Running statistics of one batch (as after training): each
    BatchNorm's momentum at 0 for one training forward."""
    from analytics_zoo_tpu_torch.models.image.imageclassification.layers \
        import BatchNorm
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(x)
    for m in bns:
        m.momentum = 0.99
    model.eval()


def int8_resnet(torch, seed: int, card: str):
    """(b): ResNet-50 (ImageClassifier, 2 classes, bf16) int8 and bf16 in
    turns at 32 x ZOO_SIZE^2; the int8 logits against the same
    network with the dequantized weights as plain parameters."""
    import copy

    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier,
    )
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.serving import InferenceModel
    from analytics_zoo_tpu_torch.serving.quantize import resident_bytes
    torch.manual_seed(seed + 22)
    clf = ImageClassifier("resnet-50", num_classes=2, device="cuda")
    x = np.random.default_rng(seed + 23).standard_normal(
        (Q_IMAGES, ZOO_SIZE, ZOO_SIZE, 3), dtype=np.float32)
    settle_batchnorm(torch, clf, torch.from_numpy(x).cuda())
    kernels.reset_launch_counts()
    ims = {"bf16": InferenceModel(4, Q_IMAGES).load_module(clf),
           "int8": InferenceModel(4, Q_IMAGES).load_module(clf,
                                                           quantize=True)}
    qmodel = ims["int8"]._module
    for im in ims.values():
        im.predict(x)
    walls = {k: [] for k in ims}
    for label in Q_TURNS:
        t0 = time.perf_counter()
        for _ in range(Q_IMAGE_REPS):
            ims[label].predict(x)
        walls[label].append(time.perf_counter() - t0)
    got = ims["int8"].predict(x)
    counts = kernels.launch_counts()
    check(not any(counts.values()), f"phase 16 (b): a kernel of ours "
          f"launched on ResNet-50: {counts}")
    plain = copy.deepcopy(clf)
    with torch.no_grad():
        for name, p in plain.named_parameters():
            owner, _, leaf = name.rpartition(".")
            p.copy_(getattr(qmodel.get_submodule(owner), leaf))
        want = plain(torch.from_numpy(x).cuda()).float().cpu().numpy()
    err = float(np.abs(got - want).max())
    check(np.isfinite(got).all() and err <= 0.05,
          f"phase 16 (b): int8 logits differ from the plain recompute by "
          f"{err} > 0.05")
    res = dict(
        quantize_stats=ims["int8"].quantize_stats,
        resident_bytes={"int8": resident_bytes(qmodel),
                        "bf16": resident_bytes(clf)},
        images_per_s={k: Q_IMAGES * Q_IMAGE_REPS / statistics.median(v)
                      for k, v in walls.items()},
        windows_s=walls,
        peak_predict_bytes={k: peak_predict_bytes(torch, im, (x,))
                            for k, im in ims.items()},
        logits_max_abs_err=err, logits_tol=0.05,
        top1_agreement_with_bf16=float(
            (got.argmax(-1) == ims["bf16"].predict(x).argmax(-1)).mean()),
        launches=counts)
    print(f"phase 16 (b) [{card}] ResNet-50 int8 at {Q_IMAGES} x "
          f"{ZOO_SIZE}^2: "
          f"quantize_stats {res['quantize_stats']}, resident bytes "
          f"{res['resident_bytes']}; images/s {res['images_per_s']} "
          f"(windows in turns {walls}); peak bytes over a predict "
          f"{res['peak_predict_bytes']}; logits within {err:.3e} of the "
          f"plain recompute (tol 0.05); no kernel of ours launched",
          flush=True)
    del ims, qmodel, plain, clf
    return res


def int8_ncf_served(torch, seed: int, card: str):
    """(c): NeuralCF at bench.py's widths saved and served by
    start_serving from a config with quantize: true (JAX's
    examples/quantized_encrypted_serving.py, without the encryption);
    /predict rows against a direct quantized predict."""
    import os
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.serving import (
        InferenceModel,
        InputQueue,
        ServingConfig,
        start_serving,
        stop_serving,
    )
    torch.manual_seed(seed + 24)
    model = NeuralCF(**NCF_CELL, device="cuda")
    tmp = tempfile.mkdtemp()
    try:
        path = model.save_model(os.path.join(tmp, "ncf"))
        rng = np.random.default_rng(seed + 25)
        u = rng.integers(1, NCF_CELL["user_count"] + 1, 300).astype(np.int32)
        i = rng.integers(1, NCF_CELL["item_count"] + 1, 300).astype(np.int32)
        direct = InferenceModel().load_model(path, quantize=True)
        want = direct.predict(u, i)
        servers = start_serving(ServingConfig(modelPath=path, port=0,
                                              quantize=True))
        try:
            srv = servers["http"]
            got = InputQueue(srv.host, srv.port).predict(u, i, batched=True)
            stats = servers["model"].quantize_stats
        finally:
            stop_serving(servers)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err = float(np.abs(got - want).max())
    check(err <= 1e-5, f"phase 16 (c): /predict differs from a direct "
          f"quantized predict by {err}")
    print(f"phase 16 (c) [{card}]: a saved NeuralCF served int8 through "
          f"start_serving(quantize: true): {len(u)} rows within {err:.3e} "
          f"of a direct quantized predict; compression "
          f"{stats['compression']:.4f} ({stats})", flush=True)
    return dict(rows=len(u), max_abs_err=err, quantize_stats=stats)


def phase_int8_serving(torch, seed: int, card: str, bert_model):
    """Phase 16: int8 weight serving, scenes (a)-(c)."""
    t0 = time.perf_counter()
    out = dict(a=int8_bert(torch, seed, card, bert_model))
    free_card(torch)
    out["b"] = int8_resnet(torch, seed, card)
    free_card(torch)
    out["c"] = int8_ncf_served(torch, seed, card)
    free_card(torch)
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 17: the image zoo
# ----------------------------------------------------------------------

#: phase 17 (a): ResNet-50 fine-tune batches, steps an epoch, epochs
ZOO_BATCHES = (128, 256)
ZOO_STEPS, ZOO_EPOCHS = 3, 3
#: the first steps of a fit left out of the step times
ZOO_WARM = 2
#: phase 17 (b): the relative tolerance of the f32 ResNet-50 on the card
#: against the port's CPU path for losses, parameters (of the model's
#: largest) and running statistics; each parameter tensor's update (L2,
#: against an f64 step on the CPU from the same state) within the larger
#: of that tolerance and ZOO_UPDATE_K times the f32 CPU path's own error
#: there: an f32 ResNet-50's backward at init, through 53 training-mode
#: BatchNorms, sits percents from f64's in every tensor (PERF.md §6);
#: the f32 CPU path itself must stay within ZOO_REF_TOL of f64's
ZOO_F32_TOL, ZOO_UPDATE_K, ZOO_REF_TOL = 1e-3, 4.0, 0.1
#: phase 17 (c): the other backbones' batch and fit steps
ZOO_OTHER_BATCH, ZOO_OTHER_STEPS = 64, 5
#: phase 17 (d): detector batch and fit steps (epochs on one batch)
DET_BATCH, DET_STEPS = 32, 5


def zoo_images(rng, n: int, size: int = ZOO_SIZE):
    """n NHWC f32 images (standard normal) with a learnable label: class
    1's top-left quarter is brighter by 0.5 in the red channel."""
    y = rng.permutation(np.arange(n) % 2).astype(np.int32)
    x = rng.standard_normal((n, size, size, 3), dtype=np.float32)
    x[y == 1, :size // 2, :size // 2, 0] += 0.5
    return x, y


def forward_flops(torch, model, size: int = ZOO_SIZE) -> float:
    """Multiply-add FLOPs (2 per MAC) of one image's forward, from the
    shapes the convs and dense layers see."""
    from analytics_zoo_tpu_torch.models.image.imageclassification.layers \
        import Conv, Dense
    total = [0.0]

    def hook(mod, args, out):
        if isinstance(mod, Conv):
            kh, kw = mod.kernel
            total[0] += 2.0 * out.numel() * mod.weight.shape[1] * kh * kw
        else:
            total[0] += 2.0 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3, device="cuda"))
    model.train(was)
    for h in hooks:
        h.remove()
    return total[0]


def marked_fit(torch, model, data, batch: int, epochs: int):
    """`model.fit` with a CUDA event as each step is queued (phase 8's
    timing), the peak of allocated card memory over it: (step times in
    s after the first ZOO_WARM, peak bytes above the bytes before, wall
    s, epoch losses)."""
    est = model._require_estimator()
    eng = est.engine
    marks = []

    def marked_step(b, step=eng.train_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(b)

    eng.train_step = marked_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n_before = len(est.train_summary)
    t0 = time.perf_counter()
    model.fit(data, epochs=epochs, batch_size=batch, shuffle=False)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng.train_step
    times = [a.elapsed_time(b) / 1e3
             for a, b in zip(marks[ZOO_WARM:-1], marks[ZOO_WARM + 1:])]
    losses = [s["loss"] for s in est.train_summary[n_before:]]
    return times, torch.cuda.max_memory_allocated() - base, wall, losses


#: phase 17 (a)'s step profile: substrings of cuDNN's and cuBLAS's
#: kernel names (everything else is glue: casts, elementwise passes,
#: reductions, copies)
CONV_KERNELS = ("conv", "cudnn", "xmma", "implicit", "gemm", "cutlass",
                "wgrad", "dgrad", "fprop")


def zoo_step_profile(torch, model, x, y, iters: int = 3) -> dict:
    """Where one training step's time goes on a staged batch: host wall
    a step, device ms by op from the profiler (every event summed),
    split into cuDNN's and cuBLAS's kernels and the rest, and the host's
    own time by op."""
    eng = model._require_estimator().engine
    batch = eng.put_batch({"features": (x,), "labels": (y,),
                           "mask": np.ones(len(x), np.float32)})

    def step():
        eng.train_step(batch)

    step()
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    from torch.autograd import DeviceType
    _, _, prof = device_ms(step, iters=iters)
    # summed, not a median per name: one name covers elementwise passes
    # over every layer's size
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            per[e.name] = per.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / iters
    dev = sum(per.values()) or None
    conv = sum(v for n, v in per.items()
               if any(k in n.lower() for k in CONV_KERNELS))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / iters, e.count
                    / iters) for e in prof.key_averages()),
                  key=lambda t: -t[1])[:12]
    return dict(batch=len(x), wall_ms_per_step=statistics.median(walls),
                device_ms_per_step=dev, conv_and_gemm_ms=conv,
                other_ms=(dev - conv) if dev else None,
                device_busy_share=(dev / statistics.median(walls)
                                   if dev else None),
                top_device_ops_ms=[(n[:90], v) for n, v in top],
                top_host_ops_self_ms_and_calls=[(n[:60], v, c)
                                                for n, v, c in host])


def image_set_feed(seed: int, n: int):
    """ImageSet.from_arrays of n uint8 images 8 pixels wider than
    ZOO_SIZE through a seeded chain (random crop to ZOO_SIZE, flip,
    channel normalization, to f32) and to_dataset(): (XShards, seconds
    the transforms took)."""
    from analytics_zoo_tpu_torch.feature.image import (
        ImageChannelNormalize,
        ImageHFlip,
        ImageMatToTensor,
        ImageRandomCrop,
        ImageSet,
    )
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.arange(n) % 2).astype(np.int32)
    side = ZOO_SIZE + 8
    imgs = rng.integers(0, 200, (n, side, side, 3), dtype=np.uint8)
    imgs[y == 1, :side // 2, :side // 2, 0] += 55
    t0 = time.perf_counter()
    chain = (ImageRandomCrop(ZOO_SIZE, ZOO_SIZE, seed=seed)
             >> ImageHFlip(0.5, seed=seed + 1)
             >> ImageChannelNormalize(123.0, 117.0, 104.0, 58.4, 57.1, 57.4)
             >> ImageMatToTensor())
    ds = ImageSet.from_arrays(list(imgs), list(y)).transform(chain) \
        .to_dataset()
    return ds, time.perf_counter() - t0


def resnet50_finetune(torch, seed: int, card: str):
    """(a): ImageClassifier("resnet-50", 2) bf16 through
    model.estimator(...).fit at batch 128 and 256 from the arrays, and
    at 256 from an ImageSet chain."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier,
    )
    runs = []
    for batch, feed in [(b, "arrays") for b in ZOO_BATCHES] + [
            (ZOO_BATCHES[-1], "image_set")]:
        torch.manual_seed(seed + 26)
        model = ImageClassifier("resnet-50", num_classes=2, device="cuda")
        model.estimator(optimizer="adam", learning_rate=1e-3, seed=seed)
        n = batch * ZOO_STEPS
        t0 = time.perf_counter()
        if feed == "arrays":
            x, y = zoo_images(np.random.default_rng(seed + 27), n)
            data, epochs, transform_s = {"x": x, "y": y}, ZOO_EPOCHS, None
        else:
            data, transform_s = image_set_feed(seed + 28, n)
            epochs = 2
        make_s = time.perf_counter() - t0
        times, peak, wall, losses = marked_fit(torch, model, data, batch,
                                               epochs)
        check(all(np.isfinite(losses)), f"phase 17 (a): epoch losses "
              f"{losses}")
        p50 = statistics.median(times)
        flops = forward_flops(torch, model)
        busy = busy_share(torch, lambda: model.fit(
            data, epochs=1, batch_size=batch, shuffle=False), top_host=10)
        run = dict(batch=batch, feed=feed, epochs=epochs, steps_per_epoch=
                   ZOO_STEPS, data_s=make_s, transform_s=transform_s,
                   step_ms_p50=p50 * 1e3, step_ms=[t * 1e3 for t in times],
                   images_per_s=batch / p50, fit_wall_s=wall,
                   images_per_s_wall=n * epochs / wall,
                   peak_bytes_above_start=peak,
                   forward_gflops_per_image=flops / 1e9,
                   resnet50_train_mfu=3 * flops * batch / p50 / BF16_FLOPS,
                   epoch_losses=losses, **busy)
        if feed == "arrays" and batch == ZOO_BATCHES[-1]:
            run["step_profile"] = zoo_step_profile(torch, model, x[:batch],
                                                   y[:batch])
            print(f"phase 17 (a) [{card}] ResNet-50 step profile at batch "
                  f"{batch}: {json.dumps(run['step_profile'])}; host ops "
                  f"over a profiled fit epoch ({ZOO_STEPS} steps): "
                  f"{json.dumps(busy['top_host_ops_self_ms_and_calls'])}",
                  flush=True)
        if feed == "arrays" and batch == ZOO_BATCHES[0]:
            check(losses[-1] < losses[0], f"phase 17 (a): the epoch loss "
                  f"did not fall over {ZOO_EPOCHS} epochs: {losses}")
            xb = x[:batch]
            got = model.predict({"x": xb}, batch_size=batch)
            with torch.no_grad():
                want = model.eval()(torch.from_numpy(xb).cuda()).float()
            check(np.array_equal(got, want.cpu().numpy()),
                  "phase 17 (a): predict after fit differs from an "
                  "eval-mode forward")
            run["predict_equals_eval_forward"] = True
        runs.append(run)
        print(f"phase 17 (a) [{card}] ResNet-50 fine-tune bf16, batch "
              f"{batch} from {feed}: step p50 {run['step_ms_p50']:.3f} ms = "
              f"{run['images_per_s']:.1f} images/s, resnet50_train_mfu "
              f"{run['resnet50_train_mfu']:.4f} (3 x "
              f"{run['forward_gflops_per_image']:.3f} GFLOP an image, of "
              f"989 TFLOP/s bf16), card busy share "
              f"{run['device_busy_share']:.3f}, peak "
              f"{peak / 2**30:.2f} GiB above the start, epoch losses "
              f"{[round(v, 4) for v in losses]}, fit wall {wall:.2f} s"
              + (f", transforms {transform_s:.2f} s" if transform_s
                 else ""), flush=True)
        del model, data
        free_card(torch)
    return runs


def sgd_step_f64(torch, m, x, y, lr: float) -> float:
    """One SGD step of `m`, a ResNet in f64 on the CPU, by hand: the
    model's forward with its head in f64 too (the model's own takes
    the pooled features to f32), the mean cross-entropy, p -= lr * grad;
    returns the loss."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.models.image.imageclassification.layers \
        import max_pool, to_nchw
    m.train()
    m.zero_grad(set_to_none=True)
    h = torch.relu(m.stem_bn(m.stem(to_nchw(
        torch.from_numpy(x).double()))))
    h = max_pool(h, 3, 2, "SAME")
    for name, blk in m.named_children():
        if name.startswith("stage"):
            h = blk(h)
    logits = F.linear(h.mean(dim=(2, 3)), m.head.weight, m.head.bias)
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    with torch.no_grad():
        for p in m.parameters():
            p -= lr * p.grad
    return loss.item()


def gate_f32_resnet50(torch, seed: int, card: str):
    """(b): an f32 ResNet-50, 2 SGD steps at batch 8 on the card and on
    the port's CPU path (TF32 off), with an f64 step on the CPU beside
    them, the CPU copies taking each step from the card's state before
    it: each step's loss, the parameters and the running statistics
    after it within ZOO_F32_TOL of the CPU path's; each parameter
    tensor's update against the f64 one (ZOO_UPDATE_K, ZOO_REF_TOL);
    then predict and save / load."""
    import os
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ResNet50,
    )
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "phase 17 (b) needs TF32 off")
    lr = 1e-3
    x, y = zoo_images(np.random.default_rng(seed + 29), 16)
    torch.manual_seed(seed + 30)
    card_m = ResNet50(num_classes=2, dtype=torch.float32, device="cuda")
    cpu_m = ResNet50(num_classes=2, dtype=torch.float32, device="cpu")
    ref_m = ResNet50(num_classes=2, dtype=torch.float64,
                     device="cpu").double()
    ests = {m: Estimator.from_torch(
        m, loss="sparse_categorical_crossentropy", optimizer="sgd",
        learning_rate=lr) for m in (card_m, cpu_m)}

    def host(m, params=True):
        items = m.named_parameters() if params else m.named_buffers()
        return {k: v.detach().cpu().double() for k, v in items}

    def l2(a, b):
        return float((a - b).norm())

    errs = {k: 0.0 for k in ("losses", "ref_losses", "params",
                             "running_stats")}
    worst, losses = {}, {"card": [], "cpu": [], "f64": []}
    upd = {"card": {}, "cpu": {}}
    for step in range(2):
        state = {k: v.cpu() for k, v in card_m.state_dict().items()}
        cpu_m.load_state_dict(state)
        ref_m.load_state_dict(state)
        p0 = host(cpu_m)
        xb, yb = x[8 * step:8 * step + 8], y[8 * step:8 * step + 8]
        for label, m in (("card", card_m), ("cpu", cpu_m)):
            ests[m].fit({"x": xb, "y": yb}, epochs=1, batch_size=8,
                        shuffle=False)
            losses[label].append(ests[m].train_summary[-1]["loss"])
        losses["f64"].append(sgd_step_f64(torch, ref_m, xb, yb, lr))
        pc, ph, pr = host(card_m), host(cpu_m), host(ref_m)
        bc, bh = host(card_m, False), host(cpu_m, False)
        # each tensor's update (L2) against the f64 one, the card's and
        # the f32 CPU path's
        for label, p in (("card", pc), ("cpu", ph)):
            for k, v in p.items():
                ref = max(l2(pr[k], p0[k]), 1e-300)
                e = l2(v, pr[k]) / ref
                upd[label][k] = max(upd[label].get(k, 0.0), e)
        # parameters against the model's largest; a running mean in
        # units of its feature's spread, a running variance against its
        # largest
        p_scale = max(float(v.abs().max()) for v in ph.values())
        parts = dict(
            params={k: float((pc[k] - v).abs().max()) / p_scale
                    for k, v in ph.items()},
            running_stats={k: float((bc[k] - v).abs().max() / (
                bh[k.replace("mean", "var")].sqrt().max()
                if k.endswith("running_mean") else v.abs().max()))
                for k, v in bh.items()})
        for name, d in parts.items():
            k = max(d, key=d.get)
            if d[k] >= errs[name]:
                errs[name], worst[name] = d[k], f"{k} (step {step + 1})"
        for name, a, b in (("losses", "card", "cpu"),
                           ("ref_losses", "cpu", "f64")):
            errs[name] = max(errs[name], abs(
                losses[a][-1] - losses[b][-1]) / abs(losses[b][-1]))
    allowed = {k: max(ZOO_F32_TOL, ZOO_UPDATE_K * e)
               for k, e in upd["cpu"].items()}
    over = {k: (e, allowed[k]) for k, e in upd["card"].items()
            if e > allowed[k]}
    ratio = {k: e / max(upd["cpu"][k], 1e-300)
             for k, e in upd["card"].items()}
    update = dict(
        card_max=max(upd["card"].values()),
        card_median=float(np.median(list(upd["card"].values()))),
        cpu_max=max(upd["cpu"].values()),
        cpu_median=float(np.median(list(upd["cpu"].values()))),
        ratio_max=max(ratio.values()),
        worst_ratio=max(ratio, key=ratio.get),
        n_tensors=len(ratio))
    check(all(v <= ZOO_F32_TOL for v in errs.values()),
          f"phase 17 (b): card vs CPU relative errors {errs} (tol "
          f"{ZOO_F32_TOL}; worst {worst}; losses {losses})")
    check(update["cpu_max"] <= ZOO_REF_TOL,
          f"phase 17 (b): the f32 CPU path's updates are "
          f"{update['cpu_max']} from the f64 step's (tol {ZOO_REF_TOL}): "
          f"the reference does not take the same step")
    check(not over, f"phase 17 (b): updates on the card past "
          f"max({ZOO_F32_TOL}, {ZOO_UPDATE_K} x the f32 CPU path's "
          f"error) from the f64 step: {over}")
    got = ests[card_m].predict({"x": x}, batch_size=8)
    card_m.eval()
    with torch.no_grad():       # batch by batch, at predict's shapes
        want = np.concatenate([card_m(torch.from_numpy(x[i:i + 8]).cuda())
                               .cpu().numpy() for i in (0, 8)])
    check(np.array_equal(got, want), "phase 17 (b): predict after fit "
          "differs from an eval-mode forward")
    tmp = tempfile.mkdtemp()
    try:
        path = card_m.save_model(os.path.join(tmp, "resnet50"))
        back = type(card_m).load_model(path)
        a, b = card_m.state_dict(), back.state_dict()
        same = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(same, "phase 17 (b): save_model -> load_model is not bitwise")
    n_buffers = sum(1 for k in a if "running" in k)
    print(f"phase 17 (b) [{card}] f32 ResNet-50, 2 SGD steps ({lr}) at "
          f"batch 8, card vs CPU from the card's state before each step "
          f"(TF32 off): relative errors {errs} (tol {ZOO_F32_TOL}; worst "
          f"{worst}); each tensor's update (L2) against an f64 step: "
          f"{update} (tol max({ZOO_F32_TOL}, {ZOO_UPDATE_K} x the CPU's), "
          f"the CPU's within {ZOO_REF_TOL}); losses {losses}; predict == "
          f"eval forward; save/load bitwise over {len(a)} tensors "
          f"({n_buffers} running statistics)", flush=True)
    return dict(rel_errors=errs, worst=worst, tol=ZOO_F32_TOL,
                update_vs_f64=update, update_k=ZOO_UPDATE_K,
                ref_tol=ZOO_REF_TOL, losses=losses,
                predict_equals_eval_forward=True, save_load_bitwise=True,
                tensors=len(a))


def other_backbones(torch, seed: int, card: str):
    """(c): Inception-v1, MobileNetV2 and VGG-16 at full width, at
    ZOO_SIZE^2, 5 fit steps each at batch 64."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        InceptionV1,
        MobileNetV2,
        VGG16,
    )
    x, y = zoo_images(np.random.default_rng(seed + 31), ZOO_OTHER_BATCH)
    n = ZOO_OTHER_STEPS
    data = {"x": np.concatenate([x] * n), "y": np.concatenate([y] * n)}
    out = {}
    for name, cls in (("inception-v1", InceptionV1),
                      ("mobilenet-v2", MobileNetV2), ("vgg-16", VGG16)):
        torch.manual_seed(seed + 32)
        model = cls(num_classes=2, device="cuda", **(
            {"image_size": ZOO_SIZE} if cls is VGG16 else {}))
        model.estimator(optimizer="adam", learning_rate=1e-3, seed=seed)
        times, peak, wall, _ = marked_fit(torch, model, data,
                                          ZOO_OTHER_BATCH, 1)
        steps = [s["loss"] for s in model._estimator.engine.last_steps]
        check(len(steps) == n and all(np.isfinite(steps)),
              f"phase 17 (c): {name} step losses {steps}")
        p50 = statistics.median(times)
        out[name] = dict(step_ms_p50=p50 * 1e3,
                         images_per_s=ZOO_OTHER_BATCH / p50,
                         peak_bytes_above_start=peak, step_losses=steps,
                         fit_wall_s=wall)
        print(f"phase 17 (c) [{card}] {name} bf16, batch {ZOO_OTHER_BATCH} "
              f"at {ZOO_SIZE}^2: step p50 {p50 * 1e3:.3f} ms = "
              f"{ZOO_OTHER_BATCH / p50:.1f} images/s, peak "
              f"{peak / 2**30:.2f} GiB, step losses "
              f"{[round(v, 4) for v in steps]}", flush=True)
        del model
        free_card(torch)
    return out


def squares(rng, n: int, size: int):
    """n images of one bright square each, its box and label 1, padded
    to 4 boxes an image."""
    from analytics_zoo_tpu_torch.models.image.objectdetection.box_utils \
        import pad_ground_truth
    imgs = rng.uniform(0, 0.2, (n, size, size, 3)).astype(np.float32)
    boxes, labels = [], []
    for i in range(n):
        w = int(rng.integers(size // 4, size // 2))
        x0, y0 = rng.integers(0, size - w, 2)
        imgs[i, y0:y0 + w, x0:x0 + w] = 1.0
        boxes.append(np.array([[x0, y0, x0 + w, y0 + w]], np.float32) / size)
        labels.append(np.array([1]))
    return imgs, pad_ground_truth(boxes, labels, 4)


def detectors(torch, seed: int, card: str):
    """(d): SSD and Faster R-CNN at JAX's defaults, DET_STEPS fit steps
    on one repeated batch; detect with the host NMS."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        FasterRCNNDetector,
        SSDDetector,
    )
    out = {}
    for name, cls in (("ssd", SSDDetector),
                      ("faster_rcnn", FasterRCNNDetector)):
        torch.manual_seed(seed + 33)
        det = cls(num_classes=1, device="cuda")
        imgs, (boxes, labels) = squares(np.random.default_rng(seed + 34),
                                        DET_BATCH, det._config["image_size"])
        t0 = time.perf_counter()
        det.fit({"x": imgs, "y": [boxes, labels]}, epochs=DET_STEPS,
                batch_size=DET_BATCH, shuffle=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [s["loss"] for s in det._estimator.train_summary]
        check(len(losses) == DET_STEPS and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"phase 17 (d): {name} losses {losses} (finite and falling)")
        max_det = 20
        found = det.detect(imgs[:8], score_threshold=0.0, max_det=max_det)
        counts = [len(b) for b, _, _ in found]
        inside = all(((b >= 0) & (b <= 1)).all() for b, _, _ in found)
        check(len(found) == 8 and max(counts) <= max_det and inside,
              f"phase 17 (d): {name} detections {counts} (at most "
              f"{max_det}), inside [0, 1]: {inside}")
        out[name] = dict(losses=losses, fit_wall_s=wall,
                         detections_per_image=counts)
        print(f"phase 17 (d) [{card}] {name} at JAX's defaults: "
              f"{DET_STEPS} steps at batch {DET_BATCH}, losses "
              f"{[round(v, 4) for v in losses]} in {wall:.2f} s; detect: "
              f"{counts} boxes an image (max {max_det}), all inside [0, 1]",
              flush=True)
        del det
        free_card(torch)
    return out


def phase_image_zoo(torch, seed: int, card: str):
    """Phase 17: the image zoo, scenes (a)-(d); no kernel of ours
    launches in any of them."""
    from analytics_zoo_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    out = dict(a=resnet50_finetune(torch, seed, card))
    out["b"] = gate_f32_resnet50(torch, seed, card)
    free_card(torch)
    out["c"] = other_backbones(torch, seed, card)
    out["d"] = detectors(torch, seed, card)
    torch.cuda.synchronize()
    out["launches"] = kernels.launch_counts()
    check(not any(out["launches"].values()),
          f"phase 17 launched a kernel of ours: {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 18: the rest of the model zoo
# ----------------------------------------------------------------------

#: (a): the fine-tune after the checkpoint load: batch x t, steps
PT_BATCH, PT_T, PT_STEPS = 32, 128, 3
#: (a): the first step's loss (bf16 on the card) against the f32 CPU
#: recompute: |d CE| <= 2 max |d logit| (the CE's gradient in the
#: logits has an L1 norm of at most 2), and phase 7's bf16 logits gate
#: is 0.05
PT_LOSS_TOL = 0.1
#: (b): the TextClassifier's cell (the JAX defaults, news20's 20
#: classes), batch, steps an epoch, epochs, rows compared with the CPU
TC_CELL = dict(class_num=20, vocab_size=20000, embed_dim=200,
               sequence_length=500, encoder_output_dim=256)
TC_BATCH, TC_STEPS, TC_EPOCHS, TC_CMP = 128, 4, 2, 64
#: f32 on both sides with TF32 off; the recurrences run 500 steps of
#: f32 rounding in other orders (cuDNN against the CPU's kernels)
ZR_F32_TOL = 1e-4
#: (c): KNRM at the JAX defaults, its batch and steps; the grouped
#: relations (queries x candidates)
KNRM_BATCH, KNRM_STEPS, KNRM_QUERIES, KNRM_CANDS = 256, 4, 64, 10
#: (d): Seq2Seq's hidden width, layers, features, encoder and decoder
#: lengths, sequences, batch; AnomalyDetector's unroll and series length
S2S_HIDDEN, S2S_LAYERS, S2S_FEATURES = 64, 2, 2
S2S_T_ENC, S2S_T_DEC, S2S_N, S2S_BATCH = 32, 24, 256, 64
AD_UNROLL, AD_SERIES, AD_BATCH, AD_ANOMALIES = 24, 2048, 256, 5
#: (e): VAE images and batch; (f): GAN samples, batch, epochs
VAE_N, VAE_BATCH = 1024, 128
GAN_N, GAN_BATCH, GAN_EPOCHS, GAN_NOISE = 512, 64, 20, 4


def cpu_copy(model, cls, **kw):
    """The port's CPU path: `cls(**kw, device="cpu")` with `model`'s
    weights, in eval mode."""
    m = cls(**kw, device="cpu")
    m.load_state_dict({k: v.detach().cpu()
                       for k, v in model.state_dict().items()})
    return m.eval()


def zr_bert_pretrained(torch, seed: int, card: str):
    """(a): BERT-base from a checkpoint file through `set_params`, then a
    fine-tune of PT_STEPS steps with every kernel's launches exact."""
    import shutil
    import tempfile

    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.convert import (
        _flatten,
        bert_from_flax,
        bert_to_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.models.bert_pretrained import (
        export_bert_weights,
        load_bert_pretrained,
        read_pretrained,
    )
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    cfg = dict(BERT_BASE, num_classes=2)
    tmp = tempfile.mkdtemp(prefix="zoo_rest_")
    try:
        src = init_bert_params(cfg, seed + 41)
        named = export_bert_weights(src, fmt="hf")
        t0 = time.perf_counter()
        torch.save({k: torch.from_numpy(v) for k, v in named.items()},
                   f"{tmp}/pytorch_model.bin")
        save_s = time.perf_counter() - t0
        # the model's own weights are another seed's: the load must
        # replace every encoder tensor and keep the head
        model = BERTClassifier(**cfg, attn_impl="flash", hidden_drop=0.0,
                               attn_drop=0.0, device="cuda")
        model.load_state_dict(bert_from_flax(init_bert_params(cfg, seed + 42),
                                             cfg))
        head = {k: v.clone() for k, v in model.state_dict().items()
                if k.startswith("classifier.")}
        est = Estimator.from_torch(model,
                                   loss="sparse_categorical_crossentropy",
                                   optimizer="adam", learning_rate=2e-5,
                                   metrics=["accuracy"], seed=seed)
        t0 = time.perf_counter()
        est.set_params(lambda p: load_bert_pretrained(p, tmp))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = _flatten(bert_to_flax(model.state_dict(), cfg)["bert"])
        want = _flatten(src["bert"])
        bad = [k for k in want if not np.array_equal(got.get(k), want[k])]
        check(not bad and got.keys() == want.keys(),
              f"phase 18 (a): encoder tensors differ from the file's: "
              f"{bad[:5]}")
        check(all(torch.equal(model.state_dict()[k], v)
                  for k, v in head.items()),
              "phase 18 (a): the classifier head did not keep its init")
        # export -> re-read -> load, bitwise
        again = export_bert_weights(model, fmt="hf")
        check(again.keys() == named.keys() and all(
            np.array_equal(again[k], named[k]) for k in named),
            "phase 18 (a): the loaded model exports other tensors")
        torch.save({k: torch.from_numpy(v) for k, v in again.items()},
                   f"{tmp}/again.bin")
        reread = read_pretrained(f"{tmp}/again.bin")
        check(reread.keys() == again.keys() and all(
            np.array_equal(reread[k], again[k]) for k in again),
            "phase 18 (a): the re-read file differs from the export")
        reloaded = load_bert_pretrained(model, reread)
        check(all(torch.equal(v.cpu(), model.state_dict()[k].cpu())
                  for k, v in reloaded.items()),
              "phase 18 (a): export -> re-read -> load is not bitwise")
        del reloaded, reread, again, got, want
        before = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rng = np.random.default_rng(seed + 43)
    inputs, y, valid = train_batch(rng, PT_BATCH, PT_T, cfg["vocab"])
    data = {"x": [np.concatenate([a] * PT_STEPS) for a in inputs],
            "y": np.concatenate([y] * PT_STEPS)}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(data, epochs=1, batch_size=PT_BATCH, shuffle=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_blk = cfg["n_block"]
    want = {"layer_norm_fwd": (2 * n_blk + 1) * PT_STEPS,
            "layer_norm_bwd": (2 * n_blk + 1) * PT_STEPS,
            "fused_dense_gelu": n_blk * PT_STEPS,
            "flash_fwd": n_blk * PT_STEPS, "flash_bwd_dq": n_blk * PT_STEPS,
            "flash_bwd_dkv": n_blk * PT_STEPS, "flash_bwd_dbias": 0,
            "paged_decode": 0}
    check(counts == want, f"phase 18 (a): launches {counts}, expected "
          f"{want} for {PT_STEPS} steps (phase 8's per step)")
    bodies = k2_bodies("phase 18 (a)", counts)
    losses = [s["loss"] for s in est.engine.last_steps]
    check(len(losses) == PT_STEPS and all(np.isfinite(losses)),
          f"phase 18 (a): step losses {losses}")
    # the first step's loss: dropout is off, so it is the loss of the
    # loaded weights, recomputed in f32 on the CPU through the plain path
    ref = BERTClassifier(**cfg, attn_impl="flash", hidden_drop=0.0,
                         attn_drop=0.0, compute_dtype=torch.float32,
                         device="cpu").eval()
    ref.load_state_dict(before)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = ref(*(torch.from_numpy(a) for a in inputs))
        cpu_loss = float(F.cross_entropy(logits, torch.from_numpy(y).long()))
    cpu_s = time.perf_counter() - t0
    loss_err = abs(losses[0] - cpu_loss)
    check(loss_err <= PT_LOSS_TOL, f"phase 18 (a): first step's loss "
          f"{losses[0]} vs the f32 CPU recompute {cpu_loss}: {loss_err} > "
          f"{PT_LOSS_TOL}")
    del ref, model, est, before
    free_card(torch)
    return dict(checkpoint_bytes=int(sum(v.nbytes for v in named.values())),
                save_s=save_s, set_params_s=load_s, fit_s=fit_s,
                steps=PT_STEPS, batch=PT_BATCH, t=PT_T, valid_tokens=valid,
                losses=losses, first_loss_cpu_f32=cpu_loss,
                first_loss_err=loss_err, first_loss_tol=PT_LOSS_TOL,
                launches=counts, k2_launches_by_body=bodies,
                launches_per_step={k: v / PT_STEPS for k, v in counts.items()},
                cpu_recompute_s=cpu_s)


def zr_fit(torch, model, data, batch: int, epochs: int, **kw):
    """`epochs` of `model.fit` (the model's own estimator, keywords
    passed to it), no shuffle; (estimator, wall s of the last epoch)."""
    est = model.estimator(**kw)
    est.fit(data, epochs=epochs, batch_size=batch, shuffle=False)
    torch.cuda.synchronize()
    return est, est.train_summary[-1]["wall_s"]


def zr_text_classifiers(torch, seed: int, card: str):
    """(b): TextClassifier at the JAX defaults, 20 classes, for each
    encoder: a fit, predict, and the logits against the CPU path."""
    from analytics_zoo_tpu_torch.models.textclassification import (
        TextClassifier,
    )
    rng = np.random.default_rng(seed + 44)
    n = TC_BATCH * TC_STEPS
    ids = rng.integers(0, TC_CELL["vocab_size"],
                       (n, TC_CELL["sequence_length"])).astype(np.int32)
    # a learnable label: the class of the first token
    y = (ids[:, 0] % TC_CELL["class_num"]).astype(np.int32)
    out, kept = {}, None
    for enc in ("cnn", "lstm", "gru"):
        torch.manual_seed(seed + 45)
        model = TextClassifier(**TC_CELL, encoder=enc, device="cuda")
        est, wall = zr_fit(torch, model, {"x": ids, "y": y}, TC_BATCH,
                           TC_EPOCHS, optimizer="adam", learning_rate=1e-3,
                           seed=seed)
        losses = [s["loss"] for s in est.train_summary]
        check(all(np.isfinite(losses)), f"phase 18 (b) {enc}: {losses}")
        logits = model.predict({"x": ids[:TC_CMP]}, batch_size=TC_BATCH)
        ref = cpu_copy(model, TextClassifier, **TC_CELL, encoder=enc)
        with torch.no_grad():
            want = ref(torch.from_numpy(ids[:TC_CMP])).numpy()
        err = float(np.abs(logits - want).max())
        check(logits.shape == (TC_CMP, TC_CELL["class_num"])
              and np.isfinite(logits).all() and err <= ZR_F32_TOL,
              f"phase 18 (b) {enc}: logits vs the CPU path {err} > "
              f"{ZR_F32_TOL}")
        out[enc] = dict(epoch_losses=losses, last_epoch_s=wall,
                        steps_per_s=TC_STEPS / wall,
                        sequences_per_s=n / wall, logits_max_abs_err=err)
        print(f"phase 18 (b) [{card}] TextClassifier {enc}, batch "
              f"{TC_BATCH} x {TC_CELL['sequence_length']} tokens: "
              f"{TC_STEPS / wall:.2f} steps/s = {n / wall:.1f} "
              f"sequences/s (last epoch of {TC_EPOCHS}), epoch losses "
              f"{[round(v, 4) for v in losses]}, logits vs CPU "
              f"{err:.3e}", flush=True)
        if enc == "gru":
            kept = (model, ids[:2 * TC_BATCH], y[:2 * TC_BATCH])
        else:
            del model, est
    return out, kept


def grouped_relations(rng, n_q: int, n_c: int, q_len: int, d_len: int,
                      vocab: int):
    """{"x": [n_q, n_c, q_len + d_len] ids, "y": [n_q, n_c]}: a relevant
    candidate shares half the query's tokens with probability 0.7, an
    irrelevant one with probability 0.2; the last candidate of every
    other query is padding (label -1)."""
    q = rng.integers(0, vocab, (n_q, 1, q_len))
    d = rng.integers(0, vocab, (n_q, n_c, d_len))
    y = rng.integers(0, 2, (n_q, n_c)).astype(np.float32)
    hit = rng.random((n_q, n_c)) < np.where(y > 0, 0.7, 0.2)
    d[..., :q_len // 2] = np.where(hit[..., None], q[..., :q_len // 2],
                                   d[..., :q_len // 2])
    y[::2, -1] = -1
    x = np.concatenate([np.broadcast_to(q, (n_q, n_c, q_len)), d], axis=-1)
    return {"x": x.astype(np.int32), "y": y}


def zr_knrm(torch, seed: int, card: str):
    """(c): KNRM at the JAX defaults: a fit, then NDCG@3, NDCG@5 and MAP
    over an XShards of grouped relations, against the CPU path."""
    from analytics_zoo_tpu_torch.models.common import ranker
    from analytics_zoo_tpu_torch.models.textmatching import KNRM
    from analytics_zoo_tpu_torch.orca.data import XShards
    rng = np.random.default_rng(seed + 46)
    torch.manual_seed(seed + 47)
    model = KNRM(device="cuda")
    q_len, d_len, vocab = 10, 40, 20000
    n = KNRM_BATCH * KNRM_STEPS
    train = grouped_relations(rng, n, 1, q_len, d_len, vocab)
    x = train["x"][:, 0]
    est, wall = zr_fit(torch, model, {"x": [x[:, :q_len], x[:, q_len:]],
                                      "y": np.maximum(train["y"][:, 0], 0)},
                       KNRM_BATCH, 1, optimizer="adam", learning_rate=1e-3,
                       seed=seed)
    loss = est.train_summary[-1]["loss"]
    check(np.isfinite(loss), f"phase 18 (c): KNRM loss {loss}")
    rel = grouped_relations(rng, KNRM_QUERIES, KNRM_CANDS, q_len, d_len,
                            vocab)
    half = KNRM_QUERIES // 2
    shards = XShards([{"x": rel["x"][:half], "y": rel["y"][:half]},
                      {"x": rel["x"][half:], "y": rel["y"][half:]}])
    scores, labels = model.score_relations(shards)
    metrics = dict(ndcg_3=model.evaluate_ndcg(shards, 3),
                   ndcg_5=model.evaluate_ndcg(shards, 5),
                   map=model.evaluate_map(shards))
    ref = cpu_copy(model, KNRM)
    cpu_scores, cpu_labels = ref.score_relations(shards)
    err = float(np.abs(scores - cpu_scores).max())
    same_order = bool((np.argsort(-scores, axis=1)
                       == np.argsort(-cpu_scores, axis=1)).all())
    cpu_metrics = dict(ndcg_3=ranker.ndcg_at_k(cpu_scores, cpu_labels, 3),
                       ndcg_5=ranker.ndcg_at_k(cpu_scores, cpu_labels, 5),
                       map=ranker.mean_average_precision(cpu_scores,
                                                         cpu_labels))
    check(err <= ZR_F32_TOL and same_order and metrics == cpu_metrics
          and np.array_equal(labels, cpu_labels),
          f"phase 18 (c): scores vs the CPU path {err} (tol {ZR_F32_TOL}), "
          f"same order {same_order}, metrics {metrics} vs {cpu_metrics}")
    out = dict(fit_s=wall, steps=KNRM_STEPS, batch=KNRM_BATCH,
               samples_per_s=n / wall, loss=loss, scores_max_abs_err=err,
               **metrics)
    print(f"phase 18 (c) [{card}] KNRM at the JAX defaults: {KNRM_STEPS} "
          f"steps at batch {KNRM_BATCH} in {wall:.3f} s, loss {loss:.4f}; "
          f"over {KNRM_QUERIES} queries x {KNRM_CANDS} candidates NDCG@3 "
          f"{metrics['ndcg_3']:.4f}, NDCG@5 {metrics['ndcg_5']:.4f}, MAP "
          f"{metrics['map']:.4f} (equal to the CPU path's), scores vs "
          f"CPU {err:.3e}", flush=True)
    return out


def zr_sequences(torch, seed: int, card: str):
    """(d): Seq2Seq (LSTM and GRU, 2 layers, the dense bridge) fit and
    `infer` against the CPU path; AnomalyDetector fit and
    `detect_anomalies`."""
    from analytics_zoo_tpu_torch.models.anomalydetection import (
        AnomalyDetector,
        detect_anomalies,
    )
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2Seq
    rng = np.random.default_rng(seed + 48)
    # two phase-shifted sines per sequence: decode the continuation
    t = np.arange(S2S_T_ENC + S2S_T_DEC + 1)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, (S2S_N, 1, S2S_FEATURES))
    wave = np.sin(t / 4.0 + phase).astype(np.float32)
    enc = wave[:, :S2S_T_ENC]
    dec_in = wave[:, S2S_T_ENC - 1:-2]
    dec_out = wave[:, S2S_T_ENC:-1]
    out = {}
    for cell in ("lstm", "gru"):
        kw = dict(hidden_size=S2S_HIDDEN, num_layers=S2S_LAYERS,
                  output_dim=S2S_FEATURES, bridge="dense", cell_type=cell,
                  input_dim=S2S_FEATURES)
        torch.manual_seed(seed + 49)
        model = Seq2Seq(**kw, device="cuda")
        est, wall = zr_fit(torch, model, {"x": [enc, dec_in], "y": dec_out},
                           S2S_BATCH, 2, optimizer="adam", learning_rate=1e-3,
                           seed=seed)
        losses = [s["loss"] for s in est.train_summary]
        check(all(np.isfinite(losses)), f"phase 18 (d) {cell}: {losses}")
        with torch.no_grad():
            got = model.infer(torch.from_numpy(enc[:S2S_BATCH]).cuda(),
                              torch.from_numpy(dec_in[:S2S_BATCH, 0]).cuda(),
                              S2S_T_DEC).cpu().numpy()
        ref = cpu_copy(model, Seq2Seq, **kw)
        want = ref.infer(torch.from_numpy(enc[:S2S_BATCH]),
                         torch.from_numpy(dec_in[:S2S_BATCH, 0]),
                         S2S_T_DEC).numpy()
        err = float(np.abs(got - want).max())
        check(got.shape == (S2S_BATCH, S2S_T_DEC, S2S_FEATURES)
              and err <= ZR_F32_TOL,
              f"phase 18 (d) {cell}: infer vs the CPU path {err} > "
              f"{ZR_F32_TOL}")
        out[f"seq2seq_{cell}"] = dict(epoch_losses=losses, last_epoch_s=wall,
                                      infer_max_abs_err=err)
        del model, est
    series = (np.sin(np.arange(AD_SERIES + AD_UNROLL) / 8.0)
              + rng.normal(0, 0.05, AD_SERIES + AD_UNROLL)).astype(np.float32)
    spikes = rng.choice(np.arange(AD_UNROLL, len(series)), AD_ANOMALIES,
                        replace=False)
    series[spikes] += 3.0
    x, y = AnomalyDetector.unroll(series, AD_UNROLL)
    torch.manual_seed(seed + 50)
    det = AnomalyDetector(device="cuda")
    est, wall = zr_fit(torch, det, {"x": x, "y": y}, AD_BATCH, 2,
                       optimizer="adam", learning_rate=1e-3, seed=seed)
    pred = det.predict({"x": x}, batch_size=AD_BATCH)
    found = detect_anomalies(y, pred, AD_ANOMALIES)
    ref = cpu_copy(det, AnomalyDetector)
    with torch.no_grad():
        want = ref(torch.from_numpy(x[:AD_BATCH])).numpy()
    err = float(np.abs(pred[:AD_BATCH] - want).max())
    check(len(found) == AD_ANOMALIES and len(set(found.tolist()))
          == AD_ANOMALIES and err <= ZR_F32_TOL,
          f"phase 18 (d) AnomalyDetector: {found} ({AD_ANOMALIES} wanted), "
          f"predictions vs the CPU path {err}")
    out["anomaly_detector"] = dict(
        epoch_losses=[s["loss"] for s in est.train_summary],
        last_epoch_s=wall, windows=len(x), anomalies=found.tolist(),
        spikes_found=len(set((spikes - AD_UNROLL).tolist())
                         & set(found.tolist())),
        predict_max_abs_err=err)
    print(f"phase 18 (d) [{card}] Seq2Seq {S2S_LAYERS} layers x "
          f"{S2S_HIDDEN}, dense bridge: "
          + ", ".join(f"{c} infer vs CPU "
                      f"{out[f'seq2seq_{c}']['infer_max_abs_err']:.3e}"
                      for c in ("lstm", "gru"))
          + f"; AnomalyDetector {len(x)} windows of {AD_UNROLL}: anomalies "
          f"{found.tolist()} ({out['anomaly_detector']['spikes_found']} of "
          f"{AD_ANOMALIES} spikes), predictions vs CPU {err:.3e}", flush=True)
    return out


def zr_vae(torch, seed: int, card: str):
    """(e): the VAE at the JAX defaults through `VAE.estimator()`."""
    from analytics_zoo_tpu_torch.models import VAE
    rng = np.random.default_rng(seed + 51)
    # a bright disc at a random place in each image
    yy, xx = np.mgrid[:28, :28]
    cy, cx = rng.uniform(8, 20, (2, VAE_N, 1, 1))
    imgs = (((yy - cy) ** 2 + (xx - cx) ** 2) < 25).astype(np.float32)
    imgs = imgs[..., None]
    torch.manual_seed(seed + 52)
    vae = VAE(device="cuda")
    est, wall = zr_fit(torch, vae, {"x": imgs, "y": imgs}, VAE_BATCH, 2,
                       seed=seed)
    rows = est.train_summary
    check(all("aux_loss" in r and np.isfinite(r["aux_loss"])
              and np.isfinite(r["loss"]) for r in rows),
          f"phase 18 (e): train_summary {rows}")
    gen = vae.generate(16)
    check(gen.shape == (16, 28, 28, 1) and gen.min() >= 0.0
          and gen.max() <= 1.0, "phase 18 (e): generate(16) out of [0, 1]")
    # eval decodes the posterior mean, so two calls agree; cuDNN's
    # transposed convs pick algorithms that sum in a varying order unless
    # deterministic ones are asked for (the spread reported)
    rec = vae.reconstruct(imgs[:64])
    spread = float(np.abs(rec - vae.reconstruct(imgs[:64])).max())
    with deterministic(torch):
        rec = vae.reconstruct(imgs[:64])
        check(np.array_equal(rec, vae.reconstruct(imgs[:64])),
              "phase 18 (e): reconstruct differs between two calls under "
              "deterministic algorithms")
    out = dict(epoch_losses=[r["loss"] for r in rows],
               epoch_aux_losses=[r["aux_loss"] for r in rows],
               last_epoch_s=wall, images_per_s=VAE_N / wall,
               reconstruct_spread_default_algorithms=spread,
               reconstruction_bce_per_image=float(np.mean(
                   -(imgs[:64] * np.log(np.clip(rec, 1e-7, 1))
                     + (1 - imgs[:64]) * np.log(np.clip(1 - rec, 1e-7, 1)))
                   .sum(axis=(1, 2, 3)))))
    print(f"phase 18 (e) [{card}] VAE 28x28x1, latent 2: epoch losses "
          f"{[round(v, 3) for v in out['epoch_losses']]}, aux (KL) "
          f"{[round(v, 3) for v in out['epoch_aux_losses']]}, "
          f"{out['images_per_s']:.0f} images/s; reconstruct bitwise on two "
          f"calls under deterministic algorithms ({spread:.3e} apart "
          f"without)", flush=True)
    return out


def zr_gan(torch, seed: int, card: str):
    """(f): GANEstimator on the 2-d Gaussian of JAX's GAN test (MLP G and
    D); its first batch's update against the CPU step on the same
    noise."""
    from torch import nn

    from analytics_zoo_tpu_torch.orca.learn import GANEstimator

    def mlp(fan_in, out):
        return nn.Sequential(nn.Linear(fan_in, 32), nn.ReLU(),
                             nn.Linear(32, out))

    real = np.random.default_rng(seed + 53).normal(
        [3.0, -2.0], 0.3, (GAN_N, 2)).astype(np.float32)
    torch.manual_seed(seed + 54)
    g0, d0 = mlp(GAN_NOISE, 2), mlp(2, 1)
    sides = {}
    for device in ("cpu", "cuda"):
        gan = GANEstimator(mlp(GAN_NOISE, 2).to(device),
                           mlp(2, 1).to(device), noise_dim=GAN_NOISE,
                           seed=seed)
        gan.gen.load_state_dict(g0.state_dict())
        gan.disc.load_state_dict(d0.state_dict())
        sides[device] = gan
    # the first batch and its noise as fit draws them on the card
    order = np.random.default_rng(seed).permutation(GAN_N)
    first = real[order[:GAN_BATCH]]
    draw = torch.Generator(device="cuda")
    draw.manual_seed(seed)
    noise = [torch.randn((GAN_BATCH, GAN_NOISE), generator=draw,
                         device="cuda") for _ in range(2)]
    for device, gan in sides.items():
        gan._step(torch.from_numpy(first).to(device),
                  [noise[0].to(device)], [noise[1].to(device)])
    err = max(float((a.detach().cpu() - b.detach()).abs().max())
              for side in ("gen", "disc")
              for a, b in zip(getattr(sides["cuda"], side).parameters(),
                              getattr(sides["cpu"], side).parameters()))
    check(err <= 1e-5, f"phase 18 (f): the first batch's update on the "
          f"card differs from the CPU step's by {err} > 1e-5")
    gan = GANEstimator(mlp(GAN_NOISE, 2).cuda(), mlp(2, 1).cuda(),
                       noise_dim=GAN_NOISE, seed=seed)
    gan.gen.load_state_dict(g0.state_dict())
    gan.disc.load_state_dict(d0.state_dict())
    t0 = time.perf_counter()
    gan.fit({"x": real}, epochs=GAN_EPOCHS, batch_size=GAN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fake = gan.generate(256)
    center = fake.mean(axis=0)
    check(np.isfinite(fake).all() and len(gan.train_summary) == GAN_EPOCHS,
          f"phase 18 (f): generate {center}, summary {gan.train_summary}")
    steps = GAN_EPOCHS * (GAN_N // GAN_BATCH)
    out = dict(first_batch_max_abs_err=err, fit_s=wall,
               batches_per_s=steps / wall, fake_center=center.tolist(),
               last=gan.train_summary[-1])
    print(f"phase 18 (f) [{card}] GANEstimator: first batch vs CPU "
          f"{err:.3e}; {steps} batches of {GAN_BATCH} in {wall:.2f} s "
          f"({steps / wall:.1f} batches/s), generated mean {center} "
          f"(real (3, -2))", flush=True)
    return out


def zr_inference_estimator(torch, kept, card: str):
    """(g): InferenceEstimator.from_saved_model on (b)'s GRU
    TextClassifier: predict bitwise the model's own, evaluate's accuracy
    Estimator.evaluate's, fit raising."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.orca.learn import InferenceEstimator
    model, ids, y = kept
    tmp = tempfile.mkdtemp(prefix="zoo_rest_tc_")
    try:
        path = model.save_model(f"{tmp}/tc")
        inf = InferenceEstimator.from_saved_model(path)
        got = inf.predict({"x": ids}, batch_size=TC_BATCH)
        own = model.predict({"x": ids}, batch_size=TC_BATCH)
        check(np.array_equal(got, own), "phase 18 (g): predict differs from "
              f"the model's own by {float(np.abs(got - own).max())}")
        acc = inf.evaluate({"x": ids, "y": y}, batch_size=TC_BATCH)
        want = model.evaluate({"x": ids, "y": y},
                              batch_size=TC_BATCH)["accuracy"]
        check(abs(acc["accuracy"] - want) <= 1e-6,
              f"phase 18 (g): accuracy {acc} vs Estimator.evaluate's {want}")
        try:
            inf.fit({"x": ids, "y": y})
            raised = False
        except NotImplementedError:
            raised = True
        check(raised, "phase 18 (g): InferenceEstimator.fit did not raise")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 18 (g) [{card}] InferenceEstimator.from_saved_model: "
          f"predict bitwise the model's, accuracy {acc['accuracy']:.4f} = "
          f"Estimator.evaluate's, fit raises", flush=True)
    return dict(accuracy=acc["accuracy"], rows=len(ids))


def phase_zoo_rest(torch, seed: int, card: str):
    """Phase 18: the rest of the model zoo, scenes (a)-(g); (a) on the
    kernels, the others on none of ours."""
    from analytics_zoo_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    out = dict(a=zr_bert_pretrained(torch, seed, card))
    print(f"phase 18 (a) [{card}] BERT-base from pytorch_model.bin "
          f"({out['a']['checkpoint_bytes']} bytes) through set_params in "
          f"{out['a']['set_params_s']:.2f} s, encoder bitwise the file's, "
          f"head kept, export -> re-read -> load bitwise; {PT_STEPS} steps "
          f"at {PT_BATCH} x {PT_T}: losses "
          f"{[round(v, 4) for v in out['a']['losses']]}, first vs the f32 "
          f"CPU recompute {out['a']['first_loss_err']:.3e} (tol "
          f"{PT_LOSS_TOL}); launches per step "
          f"{out['a']['launches_per_step']}", flush=True)
    kernels.reset_launch_counts()
    out["b"], kept = zr_text_classifiers(torch, seed, card)
    out["c"] = zr_knrm(torch, seed, card)
    out["d"] = zr_sequences(torch, seed, card)
    out["e"] = zr_vae(torch, seed, card)
    out["f"] = zr_gan(torch, seed, card)
    out["g"] = zr_inference_estimator(torch, kept, card)
    del kept
    torch.cuda.synchronize()
    # the models of (b)-(g) run on cuDNN and cuBLAS alone
    out["launches"] = kernels.launch_counts()
    check(not any(out["launches"].values()),
          f"phase 18 (b)-(g) launched a kernel of ours: {out['launches']}")
    free_card(torch)
    out["seconds"] = time.perf_counter() - t0
    print("zoo_rest " + json.dumps(dict(
        card=card, seconds=out["seconds"],
        bert_pretrained={k: out["a"][k] for k in (
            "set_params_s", "fit_s", "losses", "first_loss_err",
            "launches_per_step")},
        text_classifier={k: {m: v[m] for m in ("steps_per_s",
                                               "sequences_per_s",
                                               "logits_max_abs_err")}
                         for k, v in out["b"].items()},
        knrm={k: out["c"][k] for k in ("ndcg_3", "ndcg_5", "map",
                                        "samples_per_s")},
        seq2seq={k: v for k, v in out["d"].items()},
        vae={k: out["e"][k] for k in ("epoch_losses", "epoch_aux_losses",
                                       "images_per_s")},
        gan={k: out["f"][k] for k in ("first_batch_max_abs_err",
                                       "batches_per_s")},
        inference_estimator=out["g"])), flush=True)
    return out


# ----------------------------------------------------------------------
# phase 19: the Keras-style API (keras/, keras2/, Estimator.from_keras)
# ----------------------------------------------------------------------

#: (a): BASELINE.json config #1, the README NCF toy, at bench.py's NCF
#: widths (bench.py:65-70)
KERAS_NCF = dict(users=200_000, items=50_000, embed=64,
                 hidden=(256, 256, 128), classes=2)
KERAS_NCF_BATCH, KERAS_NCF_STEPS = 16384, 6
#: (b): a Keras BERT layer at BERT-base's widths + LayerNormalization +
#: Dense(2) on the pooled output
KERAS_BERT_BATCH, KERAS_BERT_T, KERAS_BERT_STEPS = 32, 128, 4
#: (c): a Keras TransformerLayer at GPT-2 small's widths, t = 4096
KERAS_GPT = dict(vocab=50257, hidden_size=768, n_head=12, n_block=12,
                 seq_len=4096)
KERAS_GPT_BATCH, KERAS_GPT_STEPS = 2, 3
#: (b), (c): the logits through the kernels against the plain versions,
#: bf16 on both (phase 7's logit gate), of max(1, |plain|)
KERAS_LOGITS_TOL = 0.05
#: (c): seed of the scene that holds K3, K4a, K4b and K5 at the
#: TransformerLayer's shape, drawn from a generator of its own
KERAS_FLASH_SEED = 13
#: (d): eval-mode outputs on the card against the CPU path in f32 (TF32
#: off), of max(1, |CPU|): f32 sums in other orders (cuDNN's convs and
#: RNNs against the CPU's)
KERAS_STACK_TOL = 1e-4


def keras_fit(torch, est, data, batch: int, epochs: int = 1):
    """`est.fit` with a CUDA event as each step is queued (phase 8's
    timing) and the launches it made, the first step a warm one: (step
    periods in s after the first, peak bytes above the bytes before,
    host wall s per step, launches, per-step losses)."""
    from analytics_zoo_tpu_torch.ops import kernels
    eng = est.engine
    marks = []

    def marked_step(b, step=eng.train_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(b)

    eng.train_step = marked_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(data, epochs=epochs, batch_size=batch, shuffle=False)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng.train_step
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(marks[1:-1], marks[2:])]
    losses = [s["loss"] for s in eng.last_steps]
    return (times, torch.cuda.max_memory_allocated() - base,
            wall / (len(marks) - 1), kernels.launch_counts(), losses)


def keras_step_profile(torch, est, feats, y, iters: int = 3) -> dict:
    """Host wall per train step (synchronized, without the profiler)
    beside the card's time per step (every device event of a profiled
    window summed) and their ratio, the card's busy share."""
    eng = est.engine
    host = {"features": tuple(feats), "labels": (y,),
            "mask": np.ones(len(y), np.float32)}
    return step_profile(torch, lambda: eng.train_step(eng.put_batch(host)),
                        iters)


def step_profile(torch, step, iters: int = 3) -> dict:
    """Host wall of one `step()` (synchronized, without the profiler)
    beside the card's time for it (every device event of a profiled
    window summed) and their ratio, the card's busy share."""
    from torch.autograd import DeviceType
    step()
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, _, prof = device_ms(step, iters=iters)
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation) / 1e3 / iters
    wall = statistics.median(walls)
    return dict(host_wall_ms_per_step=wall, device_ms_per_step=dev,
                device_busy_share=dev / wall)


def keras_launches_want(steps: int, ln: int, k2: int, flash: int) -> dict:
    return {"layer_norm_fwd": ln * steps, "layer_norm_bwd": ln * steps,
            "fused_dense_gelu": k2 * steps, "flash_fwd": flash * steps,
            "flash_bwd_dq": flash * steps, "flash_bwd_dkv": flash * steps,
            "flash_bwd_dbias": 0, "paged_decode": 0}


def keras_ncf(torch, seed: int, card: str) -> dict:
    """(a): the README NCF toy at bench.py's widths, fit through
    `Estimator.from_keras(model)` and once through `model.fit`."""
    from functools import partial as _partial

    from analytics_zoo_tpu_torch.keras import Input, Model, optimizers
    from analytics_zoo_tpu_torch.keras import layers as L
    from analytics_zoo_tpu_torch.orca.learn import Estimator, losses
    c = KERAS_NCF
    u_in, i_in = Input(shape=(), name="user"), Input(shape=(), name="item")
    u_emb = L.Embedding(c["users"] + 1, c["embed"])
    i_emb = L.Embedding(c["items"] + 1, c["embed"])
    h = L.Concat()([L.Flatten()(u_emb(u_in)), L.Flatten()(i_emb(i_in))])
    first = L.Dense(c["hidden"][0], activation="relu")
    h = first(h)
    for width in c["hidden"][1:]:
        h = L.Dense(width, activation="relu")(h)
    out = L.Dense(c["classes"], activation="softmax")(h)
    model = Model(input=[u_in, i_in], output=out, device="cuda")
    # a softmax output: the cross-entropy of probabilities
    loss = _partial(losses.sparse_categorical_crossentropy,
                    from_logits=False)
    model.compile(optimizer=optimizers.Adam(learning_rate=5e-3), loss=loss,
                  metrics=["accuracy"])
    n = KERAS_NCF_BATCH * KERAS_NCF_STEPS
    rng = np.random.default_rng(seed + 61)
    # ids from a tenth of each table, so that each recurs within an
    # epoch and the loss can fall in three; the tables keep their widths
    user = rng.integers(1, c["users"] // 10 + 1, n).astype(np.int32)
    item = rng.integers(1, c["items"] // 10 + 1, n).astype(np.int32)
    y = ((user + item) % 2).astype(np.int32)
    data = {"x": [user, item], "y": y}
    est = Estimator.from_keras(model, seed=seed)
    check(est.engine is None, "phase 19 (a): the engine exists before data")
    t0 = time.perf_counter()
    est.fit(data, epochs=1, batch_size=KERAS_NCF_BATCH, shuffle=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    gm = est.get_model()
    check(getattr(gm, u_emb.name).weight.shape == (c["users"] + 1, c["embed"])
          and getattr(gm, first.name).weight.shape
          == (c["hidden"][0], 2 * c["embed"]),
          "phase 19 (a): the graph was not built at its widths")
    times, peak, host_s, counts, losses_ = keras_fit(
        torch, est, data, KERAS_NCF_BATCH, epochs=2)
    check(not any(counts.values()),
          f"phase 19 (a): the NCF toy launched a kernel of ours: {counts}")
    epochs = [s["loss"] for s in est.train_summary]
    check(all(np.isfinite(epochs)) and epochs[-1] < epochs[0],
          f"phase 19 (a): epoch losses {epochs} did not fall")
    step = statistics.median(times)
    prof = keras_step_profile(torch, est, (user[:KERAS_NCF_BATCH],
                                           item[:KERAS_NCF_BATCH]),
                              y[:KERAS_NCF_BATCH])
    # and once through the model's own fit (its own estimator)
    model.fit(data, batch_size=KERAS_NCF_BATCH, nb_epoch=1, shuffle=False)
    mest = model._ensure_estimator()
    check(mest.engine.host_step == KERAS_NCF_STEPS
          and np.isfinite(mest.train_summary[-1]["loss"]),
          f"phase 19 (a): model.fit ran {mest.engine.host_step} steps")
    k = min(4096, n)
    preds = model.predict({"x": [user[:k], item[:k]]}, batch_size=k)
    check(preds.shape == (k, 2) and np.allclose(preds.sum(1), 1.0,
                                                atol=1e-5),
          "phase 19 (a): predictions are not softmax rows")
    out = dict(batch=KERAS_NCF_BATCH, steps_per_epoch=KERAS_NCF_STEPS,
               first_epoch_s_with_build=first_s, epoch_losses=epochs,
               step_ms_p50=step * 1e3,
               samples_per_s=KERAS_NCF_BATCH / step,
               peak_bytes_above_weights=peak, host_wall_ms_per_step=host_s
               * 1e3, step_profile=prof, launches=counts,
               model_fit_loss=mest.train_summary[-1]["loss"])
    print(f"phase 19 (a) [{card}] NCF toy (from_keras) at 200,000 x 50,000 "
          f"x 64, MLP 256-256-128, batch {KERAS_NCF_BATCH}: step p50 "
          f"{step * 1e3:.3f} ms, {out['samples_per_s']:.0f} samples/s, "
          f"peak {peak / 2**20:.1f} MiB above the weights, host "
          f"{prof['host_wall_ms_per_step']:.3f} ms vs card "
          f"{prof['device_ms_per_step']:.3f} ms a step; epoch losses "
          f"{[round(v, 5) for v in epochs]}; no kernel of ours launched",
          flush=True)
    del model, est, mest, gm
    free_card(torch)
    return out


def keras_bert(torch, seed: int, card: str) -> dict:
    """(b): a Keras BERT layer at BERT-base's widths, LayerNormalization
    and Dense(2) on its pooled output, compiled and fit; launches per
    step exact; the Keras BERT forward bitwise the port's
    TransformerEncoder's on the same weights."""
    from analytics_zoo_tpu_torch.keras import Input, Model, optimizers
    from analytics_zoo_tpu_torch.keras import layers as L
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        TransformerEncoder)
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE
    vocab = BERT_BASE["vocab"]
    inputs = [Input(shape=(KERAS_BERT_T,)) for _ in range(4)]
    bert = L.BERT(vocab=vocab, hidden_size=768, n_block=12, n_head=12,
                  intermediate_size=3072, seq_len=512)
    seq, pooled = bert(inputs)
    out = L.Dense(2)(L.LayerNormalization()(pooled))
    model = Model(inputs, out, device="cuda")
    model.compile(optimizer=optimizers.Adam(learning_rate=2e-5),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    rng = np.random.default_rng(seed + 62)
    b, t = KERAS_BERT_BATCH, KERAS_BERT_T
    (ids, seg, mask), y, _ = train_batch(rng, b, t, vocab)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    one = [ids, seg, pos, mask]
    steps = KERAS_BERT_STEPS + 1
    data = {"x": [np.concatenate([a] * steps) for a in one],
            "y": np.concatenate([y] * steps)}
    # the first fit builds the graph on its first batch and warms up
    model.fit({"x": one, "y": y}, batch_size=b, nb_epoch=1, shuffle=False)
    est = model._ensure_estimator()
    times, peak, host_s, counts, losses_ = keras_fit(torch, est, data, b)
    want = keras_launches_want(steps, 2 * 12 + 2, 12, 0)
    check(counts == want, f"phase 19 (b): launches {counts}, expected "
          f"{want} for {steps} steps (K1 26, K1b 26, K2 12 a step)")
    bodies = k2_bodies("phase 19 (b)", counts)
    check(all(np.isfinite(losses_)), f"phase 19 (b): losses {losses_}")
    prof = keras_step_profile(torch, est, one, y)
    # the Keras BERT against the encoder on the same weights, eval mode
    gm = est.get_model().eval()
    enc = TransformerEncoder(**bert.cfg, device="cuda").eval()
    enc.load_state_dict({k[len(bert.name) + 1:]: v for k, v in
                         gm.state_dict().items()
                         if k.startswith(bert.name + ".")})
    probe = Model(inputs, [seq, pooled], device="cuda").to_torch()
    on_card = [torch.from_numpy(a).cuda() for a in one]
    probe.build(*[a[:1] for a in on_card])
    probe.load_state_dict({k: v for k, v in gm.state_dict().items()
                           if k.startswith(bert.name + ".")})
    with torch.no_grad():
        got = probe.eval()(*on_card)
        want_out = enc(*on_card)
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want_out))
    check(bitwise, "phase 19 (b): the Keras BERT forward is not bitwise "
          "the TransformerEncoder's on the same weights")
    # and the whole graph's logits against the plain versions (K1, K2)
    with torch.no_grad():
        logits = gm(*on_card).float()
        ref = gm(*on_card, impl="reference").float()
    err = float((logits - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    check(bool(torch.isfinite(logits).all())
          and err <= KERAS_LOGITS_TOL * scale, f"phase 19 (b): logits vs "
          f"the plain versions {err} > {KERAS_LOGITS_TOL} x {scale}")
    step = statistics.median(times)
    res = dict(batch=b, t=t, steps=steps, losses=losses_,
               step_ms_p50=step * 1e3, steps_per_s=1 / step,
               samples_per_s=b / step, tokens_per_s=b * t / step,
               peak_bytes_above_weights=peak,
               host_wall_ms_per_step=host_s * 1e3, step_profile=prof,
               launches=counts, k2_launches_by_body=bodies,
               launches_per_step={k: v / steps for k, v in counts.items()},
               keras_bert_bitwise_encoder=bitwise, logits_max_abs_err=err,
               logits_tol=KERAS_LOGITS_TOL * scale)
    print(f"phase 19 (b) [{card}] Keras BERT-base + LayerNormalization + "
          f"Dense(2), {b} x {t}: step p50 {step * 1e3:.3f} ms "
          f"({res['steps_per_s']:.2f} steps/s, {res['samples_per_s']:.1f} "
          f"samples/s), peak {peak / 2**30:.3f} GiB above the weights, host "
          f"{prof['host_wall_ms_per_step']:.3f} ms vs card "
          f"{prof['device_ms_per_step']:.3f} ms a step; launches per step "
          f"{res['launches_per_step']}; the BERT forward bitwise the "
          f"encoder's; logits vs the plain versions {err:.3e} (tol "
          f"{KERAS_LOGITS_TOL * scale:.3f})", flush=True)
    del model, est, gm, enc, probe, got, want_out, logits, ref
    free_card(torch)
    return res


def keras_gpt_kernels(torch, b: int, t: int, h: int, d: int) -> dict:
    """(c)'s flash kernels at the TransformerLayer's own shape, bf16:
    K3, K4a, K4b (and K5 on the bias cases) against their plain versions
    in phase 5's cases, gated as at t <= 512, and in the layer's own:
    causal q, k, v read in place from a fused qkv, no key mask, with and
    without dropout 0.1 at the seed triple (seed, 0, 0) that fit gives
    it.  Returns the errors and their shares of the tolerance."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(KERAS_FLASH_SEED)
    scene = flash_scene(torch, gen, b, t, h, d, torch.bfloat16)
    fused = scene[1]
    seed3 = torch.tensor([1234, 0, 0], dtype=torch.int32, device="cuda")
    own = {"fused-qkv+causal": (fused, dict(causal=True)),
           "fused-qkv+causal+dropout0.1": (fused, dict(
               causal=True, seed3=seed3, dropout=0.1))}
    what = " (phase 19 (c))"
    f_errs, f_shares = check_flash_fwd(torch, scene, b, t, torch.bfloat16,
                                       what, extra=own)
    b_errs, b_shares = check_flash_bwd(torch, gen, scene, b, t,
                                       torch.bfloat16, what, extra=own)
    del scene, fused, own
    free_card(torch)
    return dict(fwd_errors={k: list(e) for k, e in f_errs.items()},
                fwd_max_share_of_tol=max(f_shares.values()),
                bwd_errors=b_errs,
                bwd_max_share_of_tol=max(b_shares.values()))


def keras_gpt(torch, seed: int, card: str) -> dict:
    """(c): a Keras TransformerLayer at GPT-2 small's widths with
    Select(1, -1) -> Dense(2), fit at t = 4096 (auto attention: flash);
    launches per step exact; one forward's logits against the plain
    versions on the same weights; then the flash kernels against their
    plain versions at the layer's shape (`keras_gpt_kernels`)."""
    from analytics_zoo_tpu_torch.keras import Input, Model, optimizers
    from analytics_zoo_tpu_torch.keras import layers as L
    c = KERAS_GPT
    t_in = Input(shape=(c["seq_len"],))
    h = L.TransformerLayer(**c)(t_in)
    out = L.Dense(2)(L.Select(1, -1)(h))
    model = Model(t_in, out, device="cuda")
    model.compile(optimizer=optimizers.Adam(learning_rate=1e-4),
                  loss="sparse_categorical_crossentropy")
    rng = np.random.default_rng(seed + 63)
    b, t = KERAS_GPT_BATCH, c["seq_len"]
    ids = rng.integers(0, c["vocab"], (b, t)).astype(np.int32)
    y = (ids[:, -1] < c["vocab"] // 2).astype(np.int32)
    steps = KERAS_GPT_STEPS + 1
    data = {"x": np.concatenate([ids] * steps),
            "y": np.concatenate([y] * steps)}
    model.fit(ids, y, batch_size=b, nb_epoch=1, shuffle=False)
    est = model._ensure_estimator()
    times, peak, host_s, counts, losses_ = keras_fit(torch, est, data, b)
    want = keras_launches_want(steps, 2 * 12 + 1, 12, 12)
    check(counts == want, f"phase 19 (c): launches {counts}, expected "
          f"{want} for {steps} steps (K1 25, K1b 25, K2 12, K3 12, K4a 12, "
          f"K4b 12 a step)")
    bodies = k2_bodies("phase 19 (c)", counts)
    check(all(np.isfinite(losses_)), f"phase 19 (c): losses {losses_}")
    prof = keras_step_profile(torch, est, [ids], y)
    gm = est.get_model().eval()
    x = torch.from_numpy(ids).cuda()
    with torch.no_grad():
        got = gm(x).float()
        ref = gm(x, impl="reference").float()
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    check(err <= KERAS_LOGITS_TOL * scale, f"phase 19 (c): logits vs the plain "
          f"versions {err} > {KERAS_LOGITS_TOL} x {scale}")
    step = statistics.median(times)
    res = dict(batch=b, t=t, steps=steps, losses=losses_,
               step_ms_p50=step * 1e3, steps_per_s=1 / step,
               tokens_per_s=b * t / step, peak_bytes_above_weights=peak,
               host_wall_ms_per_step=host_s * 1e3, step_profile=prof,
               launches=counts, k2_launches_by_body=bodies,
               launches_per_step={k: v / steps for k, v in counts.items()},
               logits_max_abs_err=err, logits_tol=KERAS_LOGITS_TOL * scale)
    print(f"phase 19 (c) [{card}] Keras TransformerLayer at GPT-2 small, "
          f"{b} x {t}: step p50 {step * 1e3:.3f} ms "
          f"({res['tokens_per_s']:.0f} tokens/s), peak "
          f"{peak / 2**30:.3f} GiB above the weights, host "
          f"{prof['host_wall_ms_per_step']:.3f} ms vs card "
          f"{prof['device_ms_per_step']:.3f} ms a step; launches per step "
          f"{res['launches_per_step']}; logits vs the plain versions "
          f"{err:.3e} (tol {KERAS_LOGITS_TOL * scale:.3f})", flush=True)
    del model, est, gm, got, ref
    free_card(torch)
    res["kernels"] = kern = keras_gpt_kernels(torch, b, t, c["n_head"],
                                              c["hidden_size"] // c["n_head"])
    print(f"phase 19 (c) [{card}] K3 bf16 b={b} t={t} vs its plain "
          f"version: (out, lse) max abs err {kern['fwd_errors']}, at most "
          f"{kern['fwd_max_share_of_tol']:.3f} of the tolerance; K4a/K4b/K5: "
          f"max abs err (dq, dk, dv[, dbias]) {kern['bwd_errors']}, at most "
          f"{kern['bwd_max_share_of_tol']:.3f} of the tolerance", flush=True)
    return res


def keras_stacks(torch, seed: int, card: str) -> dict:
    """(d): test_keras_api.py's conv / BatchNorm / pool stack, its LSTM /
    GRU / Bidirectional stack and a ConvLSTM2D graph: each fits on the
    card, then its eval-mode output against the same weights on the CPU
    in f32, under deterministic algorithms."""
    from analytics_zoo_tpu_torch.keras import Sequential, optimizers
    from analytics_zoo_tpu_torch.keras import layers as L
    rng = np.random.default_rng(seed + 64)
    scenes = {
        "conv_bn_pool": (lambda: [
            L.Conv2D(8, 3, border_mode="same", activation="relu"),
            L.BatchNormalization(), L.MaxPooling2D(2),
            L.GlobalAveragePooling2D(), L.Dense(2)],
            rng.normal(size=(64, 8, 8, 3)).astype(np.float32)),
        "lstm_gru_bidirectional": (lambda: [
            L.LSTM(16, return_sequences=True),
            L.Bidirectional(L.GRU(8, return_sequences=True)),
            L.TimeDistributed(L.Dense(4)), L.GRU(8, activation="relu"),
            L.Dense(2)],
            rng.normal(size=(64, 12, 6)).astype(np.float32)),
        "convlstm2d": (lambda: [
            L.ConvLSTM2D(4, (3, 3), return_sequences=True),
            L.ConvLSTM2D(4, (3, 3)), L.GlobalAveragePooling2D(),
            L.Dense(2)],
            rng.normal(size=(32, 4, 8, 8, 2)).astype(np.float32)),
    }
    out = {}
    from analytics_zoo_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    with deterministic(torch):
        for name, (layers, x) in scenes.items():
            y = (x.reshape(len(x), -1).mean(1) > 0).astype(np.int32)
            stack = layers()
            model = Sequential(stack, device="cuda")
            model.compile(optimizer=optimizers.Adam(learning_rate=1e-2),
                          loss="sparse_categorical_crossentropy")
            model.fit(x, y, batch_size=32, nb_epoch=1, shuffle=False)
            est = model._ensure_estimator()
            loss = est.train_summary[-1]["loss"]
            check(np.isfinite(loss), f"phase 19 (d) {name}: loss {loss}")
            gm = est.get_model().eval()
            cpu = Sequential(stack, device="cpu").to_torch().build(x[:1])
            cpu.load_state_dict({k: v.cpu() for k, v in
                                 gm.state_dict().items()})
            with torch.no_grad():
                got = gm(torch.from_numpy(x).cuda()).cpu().numpy()
                want = cpu.eval()(torch.from_numpy(x)).numpy()
            err = float(np.abs(got - want).max())
            scale = max(1.0, float(np.abs(want).max()))
            check(err <= KERAS_STACK_TOL * scale,
                  f"phase 19 (d) {name}: card vs CPU {err} > "
                  f"{KERAS_STACK_TOL} x {scale}")
            out[name] = dict(loss=loss, max_abs_err=err,
                             tol=KERAS_STACK_TOL * scale,
                             steps=est.engine.host_step)
            del model, est, gm, cpu
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"phase 19 (d) launched a kernel of ours: {counts}")
    out["launches"] = counts
    print(f"phase 19 (d) [{card}] stacks fit on the card, eval outputs vs "
          f"the CPU in f32: " + ", ".join(
              f"{k} {v['max_abs_err']:.3e}" for k, v in out.items()
              if k != "launches"), flush=True)
    free_card(torch)
    return out


def phase_keras(torch, seed: int, card: str) -> dict:
    """Phase 19: the Keras-style API, scenes (a)-(d)."""
    t0 = time.perf_counter()
    out = dict(a=keras_ncf(torch, seed, card), b=keras_bert(torch, seed, card),
               c=keras_gpt(torch, seed, card), d=keras_stacks(torch, seed,
                                                              card))
    out["seconds"] = time.perf_counter() - t0
    print("keras " + json.dumps(dict(
        card=card, seconds=out["seconds"],
        ncf_toy={k: out["a"][k] for k in (
            "samples_per_s", "step_ms_p50", "peak_bytes_above_weights",
            "host_wall_ms_per_step", "step_profile", "epoch_losses")},
        bert={k: out["b"][k] for k in (
            "steps_per_s", "samples_per_s", "step_ms_p50",
            "peak_bytes_above_weights", "host_wall_ms_per_step",
            "step_profile", "launches_per_step", "logits_max_abs_err")},
        transformer_layer={k: out["c"][k] for k in (
            "steps_per_s", "tokens_per_s", "step_ms_p50",
            "peak_bytes_above_weights", "host_wall_ms_per_step",
            "step_profile", "launches_per_step", "logits_max_abs_err",
            "kernels")},
        stacks={k: v for k, v in out["d"].items() if k != "launches"})),
        flush=True)
    return out


# ----------------------------------------------------------------------
# phase 20: the model importers (pipeline/: ONNX through
# Estimator.from_onnx, a TF1 frozen graph through InferenceModel.load_tf,
# a caffemodel through Net.load_caffe), fixtures written here
# ----------------------------------------------------------------------

#: (a): BERT-base written as a static-shape ONNX graph
IMPORT_BERT_T = 128
IMPORT_GATE_ROWS = 4
IMPORT_FIT_BATCH, IMPORT_FIT_STEPS = 32, 5     # after one warm step
IMPORT_SERVE_BATCH, IMPORT_SERVE_BATCHES = 32, 20
#: (a): the imported forward on the card against the native model on
#: the CPU, f32 with TF32 off, of max(1, |CPU|): f32 sums in other
#: orders through 12 blocks
IMPORT_BERT_TOL = 2e-4
#: (b): TF-slim mobilenet_v1 (Howard et al. 2017) at 1.0 / 224, 1001
#: classes: (output channels, stride) of the 13 depthwise-separable
#: blocks after the 32-channel stride-2 stem
MOBILENET_V1 = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
                (1024, 2), (1024, 1))
MOBILENET_BATCH, MOBILENET_SIZE, MOBILENET_CLASSES = 64, 224, 1001
#: (c): bvlc_reference_caffenet's deploy widths (61M weights)
CAFFENET = dict(conv1=96, conv2=256, conv3=384, conv4=384, conv5=256,
                fc6=4096, fc7=4096, fc8=1000)
CAFFENET_BATCH, CAFFENET_SIZE = 64, 227
IMPORT_SERVE_REPS = 10
#: (b), (c): card against the CPU on two images, f32 with TF32 off, of
#: max(1, |CPU|): 28 (b) or 8 (c) conv / dense layers summed in other
#: orders by cuDNN and the CPU
IMPORT_IMAGE_TOL = 1e-3
IMPORT_SEED = 17


def pb_varint(v: int) -> bytes:
    """A protobuf varint, negative values as 64-bit two's complement."""
    from analytics_zoo_tpu_torch.utils.tf_example import _varint
    return _varint(v + (1 << 64) if v < 0 else v)


#: GraphDef DataType enums of the dtypes the writer emits
_GD_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.int32): 3}


def gd_tensor(arr) -> bytes:
    """TensorProto: dtype, shape, tensor_content."""
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim, _tag
    arr = np.ascontiguousarray(arr)
    shape = b"".join(_len_delim(2, _tag(1, 0) + pb_varint(int(d)))
                     for d in arr.shape)
    return b"".join([_tag(1, 0) + pb_varint(_GD_DTYPES[arr.dtype]),
                     _len_delim(2, shape), _len_delim(4, arr.tobytes())])


def gd_attr(kind: str, value) -> bytes:
    """AttrValue of `kind` "s", "i", "f", "b", "type", "ints" or
    "tensor"."""
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim, _tag
    if kind == "s":
        return _len_delim(2, value.encode())
    if kind == "i":
        return _tag(3, 0) + pb_varint(value)
    if kind == "f":
        return _tag(4, 5) + np.float32(value).tobytes()
    if kind == "b":
        return _tag(5, 0) + pb_varint(int(value))
    if kind == "type":
        return _tag(6, 0) + pb_varint(value)
    if kind == "ints":
        return _len_delim(1, b"".join(_tag(3, 0) + pb_varint(v)
                                      for v in value))
    return _len_delim(8, gd_tensor(value))


def gd_node(name: str, op: str, inputs=(), attrs=None) -> bytes:
    """NodeDef; `attrs` maps a key to (kind, value) for `gd_attr`."""
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim
    out = [_len_delim(1, name.encode()), _len_delim(2, op.encode())]
    out += [_len_delim(3, i.encode()) for i in inputs]
    for key, (kind, value) in (attrs or {}).items():
        out.append(_len_delim(5, _len_delim(1, key.encode())
                              + _len_delim(2, gd_attr(kind, value))))
    return b"".join(out)


def mobilenet_v1_graphdef(rng, width: float = 1.0, size: int = 224,
                          classes: int = 1001) -> bytes:
    """A frozen TF1 GraphDef of TF-slim's mobilenet_v1 at `width` and
    `size`, seeded weights: Conv2D / DepthwiseConv2dNative (SAME, the
    stride-2 ones with TF's asymmetric padding), FusedBatchNormV3,
    Relu6, AvgPool, Squeeze, MatMul + BiasAdd to the logits, Softmax.
    Input "input" [b, size, size, 3] NHWC; outputs "logits" and
    "predictions"."""
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim
    f32 = ("type", 1)
    nodes = [gd_node("input", "Placeholder", attrs={"dtype": f32})]

    def const(name, arr):
        nodes.append(gd_node(name, "Const", attrs={
            "value": ("tensor", np.asarray(arr, np.float32)), "dtype": f32}))
        return name

    def conv_bn(prefix, x, shape, op, stride):
        fan_in = shape[0] * shape[1] * (1 if op.startswith("Depth")
                                        else shape[2])
        w = const(f"{prefix}/weights", rng.standard_normal(
            shape, dtype=np.float32) * np.float32(np.sqrt(2.0 / fan_in)))
        c = shape[2] * shape[3] if op.startswith("Depth") else shape[3]
        conv = f"{prefix}/{op}"
        nodes.append(gd_node(conv, op, [x, w], {
            "strides": ("ints", [1, stride, stride, 1]),
            "padding": ("s", "SAME"), "data_format": ("s", "NHWC"),
            "T": f32}))
        bn = [const(f"{prefix}/BatchNorm/{n}", v) for n, v in (
            ("gamma", 1 + 0.1 * rng.standard_normal(c)),
            ("beta", 0.1 * rng.standard_normal(c)),
            ("moving_mean", 0.1 * rng.standard_normal(c)),
            ("moving_variance", 1 + 0.1 * np.abs(rng.standard_normal(c))))]
        nodes.append(gd_node(f"{prefix}/BatchNorm/FusedBatchNormV3",
                             "FusedBatchNormV3", [conv] + bn, {
                                 "epsilon": ("f", 1e-3),
                                 "is_training": ("b", False), "T": f32}))
        nodes.append(gd_node(f"{prefix}/Relu6", "Relu6",
                             [f"{prefix}/BatchNorm/FusedBatchNormV3"]))
        return f"{prefix}/Relu6"

    def ch(c):
        return max(8, int(c * width))

    x = conv_bn("MobilenetV1/Conv2d_0", "input", (3, 3, 3, ch(32)),
                "Conv2D", 2)
    cin = ch(32)
    for i, (c, s) in enumerate(MOBILENET_V1, 1):
        x = conv_bn(f"MobilenetV1/Conv2d_{i}_depthwise", x, (3, 3, cin, 1),
                    "DepthwiseConv2dNative", s)
        x = conv_bn(f"MobilenetV1/Conv2d_{i}_pointwise", x,
                    (1, 1, cin, ch(c)), "Conv2D", 1)
        cin = ch(c)
    k = size // 32
    nodes.append(gd_node("MobilenetV1/Logits/AvgPool", "AvgPool", [x], {
        "ksize": ("ints", [1, k, k, 1]), "strides": ("ints", [1, 2, 2, 1]),
        "padding": ("s", "VALID"), "T": f32}))
    nodes.append(gd_node("MobilenetV1/Logits/Squeeze", "Squeeze",
                         ["MobilenetV1/Logits/AvgPool"],
                         {"squeeze_dims": ("ints", [1, 2])}))
    w = const("MobilenetV1/Logits/weights", rng.standard_normal(
        (cin, classes), dtype=np.float32) * np.float32(np.sqrt(1.0 / cin)))
    b = const("MobilenetV1/Logits/biases",
              0.01 * rng.standard_normal(classes))
    nodes.append(gd_node("MobilenetV1/Logits/MatMul", "MatMul",
                         ["MobilenetV1/Logits/Squeeze", w]))
    nodes.append(gd_node("logits", "BiasAdd",
                         ["MobilenetV1/Logits/MatMul", b]))
    nodes.append(gd_node("predictions", "Softmax", ["logits"]))
    return b"".join(_len_delim(1, n) for n in nodes)


def caffe_params(field: int, fields: dict) -> bytes:
    """A layer's *Parameter submessage: floats as fixed32, ints as
    varints, lists as repeated varints."""
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim, _tag
    out = []
    for fnum, v in fields.items():
        if isinstance(v, float):
            out.append(_tag(fnum, 5) + np.float32(v).tobytes())
        elif isinstance(v, (list, tuple)):
            out += [_tag(fnum, 0) + pb_varint(int(x)) for x in v]
        else:
            out.append(_tag(fnum, 0) + pb_varint(int(v)))
    return _len_delim(field, b"".join(out))


def caffe_blob(arr) -> bytes:
    """BlobProto: shape (packed dims) and data as packed f32."""
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim, _tag
    arr = np.ascontiguousarray(arr, np.float32)
    dims = b"".join(pb_varint(int(d)) for d in arr.shape)
    return b"".join([_len_delim(7, _len_delim(1, dims)),
                     _tag(5, 2) + pb_varint(arr.nbytes), arr.tobytes()])


def caffe_layer(name: str, typ: str, bottoms, tops, blobs=(),
                params: bytes = b"") -> bytes:
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim
    out = [_len_delim(1, name.encode()), _len_delim(2, typ.encode())]
    out += [_len_delim(3, b.encode()) for b in bottoms]
    out += [_len_delim(4, t.encode()) for t in tops]
    out += [_len_delim(7, caffe_blob(b)) for b in blobs]
    out.append(params)
    return _len_delim(100, b"".join(out))


def caffenet_model(rng, widths=CAFFENET, size: int = 227) -> bytes:
    """A caffemodel (NetParameter, modern layers) of
    bvlc_reference_caffenet's deploy net at `widths` and `size`, seeded
    weights written packed: conv1 11 x 11 / 4, ceil-mode max pools 3 / 2,
    LRN 5 (1e-4, 0.75), conv2 5 x 5 in group 2, conv3-5 3 x 3 (conv4 and
    conv5 in group 2), fc6, fc7, fc8, Softmax "prob".  Input "data"
    [b, 3, size, size]."""
    from analytics_zoo_tpu_torch.utils.tf_example import _len_delim
    layers = []

    def conv(name, bottom, cin, cout, k, stride=1, pad=0, group=1):
        w = rng.standard_normal((cout, cin // group, k, k),
                                dtype=np.float32)
        w *= np.float32(np.sqrt(2.0 / (cin // group * k * k)))
        b = np.full(cout, 0.01, np.float32)
        layers.append(caffe_layer(name, "Convolution", [bottom], [name],
                                  [w, b], caffe_params(106, {
                                      1: cout, 4: [k], 6: [stride],
                                      3: [pad], 5: group})))
        layers.append(caffe_layer(f"relu{name[-1]}", "ReLU", [name], [name]))

    def pool(name, bottom, h):
        layers.append(caffe_layer(name, "Pooling", [bottom], [name], [],
                                  caffe_params(121, {1: 0, 2: 3, 3: 2})))
        return int(np.ceil((h - 3) / 2)) + 1

    def lrn(name, bottom):
        layers.append(caffe_layer(name, "LRN", [bottom], [name], [],
                                  caffe_params(118, {1: 5, 2: 1e-4,
                                                     3: 0.75})))

    def fc(name, bottom, cin, cout, relu=True):
        w = rng.standard_normal((cout, cin), dtype=np.float32)
        w *= np.float32(np.sqrt(2.0 / cin))
        b = np.full(cout, 0.01, np.float32)
        layers.append(caffe_layer(name, "InnerProduct", [bottom], [name],
                                  [w, b], caffe_params(117, {1: cout})))
        if relu:
            n = name[-1]
            layers.append(caffe_layer(f"relu{n}", "ReLU", [name], [name]))
            layers.append(caffe_layer(f"drop{n}", "Dropout", [name], [name]))

    c = widths
    conv("conv1", "data", 3, c["conv1"], 11, stride=4)
    h = pool("pool1", "conv1", (size - 11) // 4 + 1)
    lrn("norm1", "pool1")
    conv("conv2", "norm1", c["conv1"], c["conv2"], 5, pad=2, group=2)
    h = pool("pool2", "conv2", h)
    lrn("norm2", "pool2")
    conv("conv3", "norm2", c["conv2"], c["conv3"], 3, pad=1)
    conv("conv4", "conv3", c["conv3"], c["conv4"], 3, pad=1, group=2)
    conv("conv5", "conv4", c["conv4"], c["conv5"], 3, pad=1, group=2)
    h = pool("pool5", "conv5", h)
    fc("fc6", "pool5", c["conv5"] * h * h, c["fc6"])
    fc("fc7", "fc6", c["fc6"], c["fc7"])
    fc("fc8", "fc7", c["fc7"], c["fc8"], relu=False)
    layers.append(caffe_layer("prob", "Softmax", ["fc8"], ["prob"]))
    dims = b"".join(pb_varint(d) for d in (1, 3, size, size))
    head = [_len_delim(1, b"CaffeNet"), _len_delim(3, b"data"),
            _len_delim(8, _len_delim(1, dims))]
    return b"".join(head + layers)


def bert_onnx(sd: dict, n_head: int, t: int) -> bytes:
    """A BERTClassifier's state_dict (numpy) as an ONNX graph the way a
    static-shape exporter writes it, every Reshape target a constant
    (0 = copy the input's dim): Gather embeddings; LayerNorm as
    ReduceMean / Sub / Pow / Add / Sqrt / Div / Mul / Add; MatMul + Add
    dense layers; Reshape / Transpose heads; MatMul / Div / Add-mask /
    Softmax / MatMul attention; tanh-GELU from Pow / Mul / Add / Tanh;
    the tanh pooler over the first token and the classifier.  Inputs
    input_ids, segment_ids, attention_mask [b, t] (int32); output
    logits."""
    from analytics_zoo_tpu_torch.pipeline.onnx.onnx_proto import (
        encode_model)
    hid = sd["bert.token_embed.weight"].shape[1]
    dh = hid // n_head
    n_block = len({k.split(".")[2] for k in sd
                   if k.startswith("bert.blocks.")})
    inits = {"pos_ids": np.arange(t, dtype=np.int64),
             "first": np.zeros(1, np.int64),
             "eps": np.array(1e-6, np.float32),
             "two": np.array(2.0, np.float32),
             "three": np.array(3.0, np.float32),
             "half": np.array(0.5, np.float32),
             "one": np.array(1.0, np.float32),
             "gelu_c": np.array(np.sqrt(2.0 / np.pi), np.float32),
             "gelu_k": np.array(0.044715, np.float32),
             "neg_big": np.array(-1e9, np.float32),
             "sqrt_dh": np.array(np.sqrt(dh), np.float32),
             "heads": np.array([0, 0, n_head, dh], np.int64),
             "merge": np.array([0, 0, hid], np.int64),
             "mask_axes": np.array([1, 2], np.int64)}
    nodes = []
    counter = [0]

    def op(kind, ins, attrs=None, n_out=1):
        counter[0] += 1
        outs = [f"{kind.lower()}_{counter[0]}_{i}" for i in range(n_out)]
        nodes.append((kind, list(ins), outs) + ((attrs,) if attrs else ()))
        return outs if n_out > 1 else outs[0]

    def w(name, arr):
        inits[name] = np.ascontiguousarray(arr, np.float32)
        return name

    def dense(x, prefix):
        y = op("MatMul", [x, w(prefix + ".weight", sd[prefix + ".weight"].T)])
        return op("Add", [y, w(prefix + ".bias", sd[prefix + ".bias"])])

    def layer_norm(x, prefix):
        mean = op("ReduceMean", [x], {"axes": [-1]})
        d = op("Sub", [x, mean])
        var = op("ReduceMean", [op("Pow", [d, "two"])], {"axes": [-1]})
        n = op("Div", [d, op("Sqrt", [op("Add", [var, "eps"])])])
        y = op("Mul", [n, w(prefix + ".weight", sd[prefix + ".weight"])])
        return op("Add", [y, w(prefix + ".bias", sd[prefix + ".bias"])])

    def gelu(x):
        inner = op("Add", [x, op("Mul", ["gelu_k", op("Pow", [x, "three"])])])
        th = op("Tanh", [op("Mul", ["gelu_c", inner])])
        return op("Mul", ["half", op("Mul", [x, op("Add", ["one", th])])])

    e = "bert."
    x = op("Gather", [w(e + "token_embed.weight",
                        sd[e + "token_embed.weight"]), "input_ids"])
    x = op("Add", [x, op("Gather", [w(e + "position_embed.weight", sd[
        e + "position_embed.weight"]), "pos_ids"])])
    x = op("Add", [x, op("Gather", [w(e + "segment_embed.weight", sd[
        e + "segment_embed.weight"]), "segment_ids"])])
    x = layer_norm(x, e + "embed_ln")
    keep = op("Cast", ["attention_mask"], {"to": 1})
    bias = op("Unsqueeze", [op("Mul", [op("Sub", ["one", keep]), "neg_big"]),
                            "mask_axes"])
    for i in range(n_block):
        p = f"{e}blocks.{i}."
        q, k, v = op("Split", [dense(x, p + "attn.qkv")], {"axis": 2},
                     n_out=3)
        q = op("Transpose", [op("Reshape", [q, "heads"])],
               {"perm": [0, 2, 1, 3]})
        k = op("Transpose", [op("Reshape", [k, "heads"])],
               {"perm": [0, 2, 3, 1]})
        v = op("Transpose", [op("Reshape", [v, "heads"])],
               {"perm": [0, 2, 1, 3]})
        s = op("Add", [op("Div", [op("MatMul", [q, k]), "sqrt_dh"]), bias])
        ctx = op("MatMul", [op("Softmax", [s], {"axis": -1}), v])
        ctx = op("Reshape", [op("Transpose", [ctx], {"perm": [0, 2, 1, 3]}),
                             "merge"])
        x = layer_norm(op("Add", [x, dense(ctx, p + "attn.proj")]),
                       p + "ln1")
        f = dense(gelu(dense(x, p + "fc1")), p + "fc2")
        x = layer_norm(op("Add", [x, f]), p + "ln2")
    first = op("Flatten", [op("Gather", [x, "first"], {"axis": 1})])
    pooled = op("Tanh", [dense(first, e + "pooler")])
    logits = dense(pooled, "classifier")
    nodes.append(("Identity", [logits], ["logits"]))
    return encode_model(
        nodes=nodes, initializers=inits,
        inputs=[(n, [1, t]) for n in ("input_ids", "segment_ids",
                                       "attention_mask")],
        outputs=["logits"])


def import_bert_rows(rng, n: int, t: int, vocab: int, pad: bool = True):
    """input ids, segment ids and a key mask [n, t] (int32); with `pad`
    every other row ends early."""
    ids = rng.integers(1, vocab, (n, t)).astype(np.int32)
    seg = (np.arange(t)[None, :] >= t // 2).astype(np.int32).repeat(n, 0)
    mask = np.ones((n, t), np.int32)
    if pad:
        for r in range(0, n, 2):
            mask[r, t - 1 - (r * 13) % (t // 2):] = 0
    return ids, seg, mask


def timed_predicts(torch, fn, reps: int) -> float:
    """Seconds per call of `fn` over `reps` calls after a warm one,
    synchronized at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def image_gate(label: str, got, want) -> dict:
    """max abs err of each output (card against CPU), checked against
    IMPORT_IMAGE_TOL of max(1, |CPU|)."""
    out = {}
    for name, g, w_ in zip(("logits", "predictions"), got, want):
        err = float(np.abs(np.asarray(g) - np.asarray(w_)).max())
        scale = max(1.0, float(np.abs(w_).max()))
        check(np.isfinite(g).all() and err <= IMPORT_IMAGE_TOL * scale,
              f"{label}: {name} card vs CPU {err} > {IMPORT_IMAGE_TOL} x "
              f"{scale}")
        out[name] = err
    return out


def import_onnx_bert(torch, seed: int, card: str) -> dict:
    """(a): BERT-base as ONNX through Estimator.from_onnx: the logits
    against the native model on the CPU, 1 + 5 Adam steps at 32 x 128,
    then served through InferenceModel.load_module."""
    from analytics_zoo_tpu_torch.convert import bert_from_flax, init_bert_params
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
    cfg = dict(BERT_BASE, num_classes=2)
    t = IMPORT_BERT_T
    native = BERTClassifier(**cfg, compute_dtype=torch.float32,
                            attn_impl="einsum", device="cpu").eval()
    native.load_state_dict(bert_from_flax(init_bert_params(cfg, seed), cfg))
    sd = {k: v.numpy() for k, v in native.state_dict().items()}
    t0 = time.perf_counter()
    data = bert_onnx(sd, cfg["n_head"], t)
    encode_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + IMPORT_SEED)
    gate = import_bert_rows(rng, IMPORT_GATE_ROWS, t, cfg["vocab"])
    with torch.no_grad():
        want = native(*(torch.from_numpy(a) for a in gate)).numpy()
    del native
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = Estimator.from_onnx(data, loss="sparse_categorical_crossentropy",
                              optimizer="adam", learning_rate=2e-5,
                              seed=seed)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    onnx_bytes = len(data)
    del data
    gm = est.get_model()
    n_params = sum(p.numel() for p in gm.parameters())
    with torch.no_grad():
        got = gm(*(torch.from_numpy(a).cuda() for a in gate)).cpu().numpy()
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    check(np.isfinite(got).all() and err <= IMPORT_BERT_TOL * scale,
          f"phase 20 (a): imported logits vs the native model on the CPU "
          f"{err} > {IMPORT_BERT_TOL} x {scale}")
    from analytics_zoo_tpu_torch.ops import kernels
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"phase 20 (a): the import or the forward launched a kernel of "
          f"ours: {counts}")
    n = IMPORT_FIT_BATCH * (IMPORT_FIT_STEPS + 1)
    ids, seg, mask = import_bert_rows(rng, n, t, cfg["vocab"])
    y = rng.integers(0, 2, n).astype(np.int32)
    times, peak, host_s, counts, losses_ = keras_fit(
        torch, est, {"x": [ids, seg, mask], "y": y}, IMPORT_FIT_BATCH)
    check(est.engine.host_step == IMPORT_FIT_STEPS + 1
          and all(np.isfinite(losses_)),
          f"phase 20 (a): fit ran {est.engine.host_step} steps, losses "
          f"{losses_}")
    check(not any(counts.values()),
          f"phase 20 (a): the imported BERT launched a kernel of ours: "
          f"{counts}")
    step = statistics.median(times)
    b = IMPORT_FIT_BATCH
    prof = keras_step_profile(torch, est, (ids[:b], seg[:b], mask[:b]),
                              y[:b])
    im = InferenceModel(max_batch_size=IMPORT_SERVE_BATCH).load_module(gm)
    sb = IMPORT_SERVE_BATCH
    batches = [import_bert_rows(rng, sb, t, cfg["vocab"])
               for _ in range(IMPORT_SERVE_BATCHES)]
    served = im.predict(*batches[0])
    check(served.shape == (sb, 2) and np.isfinite(served).all(),
          f"phase 20 (a): served logits {served.shape}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bt in batches:
        im.predict(*bt)
    serve_s = time.perf_counter() - t0
    serve_busy = busy_share(torch, lambda: [im.predict(*bt)
                                            for bt in batches[:5]])
    serve_counts = kernels.launch_counts()
    check(not any(serve_counts.values()),
          f"phase 20 (a): the step profile or serving launched a kernel of "
          f"ours: {serve_counts}")
    out = dict(onnx_bytes=onnx_bytes, encode_s=encode_s, import_s=import_s,
               trainable_params=n_params, logits_max_abs_err=err,
               logits_tol=IMPORT_BERT_TOL * scale, batch=b, t=t,
               step_ms_p50=step * 1e3, steps_per_s=1.0 / step,
               samples_per_s=b / step, peak_bytes_above_weights=peak,
               host_wall_ms_per_step=host_s * 1e3, step_profile=prof,
               losses=losses_, served_sequences_per_s=sb
               * IMPORT_SERVE_BATCHES / serve_s,
               serve_busy=serve_busy, launches=counts)
    print(f"phase 20 (a) [{card}] BERT-base as ONNX ({onnx_bytes / 2**20:.1f}"
          f" MiB, {n_params:,} trainable) through Estimator.from_onnx: "
          f"import {import_s:.2f} s, logits vs the native CPU model "
          f"{err:.3e}; fit {b} x {t} Adam: step p50 {step * 1e3:.3f} ms, "
          f"{b / step:.1f} samples/s, peak {peak / 2**20:.1f} MiB above the "
          f"weights, host {prof['host_wall_ms_per_step']:.3f} ms vs card "
          f"{prof['device_ms_per_step']:.3f} ms a step; served "
          f"{out['served_sequences_per_s']:.1f} sequences/s at {sb} x {t}; "
          f"no kernel of ours launched", flush=True)
    del est, gm, im
    free_card(torch)
    return out


def import_tf_mobilenet(torch, seed: int, card: str) -> dict:
    """(b): a frozen TF1 MobileNet v1 1.0/224 served through
    InferenceModel.load_tf, held against the same TFNet on the CPU."""
    from analytics_zoo_tpu_torch.pipeline.tf_graph import load_tf_graph
    from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
    rng = np.random.default_rng(seed + IMPORT_SEED + 1)
    gd = mobilenet_v1_graphdef(rng, 1.0, MOBILENET_SIZE, MOBILENET_CLASSES)
    s = MOBILENET_SIZE
    x = rng.standard_normal((MOBILENET_BATCH, s, s, 3), dtype=np.float32)
    outputs = ["logits", "predictions"]
    t0 = time.perf_counter()
    card_net = load_tf_graph(gd, outputs=outputs)
    load_s = time.perf_counter() - t0
    gate = image_gate("phase 20 (b)", card_net.predict(x[:2]),
                      load_tf_graph(gd, outputs=outputs,
                                    device="cpu").predict(x[:2]))
    im = InferenceModel(max_batch_size=MOBILENET_BATCH).load_tf(gd)
    served = im.predict(x)
    check(served.shape == (MOBILENET_BATCH, MOBILENET_CLASSES)
          and np.allclose(served.sum(1), 1.0, atol=1e-4),
          "phase 20 (b): served rows are not softmax rows")
    per = timed_predicts(torch, lambda: im.predict(x), IMPORT_SERVE_REPS)
    busy = busy_share(torch, lambda: [im.predict(x) for _ in range(3)])
    out = dict(graphdef_bytes=len(gd), load_s=load_s, max_abs_err=gate,
               tol=IMPORT_IMAGE_TOL, batch=MOBILENET_BATCH,
               predict_ms=per * 1e3, images_per_s=MOBILENET_BATCH / per,
               serve_busy=busy)
    print(f"phase 20 (b) [{card}] TF1 MobileNet v1 1.0/224 "
          f"({len(gd) / 2**20:.1f} MiB GraphDef) through "
          f"InferenceModel.load_tf at {MOBILENET_BATCH} x {s}^2 NHWC: "
          f"{out['images_per_s']:.1f} images/s, predict {per * 1e3:.3f} ms,"
          f" busy share {busy['device_busy_share']:.3f}; card vs CPU "
          f"{gate}", flush=True)
    del card_net, im
    free_card(torch)
    return out


def import_caffenet(torch, seed: int, card: str) -> dict:
    """(c): BVLC CaffeNet's deploy net as a caffemodel through
    Net.load_caffe, held against the CPU."""
    from analytics_zoo_tpu_torch.pipeline.caffe_graph import parse_caffemodel
    from analytics_zoo_tpu_torch.pipeline.net import Net
    rng = np.random.default_rng(seed + IMPORT_SEED + 2)
    data = caffenet_model(rng, CAFFENET, CAFFENET_SIZE)
    t0 = time.perf_counter()
    desc = parse_caffemodel(data)
    decode_s = time.perf_counter() - t0
    n_weights = sum(b.size for ly in desc["layers"] for b in ly["blobs"])
    del desc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = Net.load_caffe(None, data, outputs=["fc8", "prob"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    s = CAFFENET_SIZE
    x = rng.standard_normal((CAFFENET_BATCH, 3, s, s), dtype=np.float32)
    gate = image_gate("phase 20 (c)", net.predict(x[:2]),
                      Net.load_caffe(None, data, outputs=["fc8", "prob"],
                                     device="cpu").predict(x[:2]))
    served = net.predict(x)[1]
    check(served.shape == (CAFFENET_BATCH, CAFFENET["fc8"])
          and np.allclose(served.sum(1), 1.0, atol=1e-4),
          "phase 20 (c): predictions are not softmax rows")
    per = timed_predicts(torch, lambda: net.predict(x), IMPORT_SERVE_REPS)
    busy = busy_share(torch, lambda: [net.predict(x) for _ in range(3)])
    out = dict(caffemodel_bytes=len(data), weights=n_weights,
               decode_s=decode_s, load_s=load_s, max_abs_err=gate,
               tol=IMPORT_IMAGE_TOL, batch=CAFFENET_BATCH,
               predict_ms=per * 1e3, images_per_s=CAFFENET_BATCH / per,
               serve_busy=busy)
    print(f"phase 20 (c) [{card}] BVLC CaffeNet ({n_weights:,} weights, "
          f"{len(data) / 2**20:.1f} MiB) through Net.load_caffe: decode "
          f"{decode_s:.3f} s, load {load_s:.3f} s; {CAFFENET_BATCH} x 3 x "
          f"{s}^2: {out['images_per_s']:.1f} images/s, predict "
          f"{per * 1e3:.3f} ms, busy share {busy['device_busy_share']:.3f}; "
          f"card vs CPU {gate}", flush=True)
    del net, data
    free_card(torch)
    return out


def phase_importers(torch, seed: int, card: str) -> dict:
    """Phase 20: the model importers, parts (a)-(c); no kernel of ours
    is launched in any of them (checked before (a)'s fit, whose timing
    resets the counts, and from there to the end of (c))."""
    from analytics_zoo_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    out = dict(a=import_onnx_bert(torch, seed, card),
               b=import_tf_mobilenet(torch, seed, card),
               c=import_caffenet(torch, seed, card))
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"phase 20 launched a kernel of ours: {counts}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    print("importers " + json.dumps(dict(
        card=card, seconds=out["seconds"],
        onnx_bert={k: out["a"][k] for k in (
            "import_s", "logits_max_abs_err", "steps_per_s",
            "samples_per_s", "step_ms_p50", "peak_bytes_above_weights",
            "host_wall_ms_per_step", "step_profile",
            "served_sequences_per_s", "serve_busy")},
        tf_mobilenet_v1={k: out["b"][k] for k in (
            "load_s", "max_abs_err", "images_per_s", "predict_ms",
            "serve_busy")},
        caffenet={k: out["c"][k] for k in (
            "decode_s", "load_s", "max_abs_err", "images_per_s",
            "predict_ms", "serve_busy")})), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 21: Chronos AutoTS (BASELINE config #4's path)
# ---------------------------------------------------------------------------

#: half-hourly points of NAB's nyc_taxi.csv, the series config #4 fits
TAXI_POINTS = 10_320
#: a day and a week of half hours: the series' two seasons
TAXI_DAY, TAXI_WEEK = 48, 336
CHRONOS_LOOKBACK, CHRONOS_HORIZON = 24, 1
CHRONOS_BATCH = 64
CHRONOS_EPOCHS = 2
#: the widest widths of AutoTSEstimator's default search spaces
CHRONOS_WIDEST = {
    "tcn": dict(num_channels=[48, 48, 48], kernel_size=3),
    "lstm": dict(hidden_dim=64, layer_num=2),
    "seq2seq": dict(lstm_hidden_dim=64, lstm_layer_num=2),
}
#: card predictions against the port on the CPU: |d| <= tol * max(1, |CPU|)
CHRONOS_PRED_TOL = 1e-5
#: the first step's loss: |d| <= tol * max(1, |CPU|)
CHRONOS_LOSS_TOL = 1e-5
#: the first step's gradients: |d| <= tol * max |CPU| of each tensor
CHRONOS_GRAD_TOL = 1e-4
#: windows the CPU search of (c) fits (its configs do not depend on them)
CHRONOS_CPU_WINDOWS = 1024
CHRONOS_SEARCH = dict(n_sampling=4, epochs=2, batch_size=64)


def taxi_series(seed: int, n: int = TAXI_POINTS) -> np.ndarray:
    """A series of nyc-taxi's length and shape: a daily and a weekly
    season and noise around a level, standardized with numpy."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    v = (15000.0 + 6500.0 * np.sin(2 * np.pi * t / TAXI_DAY - 2.0)
         + 2500.0 * np.sin(2 * np.pi * t / TAXI_WEEK)
         + rng.normal(0.0, 900.0, n))
    return ((v - v.mean()) / v.std()).astype(np.float32)


def roll_series(series: np.ndarray, lookback: int, horizon: int):
    """(x [n, lookback, 1], y [n, horizon, 1]) windows, as
    TSDataset.roll makes them (which needs pandas)."""
    n = len(series) - lookback - horizon + 1
    idx = np.arange(lookback)[None] + np.arange(n)[:, None]
    y_idx = lookback + np.arange(n)[:, None] + np.arange(horizon)[None]
    return series[idx][..., None], series[y_idx][..., None]


def chronos_context(torch) -> dict:
    """(a): the runtime entry points on the card."""
    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.common.context import OrcaContextMeta
    zoo.stop_orca_context()
    try:
        zoo.init_orca_context(cluster_mode="yarn")
        check(False, "init_orca_context('yarn') did not raise")
    except ValueError:
        pass
    dev = zoo.init_orca_context(cluster_mode="local")
    check(dev == torch.device("cuda"), f"init_orca_context gave {dev}")
    check(zoo.init_orca_context(cluster_mode="local") is dev,
          "a second init_orca_context gave another device")
    check(zoo.OrcaContext.initialized and zoo.OrcaContext.num_devices == 1,
          "OrcaContext does not read the runtime")
    try:
        zoo.init_orca_context(cluster_mode="tpu_pod")
        check(False, "another mode did not raise while initialized")
    except RuntimeError:
        pass
    zoo.stop_orca_context()
    check(not zoo.OrcaContext.initialized, "stop_orca_context kept it")
    implicit = zoo.OrcaContext.device
    check(implicit.type == "cuda" and OrcaContextMeta._auto_initialized,
          "reading OrcaContext.device did not start local mode")
    zoo.init_orca_context(cluster_mode="local")
    check(not OrcaContextMeta._auto_initialized,
          "an explicit init_orca_context kept the implicit start")
    return dict(device=str(dev), num_devices=zoo.OrcaContext.num_devices)


def chronos_forecaster(name: str, device, seed: int, **kw):
    from analytics_zoo_tpu_torch.chronos import forecaster
    cls = {"tcn": forecaster.TCNForecaster,
           "lstm": forecaster.LSTMForecaster,
           "seq2seq": forecaster.Seq2SeqForecaster}[name]
    return cls(past_seq_len=CHRONOS_LOOKBACK,
               future_seq_len=CHRONOS_HORIZON, input_feature_num=1,
               output_feature_num=1, seed=seed, device=device,
               **CHRONOS_WIDEST[name], **kw)


def chronos_first_step(torch, card_fc, cpu_fc, x, y, zero=()) -> dict:
    """One train step of each forecaster's engine on the same batch:
    the losses and every gradient, card against CPU.  The tensors named
    in `zero` have an exact gradient of 0 (both sides rounding noise):
    each side is held within the tolerance of the largest gradient of
    the model instead."""
    host = {"features": (x,), "labels": (y,),
            "mask": np.ones(len(x), np.float32)}
    out = {}
    for side, fc in (("card", card_fc), ("cpu", cpu_fc)):
        eng = fc._estimator().engine
        stats = eng.train_step(eng.put_batch(host))
        out[side] = (float(stats["loss"]), {
            k: p.grad.detach().cpu().numpy()
            for k, p in fc._estimator().get_model().named_parameters()})
    (loss, grads), (ref_loss, ref_grads) = out["card"], out["cpu"]
    loss_err = abs(loss - ref_loss) / max(1.0, abs(ref_loss))
    check(loss_err <= CHRONOS_LOSS_TOL,
          f"first-step loss {loss} against the CPU's {ref_loss}")
    worst = 0.0
    top = max(float(np.abs(g).max()) for g in ref_grads.values())
    for k in zero:
        noise = max(float(np.abs(grads[k]).max()),
                    float(np.abs(ref_grads.pop(k)).max()))
        check(noise <= CHRONOS_GRAD_TOL * top,
              f"first-step gradient of {k} (exactly 0): {noise:.3g}")
    for k, g in ref_grads.items():
        err = float(np.abs(grads[k] - g).max())
        rel = err / max(float(np.abs(g).max()), 1e-30) if err else 0.0
        check(rel <= CHRONOS_GRAD_TOL,
              f"first-step gradient of {k}: {rel:.3g} of its largest")
        worst = max(worst, rel)
    return dict(loss=loss, cpu_loss=ref_loss, loss_rel_err=loss_err,
                grad_max_rel_err=worst)


def marked_steps(torch, eng, run) -> list:
    """`run()` with a CUDA event recorded as each of `eng`'s train steps
    is queued: each step's period in ms (the time from one step's
    queueing to the next's, with no host wait), the first left out, the
    last to the end of `run`."""
    marks = []

    def marked_step(b, step=eng.train_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(b)

    eng.train_step = marked_step
    torch.cuda.synchronize()
    try:
        run()
    finally:
        del eng.train_step
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks[1:], marks[2:])]


def chronos_fit(torch, fc, x, y, epochs: int) -> dict:
    """`fc.fit` with each step's period (`marked_steps`): per-epoch
    losses and walls, steps, step p50, samples/s of the last epoch."""
    est = fc._estimator()
    periods = marked_steps(torch, est.engine, lambda: fc.fit(
        (x, y), epochs=epochs, batch_size=CHRONOS_BATCH))
    summary = est.train_summary[-epochs:]
    return dict(epoch_losses=[s["loss"] for s in summary],
                epoch_wall_s=[s["wall_s"] for s in summary],
                steps=len(periods) + 1,
                step_ms_p50=statistics.median(periods),
                samples_per_s=len(x) / summary[-1]["wall_s"])


def chronos_forecasters(torch, seed: int, x, y) -> dict:
    """(b): each forecaster at the widest widths of AutoTS's default
    space, f32: predictions and the first step against the port on the
    CPU from the same weights (dropout 0), then a fit of
    `CHRONOS_EPOCHS` epochs (dropout 0.1 where the model has it), its
    step profile and busy share, and save -> load."""
    import os
    import tempfile
    out = {}
    batch = slice(0, CHRONOS_BATCH)
    for name in CHRONOS_WIDEST:
        t0 = time.perf_counter()
        no_drop = {} if name == "seq2seq" else {"dropout": 0.0}
        card = chronos_forecaster(name, None, seed, **no_drop)
        cpu = chronos_forecaster(name, "cpu", seed, **no_drop)
        cpu._estimator().set_params({
            k: v.detach().cpu()
            for k, v in card._estimator().get_model().state_dict().items()})
        got = card.predict((x, None), batch_size=1024)
        want = cpu.predict((x, None), batch_size=1024)
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        check(got.shape == (len(x), CHRONOS_HORIZON, 1)
              and np.isfinite(got).all(), f"{name} predictions {got.shape}")
        check(float(err.max()) <= CHRONOS_PRED_TOL,
              f"{name} predictions {float(err.max()):.3g} off the CPU's")
        r = dict(predict_max_rel_err=float(err.max()),
                 first_step=chronos_first_step(torch, card, cpu, x[batch],
                                               y[batch]))
        del card, cpu
        drop = {} if name == "seq2seq" else {"dropout": 0.1}
        fc = chronos_forecaster(name, None, seed, **drop)
        r["fit"] = chronos_fit(torch, fc, x, y, CHRONOS_EPOCHS)
        losses = r["fit"]["epoch_losses"]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{name} loss did not fall over {CHRONOS_EPOCHS} epochs: "
              f"{losses}")
        r["step_profile"] = keras_step_profile(
            torch, fc._estimator(), (x[batch],), y[batch])
        r["epoch_busy"] = busy_share(torch, lambda: fc.fit(
            (x, y), epochs=1, batch_size=CHRONOS_BATCH))
        path = os.path.join(tempfile.mkdtemp(), f"{name}.pkl")
        with deterministic(torch):
            before = fc.predict((x, None), batch_size=1024)
            fc.save(path)
            after = type(fc).load(path).predict((x, None), batch_size=1024)
        check(np.array_equal(before, after),
              f"{name} save -> load does not predict bitwise")
        os.remove(path)
        r["params"] = sum(
            p.numel() for p in fc._estimator().get_model().parameters())
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
    return out


def chronos_autots(torch, seed: int, x, y) -> dict:
    """(c): AutoTSEstimator(model="lstm") with the default space on the
    card (80% of the windows to fit, the rest to validate); the same
    search with the port on the CPU samples the same configs."""
    import os
    import tempfile
    from analytics_zoo_tpu_torch.chronos.autots import (
        AutoTSEstimator,
        TSPipeline,
    )
    cut = int(0.8 * len(x))
    train, val = (x[:cut], y[:cut]), (x[cut:], y[cut:])
    auto = AutoTSEstimator(model="lstm", past_seq_len=CHRONOS_LOOKBACK,
                           future_seq_len=CHRONOS_HORIZON)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = auto.fit(train, validation_data=val, **CHRONOS_SEARCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    small = (x[:CHRONOS_CPU_WINDOWS], y[:CHRONOS_CPU_WINDOWS])
    cpu = AutoTSEstimator(model="lstm", past_seq_len=CHRONOS_LOOKBACK,
                          future_seq_len=CHRONOS_HORIZON, device="cpu")
    cpu.fit(small, **CHRONOS_SEARCH)
    configs = [r["config"] for r in auto._trials]
    check(configs == [r["config"] for r in cpu._trials],
          "the card's trial configs differ from the CPU search's")
    check(isinstance(pipe, TSPipeline)
          and pipe.forecaster is auto._best.state
          and pipe.forecaster.device.type == "cuda",
          "AutoTSEstimator did not return the best forecaster's pipeline")
    finishers = [r["metric"] for r in auto._trials if not r["stopped"]]
    check(auto._best.best_metric == min(finishers),
          "the pipeline's forecaster is not the best finisher")
    with deterministic(torch):
        preds = pipe.predict(val)
        check(np.array_equal(preds, pipe.forecaster.predict(val)),
              "the pipeline does not predict as its forecaster")
        d = tempfile.mkdtemp()
        pipe.save(d)
        again = TSPipeline.load(d).predict(val)
    check(np.array_equal(preds, again),
          "TSPipeline save -> load does not predict bitwise")
    for f in os.listdir(d):
        os.remove(os.path.join(d, f))
    os.rmdir(d)
    trial_epochs = sum(r["epochs"] for r in auto._trials)
    return dict(trials=auto._trials, best_config=auto.get_best_config(),
                search_wall_s=wall, trial_epochs=trial_epochs,
                wall_s_per_trial_epoch=wall / trial_epochs,
                val_mse=float(((preds - val[1]) ** 2).mean()),
                val_var=float(np.var(val[1])))


def chronos_mlp(torch, width: int, device):
    """x [b, 4] -> [b]: JAX's test MLP (Dense(width), relu, Dense(1))."""
    return torch.nn.Sequential(
        torch.nn.Linear(4, width, device=device), torch.nn.ReLU(),
        torch.nn.Linear(width, 1, device=device), torch.nn.Flatten(0))


@lru_cache(maxsize=None)
def export_kept_estimator():
    """An `Estimator` subclass that keeps a copy of what `set_params`
    was given: the process backend's export of the best trial, which
    the parent hands to the rebuilt Estimator."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    class ExportKept(Estimator):
        exported = None

        def set_params(self, params):
            self.exported = {k: v.clone() for k, v in params.items()}
            return super().set_params(params)
    return ExportKept


def chronos_mlp_creator(config):
    """An `Estimator.from_torch` of a small MLP, its weights drawn from
    the config's seed.  A process-backend worker sees no card and
    builds it on the CPU; this process (the parent, rebuilding the best
    trial) builds it on the card.  A worker writes what it sees of CUDA
    into `config["report_dir"]`."""
    import multiprocessing
    import os
    import torch
    worker = multiprocessing.parent_process() is not None
    if worker:
        with open(os.path.join(config["report_dir"], f"{os.getpid()}"),
                  "a") as f:
            f.write(json.dumps(dict(
                cuda_available=torch.cuda.is_available(),
                cuda_initialized=torch.cuda.is_initialized(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"))) + "\n")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(config["seed"]))
        model = chronos_mlp(torch, int(config["width"]),
                            "cpu" if worker else "cuda")
    return export_kept_estimator().from_torch(
        model, loss="mse", optimizer="adam",
        learning_rate=float(config["lr"]))


def _mlp_data(seed: int):
    """JAX's test_device_backend_real_estimator_trials data."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    w = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    return x, (x @ w + 0.01 * rng.normal(size=128)).astype(np.float32)


def chronos_device_backend(torch, seed: int) -> dict:
    """(d): SearchEngine(backend="device") with 4 real
    `Estimator.from_torch` trials on the card, each call through the
    device lease."""
    from analytics_zoo_tpu_torch.common import device_lease as lease
    from analytics_zoo_tpu_torch.orca.automl import hp
    from analytics_zoo_tpu_torch.orca.automl.search_engine import (
        SearchEngine,
    )
    x, y = _mlp_data(seed)
    walls = []

    def trainable(config, state, add_epochs):
        t0 = time.perf_counter()
        state = state or chronos_mlp_creator(config)
        state.fit({"x": x, "y": y}, epochs=add_epochs, batch_size=32)
        mse = state.evaluate({"x": x, "y": y}, batch_size=64)["loss"]
        walls.append(time.perf_counter() - t0)
        return state, float(mse)

    before = lease.stats()
    engine = SearchEngine(trainable, {
        "width": hp.grid_search([4, 8, 16, 32]), "lr": hp.choice([1e-2]),
        "seed": seed, "report_dir": None}, epochs=4, grace_epochs=1,
        backend="device")
    best = engine.run()
    after = lease.stats()
    got = after["acquisitions"] - before["acquisitions"]
    check(got == len(walls), f"{got} lease acquisitions for "
          f"{len(walls)} trial calls")
    check(lease.current_holder() is None, "the lease is still held")
    check(best.best_metric < 0.7 * float(np.var(y)),
          f"the best trial's mse {best.best_metric} did not train")
    check(best.state.get_model()[0].weight.device.type == "cuda",
          "a device trial did not run on the card")
    return dict(trial_calls=len(walls), best_mse=best.best_metric,
                var_y=float(np.var(y)),
                trial_wall_ms_p50=1e3 * statistics.median(walls),
                lease_wait_ms_mean=1e3 * (after["total_wait_s"]
                                          - before["total_wait_s"]) / got,
                lease_hold_ms_mean=1e3 * (after["total_hold_s"]
                                          - before["total_hold_s"]) / got)


def chronos_process_backend(torch, seed: int) -> dict:
    """(e): AutoEstimator.from_torch over 2 spawned workers: no worker
    initializes CUDA, and the best model, rebuilt here, lands on the
    card and predicts as the worker's export does on the CPU."""
    import os
    import shutil
    import tempfile
    from analytics_zoo_tpu_torch.orca.automl import AutoEstimator, hp
    x, y = _mlp_data(seed)
    report = tempfile.mkdtemp()
    auto = AutoEstimator.from_torch(chronos_mlp_creator, metric="loss")
    t0 = time.perf_counter()
    auto.fit({"x": x, "y": y}, search_space={
        "width": hp.grid_search([8, 16]), "lr": hp.choice([1e-2]),
        "seed": seed, "report_dir": report}, epochs=2, batch_size=32,
        parallelism=2, backend="process")
    wall = time.perf_counter() - t0
    seen = []
    for f in sorted(os.listdir(report)):
        with open(os.path.join(report, f)) as fh:
            seen += [json.loads(line) for line in fh]
    workers = len(os.listdir(report))
    shutil.rmtree(report)
    check(workers == 2 and seen and not any(
        s["cuda_available"] or s["cuda_initialized"] for s in seen)
        and all(s["visible"] == "" for s in seen),
        f"the process-backend workers saw the card: {seen}")
    best = auto.get_best_model()
    model = best.get_model()
    check(all(p.device.type == "cuda" for p in model.parameters()),
          "the rebuilt best model is not on the card")
    cpu = chronos_mlp(torch, int(auto.get_best_config()["width"]), "cpu")
    cpu.load_state_dict(best.exported)
    for k, v in model.state_dict().items():
        check(torch.equal(v.cpu(), best.exported[k]),
              f"the rebuilt {k} is not the worker's export")
    got = best.predict({"x": x})
    with torch.no_grad():
        want = cpu(torch.from_numpy(x)).numpy()
    err = float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())
    check(err <= CHRONOS_PRED_TOL,
          f"the rebuilt model predicts {err:.3g} off the worker's export")
    return dict(workers=workers, worker_reports=seen,
                search_wall_s=wall, best_config=auto.get_best_config(),
                predict_max_rel_err=err)


def phase_chronos(torch, seed: int, card: str) -> dict:
    """Phase 21: Chronos AutoTS, parts (a)-(e); no kernel of ours is
    launched from its start to its end."""
    from analytics_zoo_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    x, y = roll_series(taxi_series(seed), CHRONOS_LOOKBACK, CHRONOS_HORIZON)
    out, part_s = dict(windows=len(x)), {}
    for part, fn in (("a", lambda: chronos_context(torch)),
                     ("b", lambda: chronos_forecasters(torch, seed, x, y)),
                     ("c", lambda: chronos_autots(torch, seed, x, y)),
                     ("d", lambda: chronos_device_backend(torch, seed)),
                     ("e", lambda: chronos_process_backend(torch, seed))):
        t1 = time.perf_counter()
        out[part] = fn()
        part_s[part] = time.perf_counter() - t1
    out["part_seconds"] = part_s
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"phase 21 launched a kernel of ours: {counts}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    print("chronos " + json.dumps(dict(
        card=card, seconds=out["seconds"], windows=out["windows"],
        part_seconds=out["part_seconds"],
        forecasters={n: dict(
            predict_max_rel_err=r["predict_max_rel_err"],
            first_step=r["first_step"], fit=r["fit"],
            step_profile=r["step_profile"],
            epoch_busy_share=r["epoch_busy"]["device_busy_share"],
            params=r["params"], seconds=r["seconds"])
            for n, r in out["b"].items()},
        autots={k: out["c"][k] for k in (
            "best_config", "search_wall_s", "trial_epochs",
            "wall_s_per_trial_epoch", "val_mse", "val_var")},
        device_backend=out["d"], process_backend=out["e"])), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 22: the rest of Chronos and AutoML
# ---------------------------------------------------------------------------

#: MTNet at the JAX constructor's defaults: (4 memory chunks + 1) x 8
MTNET_LOOKBACK = 40
#: DeepGLO's electricity set (Sen et al., 2019): 370 hourly series
ELEC_SERIES, ELEC_POINTS = 370, 25_968
#: the day and the week of an hourly series
ELEC_DAY, ELEC_WEEK = 24, 168
TCMF_EPOCHS = 4
TCMF_HORIZON = 24
#: TCMF's predictions from the same fitted state: |d| <= tol * max(1, |CPU|)
TCMF_PRED_TOL = 1e-4
#: a first step's parameters after it and its losses, card against CPU:
#: |d| <= STEP_TOL * max(1, |CPU|); the GAN's gradients:
#: |d| <= GAN_GRAD_TOL * the CPU gradient's largest of each tensor
STEP_TOL = 1e-5
GAN_GRAD_TOL = 1e-4
#: the GAN's updates are held where the CPU gradient is 1000 x Adam's eps
GAN_WELL_SCALED = 1e-5
#: the memory attention's rows: |sum - 1| <= MTNET_ATTN_TOL
MTNET_ATTN_TOL = 1e-6
#: DoppelGANger's WWT set (Lin et al., 2020): daily page views of 550
#: days, 1 feature, 3 attributes (domain, access, agent); the series
#: count is cut to what the phase's time allows
WWT_POINTS, WWT_ATTRS = 550, 3
WWT_SERIES = 8192
GAN_BATCH, GAN_EPOCHS = 128, 2
#: AutoXGBoost on lagged taxi windows
XGB_LAGS = 24
#: what phase 22 leaves to the CPU tests: they need pandas or sklearn,
#: which the card machine lacks
REST_LEFT_OUT = ("ProphetForecaster and AutoTSEstimator(model='prophet') "
                 "(pandas frames), XShardsTSDataset (pandas shards) and "
                 "DBScanDetector (sklearn): held by tests/"
                 "test_torch_chronos_*.py on the CPU")


class Laps(dict):
    """Seconds between calls, by name: `laps("fit")` records the time
    since the previous call (the card synchronized first)."""

    def __init__(self, torch):
        super().__init__()
        self.torch, self.t = torch, time.perf_counter()

    def __call__(self, name: str) -> None:
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        self[name], self.t = now - self.t, now


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def rest_mtnet(torch, seed: int, series: np.ndarray) -> dict:
    """(a): MTNet at JAX's defaults on the taxi series' 40-step windows:
    predictions, the memory attention and the first step against the
    port on the CPU from the same weights (dropout 0); a fit of 2
    epochs at batch 64; save -> load bitwise."""
    import os
    import tempfile
    from analytics_zoo_tpu_torch.chronos.forecaster import MTNetForecaster
    laps = Laps(torch)
    x, y = roll_series(series, MTNET_LOOKBACK, 1)
    card = MTNetForecaster(seed=seed, dropout=0.0)
    cpu = MTNetForecaster(seed=seed, dropout=0.0, device="cpu")
    check(card.past_seq_len == MTNET_LOOKBACK, "MTNet's window is not 40")
    cpu._estimator().set_params({
        k: v.detach().cpu()
        for k, v in card._estimator().get_model().state_dict().items()})
    laps("build")
    got = card.predict((x, None), batch_size=1024)
    laps("predict")
    want = cpu.predict((x, None), batch_size=1024)
    laps("cpu_predict")
    check(got.shape == (len(x), 1, 1) and np.isfinite(got).all(),
          f"MTNet predictions {got.shape}")
    err = rel_err(got, want)
    check(err <= CHRONOS_PRED_TOL,
          f"MTNet predictions {err:.3g} off the CPU's")
    model = card._estimator().get_model().eval()
    with torch.no_grad():
        model(torch.from_numpy(x[:1024]).cuda())
    attn = model.memory_attention
    attn_err = float((attn.sum(dim=1) - 1.0).abs().max())
    check(attn.shape == (1024, 4) and attn_err <= MTNET_ATTN_TOL,
          f"MTNet memory attention rows sum to 1 +- {attn_err:.3g}")
    out = dict(windows=len(x), predict_max_rel_err=err,
               memory_attention_row_sum_err=attn_err,
               # the time attention's bias shifts every score of a
               # softmax alike: its exact gradient is 0
               first_step=chronos_first_step(
                   torch, card, cpu, x[:CHRONOS_BATCH], y[:CHRONOS_BATCH],
                   zero=("mem_encoder.attn.bias",
                         "short_encoder.attn.bias")))
    laps("first_step")
    del card, cpu
    fc = MTNetForecaster(seed=seed)
    out["fit"] = chronos_fit(torch, fc, x, y, CHRONOS_EPOCHS)
    laps("fit")
    losses = out["fit"]["epoch_losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"MTNet loss did not fall: {losses}")
    batch = slice(0, CHRONOS_BATCH)
    out["step_profile"] = keras_step_profile(
        torch, fc._estimator(), (x[batch],), y[batch])
    laps("step_profile")
    out["epoch_busy"] = busy_share(torch, lambda: fc.fit(
        (x, y), epochs=1, batch_size=CHRONOS_BATCH), host=False)
    laps("epoch_busy")
    path = os.path.join(tempfile.mkdtemp(), "mtnet.pkl")
    with deterministic(torch):
        before = fc.predict((x, None), batch_size=1024)
        fc.save(path)
        after = MTNetForecaster.load(path).predict((x, None),
                                                   batch_size=1024)
    check(np.array_equal(before, after),
          "MTNet save -> load does not predict bitwise")
    os.remove(path)
    laps("save_load")
    out["params"] = sum(p.numel()
                        for p in fc._estimator().get_model().parameters())
    out["laps_s"] = dict(laps)
    return out


def electricity_matrix(seed: int, n: int = ELEC_SERIES,
                       t: int = ELEC_POINTS) -> np.ndarray:
    """[n, t] f32 hourly loads of the electricity set's shape: per-series
    level and scale, a daily and a weekly season of per-series phase,
    and noise."""
    rng = np.random.default_rng(seed)
    hours = np.arange(t, dtype=np.float64)[None]
    level = rng.lognormal(5.0, 1.0, (n, 1))
    scale = level * rng.uniform(0.1, 0.4, (n, 1))
    daily = np.sin(2 * np.pi * hours / ELEC_DAY
                   + rng.uniform(0, 2 * np.pi, (n, 1)))
    weekly = 0.5 * np.sin(2 * np.pi * hours / ELEC_WEEK
                          + rng.uniform(0, 2 * np.pi, (n, 1)))
    noise = 0.2 * rng.standard_normal((n, t))
    return (level + scale * (daily + weekly + noise)).astype(np.float32)


def tcmf_first_step(torch, seed: int, y: np.ndarray) -> dict:
    """The factorization's first Adam step (one batch of `vbsize` ids)
    on the card and on the CPU from the same state."""
    from analytics_zoo_tpu_torch.chronos.forecaster import TCMFForecaster
    ests = []
    for device in (None, "cpu"):
        fc = TCMFForecaster(seed=seed, device=device)
        fc._prepare({"y": y})
        ests.append(fc._factorization_estimator())
    card, cpu = ests
    cpu.set_params({k: v.detach().cpu()
                    for k, v in card.get_model().state_dict().items()})
    data = fc._factorization_data()
    host = {"features": (data["x"][:fc.vbsize],),
            "labels": (data["y"][:fc.vbsize],),
            "mask": np.ones(fc.vbsize, np.float32)}
    for est in ests:
        est.engine.train_step(est.engine.put_batch(host))
    errs = {}
    for k, v in cpu.get_model().state_dict().items():
        errs[k] = rel_err(card.get_model().state_dict()[k].cpu().numpy(),
                          v.numpy())
        check(errs[k] <= STEP_TOL,
              f"TCMF's first step: {k} {errs[k]:.3g} off the CPU's")
    return errs


def rest_tcmf(torch, seed: int) -> dict:
    """(b): TCMF at the electricity set's shape (370 series, 25,968
    hours) at its defaults (rank 16, lookback 16, TCNs (32, 32) and
    (16, 16)): the first factorization step against the CPU; a fit of
    `TCMF_EPOCHS` epochs, each stage's wall; predict(24) global and
    hybrid on the card and, from the same saved state, on the CPU;
    fit_incremental on 24 new hours."""
    import os
    import tempfile
    from analytics_zoo_tpu_torch.chronos.forecaster import TCMFForecaster
    from analytics_zoo_tpu_torch.chronos.forecaster.tcmf_forecaster import (
        _next_value_windows,
    )
    laps = Laps(torch)
    full = electricity_matrix(seed, t=ELEC_POINTS + TCMF_HORIZON)
    hist, new = full[:, :ELEC_POINTS], full[:, ELEC_POINTS:]
    laps("data")
    out = dict(series=ELEC_SERIES, points=ELEC_POINTS,
               first_step_rel_err=tcmf_first_step(torch, seed, hist))
    laps("first_step")
    fc = TCMFForecaster(seed=seed)
    # the basis TCN's steps of the first fit, each marked by a CUDA event
    # as it is queued (phase 21's timing)
    marks, basis = [], []
    make = fc._tcn_forecaster

    def marked_tcn(n_in, channels):
        made = make(n_in, channels)
        if n_in == 1 and not basis:
            basis.append(made)
            eng = made._estimator().engine

            def marked_step(b, step=eng.train_step):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                return step(b)
            eng.train_step = marked_step
        return made

    fc._tcn_forecaster = marked_tcn
    walls = {}
    for name in ("_fit_factorization", "_fit_basis_tcn", "_fit_local"):
        def timed(*a, _fn=getattr(fc, name), _name=name, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = _fn(*a, **kw)
            torch.cuda.synchronize()
            walls.setdefault(_name, []).append(time.perf_counter() - t1)
            return r
        setattr(fc, name, timed)
    fc.fit({"y": hist}, epochs=TCMF_EPOCHS)
    laps("fit")
    del basis[0]._estimator().engine.train_step
    periods = [p.elapsed_time(q) for p, q in zip(marks, marks[1:])]
    summary = basis[0]._estimator().train_summary
    out["basis_fit"] = dict(
        steps=len(marks), step_ms_p50=statistics.median(periods),
        epoch_losses=[r["loss"] for r in summary],
        samples_per_s=summary[-1]["samples_per_s"])
    check(np.isfinite(fc._X).all() and np.isfinite(fc._F).all(),
          "TCMF's factorization is not finite")
    recon = fc._F @ fc._X
    out["factorization_recon_mse_normalized"] = float(
        ((recon - fc._yn) ** 2).mean())
    path = os.path.join(tempfile.mkdtemp(), "tcmf.pkl")
    fc.save(path)
    cpu = TCMFForecaster.load(path, device="cpu")
    laps("save_load_cpu")
    preds = {}
    for hybrid in (False, True):
        fc.hybrid = cpu.hybrid = hybrid
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = fc.predict(horizon=TCMF_HORIZON)
        wall = time.perf_counter() - t1
        want = cpu.predict(horizon=TCMF_HORIZON)
        label = "hybrid" if hybrid else "global"
        check(got.shape == (ELEC_SERIES, TCMF_HORIZON)
              and np.isfinite(got).all(), f"TCMF {label} predict {got.shape}")
        err = rel_err(got, want)
        check(err <= TCMF_PRED_TOL,
              f"TCMF {label} predict {err:.3g} off the CPU's")
        preds[label] = dict(max_rel_err=err, wall_s=wall,
                            mse=float(((got - new) ** 2).mean()))
    out["predict"] = preds
    laps("predicts")
    out["naive_last_day_mse"] = float(
        ((hist[:, -TCMF_HORIZON:] - new) ** 2).mean())
    os.remove(path)
    # host against card time for a basis step, and the local TCN's busy
    # share over one refit, on the fitted forecasters
    xs, ys = _next_value_windows(fc._X, fc._lookback())
    out["basis_windows"] = len(xs)
    out["basis_step_profile"] = keras_step_profile(
        torch, fc._tcn._estimator(), (xs[:256, :, None],),
        ys[:256, None, None])
    laps("step_profile")
    local_x, local_y = fc._local_windows()
    out["local_epoch_busy"] = busy_share(torch, lambda: fc._local.fit(
        {"x": local_x, "y": local_y}, epochs=1, batch_size=256), host=False)
    laps("local_busy")
    fc.fit_incremental({"y": new})
    laps("fit_incremental")
    again = fc.predict(horizon=TCMF_HORIZON)
    check(fc.T == ELEC_POINTS + TCMF_HORIZON and again.shape ==
          (ELEC_SERIES, TCMF_HORIZON) and np.isfinite(again).all(),
          "TCMF fit_incremental did not roll forward")
    out["stage_walls_s"] = walls
    out["laps_s"] = dict(laps)
    return out


def rest_host(torch, seed: int, series: np.ndarray) -> dict:
    """(c): the detectors and the classical legs on the host, beside the
    card: AEDetector (roll 24, JAX's defaults) trained on the card and
    re-scored on the CPU from its weights; ThresholdDetector; AutoARIMA
    through AutoTSEstimator(model="arima"), whose TSPipeline holds the
    best ARIMAForecaster; AutoXGBRegressor on lagged windows."""
    import os
    import tempfile
    from analytics_zoo_tpu_torch.chronos.autots import (
        AutoTSEstimator,
        TSPipeline,
    )
    from analytics_zoo_tpu_torch.chronos.detector.anomaly import (
        AEDetector,
        ThresholdDetector,
    )
    from analytics_zoo_tpu_torch.orca.automl import hp
    from analytics_zoo_tpu_torch.orca.automl.xgboost import AutoXGBRegressor
    out = {}
    t0 = time.perf_counter()
    det = AEDetector(roll_len=24).fit(series)
    torch.cuda.synchronize()
    out["ae_fit_s"] = time.perf_counter() - t0
    cpu = AEDetector(roll_len=24, device="cpu")
    flat, win = cpu._windows(series)
    cpu._est = cpu._estimator(win.shape[1])
    cpu._est.set_params({k: v.detach().cpu() for k, v in
                         det._est.get_model().state_dict().items()})
    cpu._scores = cpu._score(flat, win)
    check(np.array_equal(det.anomaly_indexes(), cpu.anomaly_indexes()),
          "AEDetector's anomaly indexes differ from the CPU's on its "
          "weights")
    # an epoch more of the card's AE (after its gate), its steps timed,
    # one synchronized and profiled step, and a profiled epoch
    est, data = det._est, {"x": win, "y": win}
    periods = marked_steps(torch, est.engine, lambda: est.fit(
        data, epochs=1, batch_size=det.batch_size))
    out["ae"] = dict(anomalies=len(det.anomaly_indexes()),
                     score_max_rel_err=rel_err(det.score(), cpu.score()),
                     epochs=det.epochs,
                     step_ms_p50=statistics.median(periods),
                     samples_per_s=est.train_summary[-1]["samples_per_s"],
                     step_profile=keras_step_profile(
                         torch, est, (win[:det.batch_size],),
                         win[:det.batch_size]),
                     epoch_busy_share=busy_share(torch, lambda: est.fit(
                         data, epochs=1, batch_size=det.batch_size),
                         host=False)["device_busy_share"])
    th = ThresholdDetector().set_params(threshold=(-2.0, 2.0)).fit(series)
    want = np.nonzero(np.abs(series) > 2.0)[0]
    check(np.array_equal(th.anomaly_indexes(), want),
          "ThresholdDetector's bounds")
    out["threshold_anomalies"] = len(want)
    # the classical legs: a day (48 half hours) held out
    train, val = series[:-TAXI_DAY], series[-TAXI_DAY:]
    space = {"p": hp.randint(0, 3), "q": hp.randint(0, 3),
             "P": hp.randint(0, 2), "Q": hp.randint(0, 2),
             "seasonal": True, "m": TAXI_DAY}
    t0 = time.perf_counter()
    auto = AutoTSEstimator(model="arima", search_space=space)
    pipe = auto.fit(train, validation_data=val, n_sampling=3)
    wall = time.perf_counter() - t0
    preds = pipe.predict(TAXI_DAY)
    stats = pipe.evaluate(val)
    check(type(pipe.forecaster).__name__ == "ARIMAForecaster"
          and preds.shape == (TAXI_DAY,) and np.isfinite(preds).all()
          and np.array_equal(preds, pipe.forecaster.predict(TAXI_DAY)),
          "AutoTSEstimator(model='arima') pipeline")
    check(stats["mse"] < float(np.var(series)),
          f"the ARIMA pipeline's mse {stats['mse']} is not below var")
    d = tempfile.mkdtemp()
    pipe.save(d)
    check(np.array_equal(TSPipeline.load(d).predict(TAXI_DAY), preds),
          "the ARIMA pipeline's save -> load")
    for f in os.listdir(d):
        os.remove(os.path.join(d, f))
    os.rmdir(d)
    arima = pipe.forecaster.model
    out["auto_arima"] = dict(best_config=auto.get_best_config(),
                             order=(arima.p, arima.d, arima.q, arima.P,
                                    arima.D, arima.Q, arima.m),
                             search_wall_s=wall, val=stats,
                             seasonal_naive_mse=float(
                                 ((series[-2 * TAXI_DAY:-TAXI_DAY] - val)
                                  ** 2).mean()))
    lags = np.lib.stride_tricks.sliding_window_view(series, XGB_LAGS + 1)
    x, y = lags[:, :-1], lags[:, -1]
    cut = int(0.8 * len(x))
    t0 = time.perf_counter()
    xgb = AutoXGBRegressor().fit(
        (x[:cut], y[:cut]), (x[cut:], y[cut:]),
        search_space={"max_depth": hp.choice([4, 6]),
                      "learning_rate": hp.choice([0.1, 0.3])},
        n_sampling=3, epochs=1, rounds_per_epoch=30)
    wall = time.perf_counter() - t0
    mse = float(((xgb.predict(x[cut:]) - y[cut:]) ** 2).mean())
    check(mse < float(np.var(y[cut:])),
          f"AutoXGBRegressor's mse {mse} is not below var")
    out["auto_xgboost"] = dict(best_config=xgb.get_best_config(),
                               val_mse=mse, search_wall_s=wall,
                               rows=len(x), lags=XGB_LAGS)
    return out


def wwt_like(seed: int, n: int = WWT_SERIES):
    """(features [n, 550, 1], attributes [n, 3]): log daily page views
    with a weekly season and a trend per series; the attributes a
    domain, an access type and an agent index, as the set's."""
    rng = np.random.default_rng(seed)
    days = np.arange(WWT_POINTS, dtype=np.float64)[None]
    attrs = np.stack([rng.integers(0, 9, n), rng.integers(0, 3, n),
                      rng.integers(0, 2, n)], axis=1).astype(np.float32)
    level = rng.normal(6.0, 1.5, (n, 1)) + 0.3 * attrs[:, 1:2]
    weekly = rng.uniform(0.05, 0.4, (n, 1)) * np.sin(
        2 * np.pi * days / 7 + rng.uniform(0, 2 * np.pi, (n, 1)))
    trend = rng.normal(0.0, 0.5, (n, 1)) * days / WWT_POINTS
    noise = 0.2 * rng.standard_normal((n, WWT_POINTS))
    return ((level + weekly + trend + noise)[..., None].astype(np.float32),
            attrs)


def gan_first_step(torch, seed: int, feats, attrs) -> dict:
    """One adversarial step on the card and on the CPU from the same
    weights, the same real batch and the same noise: both losses within
    `STEP_TOL`, each tensor's gradient and its update within
    `GAN_GRAD_TOL` of the tensor's largest.  Adam's first update is
    lr * g / (|g| + eps): where |g| nears eps = 1e-8 it turns a
    gradient's rounding into a visible share of an update, so the update
    is held where the CPU's |g| >= `GAN_WELL_SCALED` (there an update
    moves by under 1e-6 of lr for a gradient 1e-4 off), and its error
    over every element is reported with the gradient it sat at."""
    from analytics_zoo_tpu_torch.chronos.simulator import DPGANSimulator
    sims = []
    for device in (None, "cpu"):
        sim = DPGANSimulator(seq_len=WWT_POINTS, feature_dim=1,
                             attr_dim=WWT_ATTRS, seed=seed, device=device)
        f01, a01 = sim._scale_fit(feats, attrs)
        sim._build()
        sims.append(sim)
    card, cpu = sims
    nets = ("generator", "discriminator")
    for net in nets:
        getattr(cpu, net).load_state_dict({
            k: v.cpu() for k, v in getattr(card, net).state_dict().items()})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    z_a, z_s = card.noise(GAN_BATCH, gen)
    real_a = torch.from_numpy(a01[:GAN_BATCH])
    real_s = torch.from_numpy(f01[:GAN_BATCH])
    before = {net: {k: p.detach().clone() for k, p in
                    getattr(cpu, net).named_parameters()} for net in nets}
    got = card.gan_step(real_a.cuda(), real_s.cuda(), z_a, z_s)
    want = cpu.gan_step(real_a, real_s, z_a.cpu(), z_s.cpu())
    for name in ("d_loss", "g_loss"):
        err = rel_err(float(got[name]), float(want[name]))
        check(err <= STEP_TOL, f"the GAN's first {name} {err:.3g} off")
    worst = dict(grad=0.0, update=0.0, update_all=0.0)
    for net in nets:
        card_p = dict(getattr(card, net).named_parameters())
        for k, p in getattr(cpu, net).named_parameters():
            g_cpu, g_card = p.grad, card_p[k].grad.cpu()
            top = float(g_cpu.abs().max())
            grad = float((g_card - g_cpu).abs().max()) / top if top else \
                float(g_card.abs().max())
            d_cpu = p.detach() - before[net][k]
            diff = (card_p[k].detach().cpu() - before[net][k] - d_cpu).abs()
            top = float(d_cpu.abs().max()) or 1.0
            scaled = g_cpu.abs() >= GAN_WELL_SCALED
            update = float(diff[scaled].max()) / top if scaled.any() else 0.0
            check(grad <= GAN_GRAD_TOL and update <= GAN_GRAD_TOL,
                  f"the GAN's first step: {net}.{k} gradient {grad:.3g}, "
                  f"update {update:.3g} of its largest off the CPU's")
            worst["grad"] = max(worst["grad"], grad)
            worst["update"] = max(worst["update"], update)
            if float(diff.max()) / top > worst["update_all"]:
                worst.update(update_all=float(diff.max()) / top,
                             update_all_at=f"{net}.{k}",
                             update_all_cpu_grad=float(
                                 g_cpu.flatten()[int(diff.argmax())]))
    return dict(worst, d_loss=float(got["d_loss"]),
                cpu_d_loss=float(want["d_loss"]),
                g_loss=float(got["g_loss"]),
                cpu_g_loss=float(want["g_loss"]))


def rest_gan(torch, seed: int) -> dict:
    """(d): DPGANSimulator at the WWT set's shape: the first step
    against the CPU on the same noise; a fit of `GAN_EPOCHS` epochs at
    batch `GAN_BATCH`, each step timed between CUDA events; generate in
    the training range; save -> load -> generate bitwise."""
    import os
    import tempfile
    from analytics_zoo_tpu_torch.chronos.simulator import DPGANSimulator
    feats, attrs = wwt_like(seed)
    out = dict(series=len(feats), points=WWT_POINTS, attrs=WWT_ATTRS,
               first_step=gan_first_step(torch, seed, feats, attrs))
    sim = DPGANSimulator(seq_len=WWT_POINTS, feature_dim=1,
                         attr_dim=WWT_ATTRS, seed=seed)
    marks = []

    def marked(*a, step=sim.gan_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(*a)

    sim.gan_step = marked
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.fit(feats, attrs, epochs=GAN_EPOCHS, batch_size=GAN_BATCH)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del sim.gan_step
    periods = [a.elapsed_time(b) for a, b in zip(marks[1:], marks[2:])]
    check(len(sim.loss_history) == GAN_EPOCHS and np.isfinite(
        [v for h in sim.loss_history for v in h.values()]).all(),
        f"the GAN's losses {sim.loss_history}")
    out["fit"] = dict(steps=len(marks) - 1, wall_s=wall,
                      step_ms_p50=statistics.median(periods),
                      samples_per_s=GAN_EPOCHS * len(feats) / wall,
                      losses=list(sim.loss_history))
    # host wall against card time for a step, on one batch and one noise
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    real_s = torch.from_numpy(feats[:GAN_BATCH]).cuda()
    real_a = torch.from_numpy(attrs[:GAN_BATCH]).cuda()
    noise = sim.noise(GAN_BATCH, gen)

    out["step_profile"] = step_profile(
        torch, lambda: sim.gan_step(real_a, real_s, *noise))
    g_attrs, g_feats = sim.generate(256, seed=seed)
    check(g_feats.shape == (256, WWT_POINTS, 1)
          and g_attrs.shape == (256, WWT_ATTRS)
          and g_feats.min() >= feats.min() - 1e-4
          and g_feats.max() <= feats.max() + 1e-4
          and (g_attrs.min(axis=0) >= attrs.min(axis=0) - 1e-4).all()
          and (g_attrs.max(axis=0) <= attrs.max(axis=0) + 1e-4).all(),
          "generated values outside the training range")
    path = os.path.join(tempfile.mkdtemp(), "dpgan.pkl")
    with deterministic(torch):
        before = sim.generate(64, seed=seed + 1)
        sim.save(path)
        after = DPGANSimulator.load(path).generate(64, seed=seed + 1)
    check(np.array_equal(before[0], after[0])
          and np.array_equal(before[1], after[1]),
          "DPGANSimulator save -> load -> generate is not bitwise")
    os.remove(path)
    out["epoch_busy"] = busy_share(torch, lambda: sim.fit(
        feats, attrs, epochs=1, batch_size=GAN_BATCH), host=False)
    out["generated_std_over_real_std"] = float(
        g_feats.std(axis=1).mean() / feats.std(axis=1).mean())
    return out


def phase_chronos_rest(torch, seed: int, card: str) -> dict:
    """Phase 22: the rest of Chronos and AutoML, parts (a)-(d); no
    kernel of ours is launched from its start to its end."""
    from analytics_zoo_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    series = taxi_series(seed)
    out, part_s = {}, {}
    for part, fn in (("a", lambda: rest_mtnet(torch, seed, series)),
                     ("b", lambda: rest_tcmf(torch, seed)),
                     ("c", lambda: rest_host(torch, seed, series)),
                     ("d", lambda: rest_gan(torch, seed))):
        t1 = time.perf_counter()
        out[part] = fn()
        part_s[part] = time.perf_counter() - t1
        print(f"phase 22 ({part}) in {part_s[part]:.1f} s [{card}]: "
              + json.dumps(out[part], default=str)[:4000], flush=True)
    out["part_seconds"] = part_s
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"phase 22 launched a kernel of ours: {counts}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    a, b, d = out["a"], out["b"], out["d"]
    print("chronos_rest " + json.dumps(dict(
        card=card, seconds=out["seconds"], part_seconds=part_s,
        mtnet={k: a[k] for k in (
            "windows", "predict_max_rel_err",
            "memory_attention_row_sum_err", "first_step", "fit",
            "step_profile", "params", "laps_s")}
        | {"epoch_busy_share": a["epoch_busy"]["device_busy_share"]},
        tcmf={k: b[k] for k in (
            "series", "points", "first_step_rel_err", "laps_s",
            "stage_walls_s", "factorization_recon_mse_normalized",
            "predict", "naive_last_day_mse", "basis_windows", "basis_fit",
            "basis_step_profile")}
        | {"local_epoch_busy_share":
           b["local_epoch_busy"]["device_busy_share"]},
        host=out["c"],
        dpgan={k: d[k] for k in ("series", "points", "attrs", "first_step",
                                 "fit", "step_profile",
                                 "generated_std_over_real_std")}
        | {"epoch_busy_share": d["epoch_busy"]["device_busy_share"],
           "cut": f"{WWT_SERIES} series of WWT's shape, "
                  f"{GAN_EPOCHS} epochs at batch {GAN_BATCH}"},
        left_out=REST_LEFT_OUT, launches=counts)), flush=True)
    return out


# ----------------------------------------------------------------------
# phase 23: the training-side observability planes on the fine-tune and
# decode paths (analytics_zoo_tpu_torch/observability/)
# ----------------------------------------------------------------------

#: BERT-base fine-tune of (a): batch x t, steps an epoch, validation steps
OBS_BATCH, OBS_T, OBS_STEPS, OBS_VAL_STEPS = 32, 128, 16, 4
#: the planes' settings of (a) and (b)
OBS_ON = dict(goodput_sample_every=4, watchdog_deadline_s=120.0,
              nonfinite_watchdog=True, hardware_peak_flops=BF16_FLOPS)
#: the same fit with no sink and the sampled goodput fences as rare as
#: they get ("off"), and with the sentinel and the watchdog off too
#: ("bare"); spans, event counters, the ledger and the flight ring have
#: no switch
OBS_OFF = {"off": dict(OBS_ON, goodput_sample_every=10 ** 6),
           "bare": dict(OBS_ON, goodput_sample_every=10 ** 6,
                        watchdog_deadline_s=None, nonfinite_watchdog=False)}
#: the timed fits after the gated one, in turns
OBS_WALL_TURNS = ("off", "bare", "bare", "off", "on")
#: generation of (c): requests, new tokens each, runs in turns
OBS_REQUESTS, OBS_NEW = 16, 32
OBS_TURNS = ("on", "off", "off", "on")
#: the default of every setting phase 23 writes, put back at its end
OBS_DEFAULTS = dict(observability_dir=None, goodput_sample_every=16,
                    watchdog_deadline_s=None, nonfinite_watchdog=False,
                    hardware_peak_flops=None)


def fresh_planes(o) -> None:
    """Drop what earlier phases left in the port's planes."""
    o.flight_recorder.uninstall()
    o.flight_recorder.clear_ring()
    o.close_sink()
    o.clear_spans()
    o.reset_registry()
    o.reset_profiling()
    o.reset_request_log()
    o.goodput.reset_clocks()
    o.memory.reset()
    o.reset_slo_tracker()
    o.reset_blame_tracker()
    o.reset_exemplar_store()
    o.reset_recorder()
    o.telemetry_spool.reset_spools()


def set_context(ctx, **settings) -> None:
    for k, v in settings.items():
        setattr(ctx, k, v)


def span_chains(spans) -> dict:
    """{name chain from an spmd.step span to its root: count}."""
    by_id = {s["span_id"]: s for s in spans}
    out = {}
    for s in spans:
        if s["name"] != "spmd.step":
            continue
        chain = []
        while s is not None:
            chain.append(s["name"])
            s = by_id.get(s["parent_id"])
        out[" < ".join(chain)] = out.get(" < ".join(chain), 0) + 1
    return out


def read_events(directory: str) -> list:
    with open(os.path.join(directory, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def obs_fine_tune(torch, seed: int, card: str, model, n_blk: int, data,
                  val, directory: str) -> dict:
    """(a): two epochs of the fine-tune with the planes at `OBS_ON` and
    the sink in `directory`, gated; then the same fit at each of
    `OBS_OFF`'s settings, with no sink, for the step wall beside it."""
    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    def fit(settings, sink):
        fresh_planes(o)
        set_context(OrcaContext, observability_dir=sink, **settings)
        est = Estimator.from_torch(
            model, loss="sparse_categorical_crossentropy",
            optimizer="adam", learning_rate=2e-5, metrics=["accuracy"],
            seed=seed)
        kernels.reset_launch_counts()
        est.fit(data, epochs=2, batch_size=OBS_BATCH, shuffle=False,
                validation_data=val)
        torch.cuda.synchronize()
        return est, kernels.launch_counts()

    est, counts = fit(OBS_ON, directory)
    steps, val_steps = 2 * OBS_STEPS, 2 * OBS_VAL_STEPS
    fwd = dict(layer_norm_fwd=2 * n_blk + 1, fused_dense_gelu=n_blk,
               flash_fwd=n_blk)
    bwd = dict(layer_norm_bwd=2 * n_blk + 1, flash_bwd_dq=n_blk,
               flash_bwd_dkv=n_blk)
    want = {k: 0 for k in counts}
    for k, v in fwd.items():
        want[k] = v * (steps + val_steps)
    for k, v in bwd.items():
        want[k] = v * steps
    check(counts == want, f"phase 23 (a): launches {counts}, expected "
          f"{want}: {steps} steps at the fine-tune's per-step counts and "
          f"{val_steps} validation forwards")
    events = read_events(directory)
    kinds = [e["kind"] for e in events if e["kind"] != "span"]
    check(kinds.count("train_epoch") == 2
          and kinds.count("validation_epoch") == 2,
          f"phase 23 (a): events {kinds}")
    chains = span_chains(o.recent_spans(2048))
    check(chains == {"spmd.step < estimator.epoch < estimator.fit":
                     steps + val_steps},
          f"phase 23 (a): spmd.step span chains {chains}")
    ledger = o.ledger_snapshot()
    train = ledger["families"]["train_step"]
    check(train["compile_count"] == 1 and train["signatures"] == 1
          and train["calls"] == steps,
          f"phase 23 (a): train_step ledger {train}")
    table = o.goodput_tables()["spmd_train"]
    bucket_sum = sum(table["buckets_s"].values())
    check(abs(bucket_sum - table["wall_s"]) <= 0.05 * table["wall_s"],
          f"phase 23 (a): goodput buckets sum {bucket_sum} against the "
          f"wall {table['wall_s']}")
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    allocated = o.get_registry().gauge("memory_device_allocated_bytes").max
    check(allocated >= param_bytes,
          f"phase 23 (a): memory_device_allocated_bytes {allocated} < "
          f"the parameters' {param_bytes} bytes")
    on = dict(
        step_ms_mean=est.train_summary[-1]["wall_s"] / OBS_STEPS * 1e3,
        goodput=table, goodput_ratio=o.process_goodput_ratio(),
        mfu_ratio=ledger["mfu"]["overall"], train_step_ledger=train,
        eval_step_ledger=ledger["families"]["eval_step"],
        memory_device_allocated_bytes_max=allocated,
        param_bytes=param_bytes, events=len(events),
        span_chains=chains, launches=counts)
    # the step wall of epoch 2 at each setting, in turns after the gated
    # run (host-bound steps swing between windows)
    walls = {"on": [on["step_ms_mean"]], "off": [], "bare": []}
    for label in OBS_WALL_TURNS:
        settings = OBS_ON if label == "on" else OBS_OFF[label]
        est_t, counts_t = fit(settings, directory if label == "on" else None)
        check(counts_t == want, f"phase 23 (a) {label}: launches "
              f"{counts_t}, expected {want}")
        walls[label].append(est_t.train_summary[-1]["wall_s"] / OBS_STEPS
                            * 1e3)
    on["step_ms_windows"] = walls["on"]
    # the card's busy share over one more warm epoch of the last ("on")
    # fit, whose clock is the live one, at the planes' settings (a device
    # trace: kernel, copy and fill time over the host wall), beside that
    # epoch's goodput ratio, which is the host's wait after each step's
    # dispatch
    check(OBS_WALL_TURNS[-1] == "on", "phase 23 (a): the last turn is on")
    set_context(OrcaContext, observability_dir=None, **OBS_ON)
    before = o.goodput_tables()["spmd_train"]
    busy = busy_share(torch, lambda: est_t.fit(
        data, epochs=1, batch_size=OBS_BATCH, shuffle=False), host=False)
    after = o.goodput_tables()["spmd_train"]
    busy["goodput_ratio"] = (
        (after["buckets_s"]["device_compute"]
         - before["buckets_s"]["device_compute"])
        / (after["fenced_wall_s"] - before["fenced_wall_s"]))
    busy["step_ms_mean"] = (est_t.train_summary[-1]["wall_s"] / OBS_STEPS
                            * 1e3)
    on["card_busy"] = busy
    off = {label: dict(settings=OBS_OFF[label], step_ms_windows=walls[label],
                       step_ms_mean=statistics.median(walls[label]))
           for label in OBS_OFF}
    on["step_ms_mean"] = statistics.median(walls["on"])
    walls_text = ", ".join(
        f"{v['step_ms_mean']:.3f} ms {k} ({v['settings']}, no sink; "
        f"windows {v['step_ms_windows']})" for k, v in off.items())
    print(f"phase 23 (a) [{card}] BERT-base fine-tune {OBS_BATCH} x "
          f"{OBS_T}, {OBS_STEPS} steps an epoch: mean step wall of epoch 2, "
          f"median of windows, {on['step_ms_mean']:.3f} ms with the planes "
          f"on ({OBS_ON}, sink on; windows {on['step_ms_windows']}), "
          f"{walls_text}; goodput ratio "
          f"{on['goodput_ratio']:.4f}; one more epoch traced: the card "
          f"busy {busy['device_busy_share']:.4f} of "
          f"{busy['profiled_wall_s']:.3f} s ({busy['step_ms_mean']:.3f} "
          f"ms a step; goodput ratio {busy['goodput_ratio']:.4f}); ledger "
          f"mfu_ratio "
          f"{on['mfu_ratio']:.6f} (6 P FLOPs per row, JAX's count, of "
          f"{BF16_FLOPS:.3g} FLOP/s); goodput {json.dumps(table)}",
          flush=True)
    return dict(on=on, off=off, est=est)


def obs_sentinel(torch, card: str, est, batch, directory: str) -> dict:
    """(b): one step with the classifier's bias poisoned: skipped, and
    its nonfinite_step bundle names that bias first and the card."""
    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    set_context(OrcaContext, observability_dir=directory, **OBS_ON)
    bias = est.get_model().classifier.bias
    saved = bias.detach().clone()
    before = set(o.flight_recorder.find_bundles(directory))
    with torch.no_grad():
        bias.fill_(float("nan"))
    try:
        est.fit(batch, epochs=1, batch_size=OBS_BATCH, shuffle=False)
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    stats = est.train_summary[-1]
    check(stats.get("nan_steps") == 1.0,
          f"phase 23 (b): the poisoned step was not skipped: {stats}")
    new = sorted(set(o.flight_recorder.find_bundles(directory)) - before)
    bundles = []
    for path in new:
        with open(path) as f:
            bundles.append(json.load(f))
    hits = [b for b in bundles if b["reason"] == "nonfinite_step"]
    check(len(hits) == 1, "phase 23 (b): bundles "
          f"{[b['reason'] for b in bundles]}")
    leaves = hits[0]["extra"]["leaves"]
    check(leaves[0]["path"] == "params:['classifier.bias']",
          f"phase 23 (b): the first nonfinite tensor is {leaves[0]}")
    name = torch.cuda.get_device_name(0)
    check(name in hits[0]["torch"].get("devices", []),
          f"phase 23 (b): the bundle's torch section {hits[0]['torch']}")
    out = dict(first_leaves=[lf["path"] for lf in leaves],
               torch=hits[0]["torch"], nan_steps=stats["nan_steps"])
    print(f"phase 23 (b) [{card}] nonfinite sentinel: {json.dumps(out)}",
          flush=True)
    return out


class _NoRequestLog:
    """The lifecycle log switched off, for (c)'s comparison: every entry
    point a no-op, `start` keeping the caller's id."""

    @staticmethod
    def start(request_id=None, **kw):
        return request_id

    def __getattr__(self, name):
        return lambda *a, **kw: None


def obs_generation(torch, seed: int, card: str, model) -> dict:
    """(c): 16 greedy requests through the generation engine with the
    lifecycle log on and off, in turns."""
    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine
    from analytics_zoo_tpu_torch.serving.generation import engine as eng_mod
    from analytics_zoo_tpu_torch.serving.generation import (
        scheduler as sched_mod,
    )
    fresh_planes(o)
    engine = GenerationEngine(model, max_slots=8, block_size=16,
                              max_context=1024, device="cuda")
    engine.warmup()
    rng = np.random.default_rng(seed + 23)
    prompts = [rng.integers(0, model.vocab, int(n)).tolist()
               for n in rng.integers(32, 257, OBS_REQUESTS)]
    runs, streams_by_turn = [], []
    n_block = model.n_block
    for turn, mode in enumerate(OBS_TURNS):
        if mode == "off":
            eng_mod.request_log = sched_mod.request_log = _NoRequestLog()
        pre, dec = engine.n_prefills, engine.n_decode_steps
        kernels.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            streams = [engine.submit(p, max_new_tokens=OBS_NEW,
                                     request_id=f"t{turn}-r{i}")
                       for i, p in enumerate(prompts)]
            engine.ensure_started()
            outs = [s.tokens() for s in streams]
            wall = time.perf_counter() - t0
        finally:
            engine.stop()
            eng_mod.request_log = sched_mod.request_log = o.request_log
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        n_pre = engine.n_prefills - pre
        n_dec = engine.n_decode_steps - dec
        want = {k: 0 for k in counts}
        want["layer_norm_fwd"] = (2 * n_block + 1) * (n_pre + n_dec)
        want["paged_decode"] = n_block * n_dec
        check(counts == want, f"phase 23 (c) {mode}: launches {counts}, "
              f"expected {want} for {n_pre} prefills and {n_dec} decode "
              "steps")
        for s, out in zip(streams, outs):
            check(s.finish_reason == "length" and len(out) == OBS_NEW,
                  f"phase 23 (c) {mode}: a request ended "
                  f"{s.finish_reason!r} after {len(out)} tokens")
            if mode == "on":
                rec = o.request_log.get(s.request_id)
                check(rec is not None and rec["status"] == "finished"
                      and rec["n_tokens"] == len(out)
                      and rec["finish_reason"] == s.finish_reason
                      and rec["queue_wait_s"] <= rec["ttft_s"]
                      <= rec["e2e_s"],
                      f"phase 23 (c): record {rec}")
        streams_by_turn.append(outs)
        runs.append(dict(mode=mode, wall_s=wall,
                         tokens_per_s=OBS_REQUESTS * OBS_NEW / wall,
                         prefills=n_pre, decode_steps=n_dec,
                         launches=counts))
    check(all(o_ == streams_by_turn[0] for o_ in streams_by_turn),
          "phase 23 (c): the token streams differ with the log on and off")
    decode = o.ledger_snapshot()["families"]["decode"]
    check(decode["signatures"] == 1 and not decode["over_budget"],
          f"phase 23 (c): decode ledger {decode}")
    recs = [o.request_log.get(f"t0-r{i}") for i in range(OBS_REQUESTS)]
    out = dict(
        runs=runs,
        tokens_per_s_on=statistics.median(
            r["tokens_per_s"] for r in runs if r["mode"] == "on"),
        tokens_per_s_off=statistics.median(
            r["tokens_per_s"] for r in runs if r["mode"] == "off"),
        ttft_ms_p50=statistics.median(r["ttft_s"] for r in recs) * 1e3,
        tpot_ms_p50=statistics.median(r["tpot_s"] for r in recs) * 1e3,
        decode_ledger=decode, goodput=o.goodput_tables(),
        mfu_decode=o.ledger_snapshot()["mfu"]["decode"])
    print(f"phase 23 (c) [{card}] GPT-2 small, {OBS_REQUESTS} greedy "
          f"requests x {OBS_NEW} tokens, turns {OBS_TURNS}: tokens/s "
          f"{[round(r['tokens_per_s'], 1) for r in runs]}, median with the "
          f"log on {out['tokens_per_s_on']:.1f}, off "
          f"{out['tokens_per_s_off']:.1f}; TTFT p50 "
          f"{out['ttft_ms_p50']:.2f} ms, TPOT p50 {out['tpot_ms_p50']:.3f} "
          f"ms; decode ledger {json.dumps(decode)}", flush=True)
    return out


#: calls a host-cost timing of plane_costs averages over
OBS_COST_CALLS = 2000


def plane_costs(directory: str) -> dict:
    """Host microseconds a call of each plane's hot entry point, the sink
    off and on in turns (off, on, on, off; the median of each): a span,
    an event, a flight record, a lifecycle record's token, a ledgered
    call's signature of a fine-tune batch's four tensors."""
    import torch

    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    batch = {"features": tuple(torch.zeros(OBS_BATCH, OBS_T,
                                           dtype=torch.int32)
                               for _ in range(3)),
             "labels": (torch.zeros(OBS_BATCH, dtype=torch.int64),),
             "mask": torch.ones(OBS_BATCH)}
    ledgered = o.instrument("eval_step", lambda b: b, argnames=("batch",))
    o.request_log.start("cost", prompt_len=1, max_new_tokens=10 ** 9)

    def span():
        with o.trace("cost.span", step=1):
            pass

    calls = {"span": span,
             "event": lambda: o.log_event("cost_event", step=1),
             "flight_record": lambda: o.flight_recorder.record(
                 "cost", step=1),
             "request_token": lambda: o.request_log.token("cost"),
             "ledgered_call": lambda: ledgered(batch)}
    runs = {}
    for sink in ("off", "on", "on", "off"):
        OrcaContext.observability_dir = directory if sink == "on" else None
        for name, fn in calls.items():
            t0 = time.perf_counter()
            for _ in range(OBS_COST_CALLS):
                fn()
            runs.setdefault(f"{name}_sink_{sink}", []).append(
                (time.perf_counter() - t0) / OBS_COST_CALLS * 1e6)
    o.request_log.finish("cost", "length")
    o.close_sink()
    return {k: statistics.median(v) for k, v in runs.items()}


def phase_observability(torch, seed: int, card: str, gpt2_model) -> dict:
    """Phase 23: the observability planes on the fine-tune and decode
    paths, parts (a)-(d)."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    t0 = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="phase23-")
    try:
        cfg = dict(BERT_BASE, num_classes=2)
        model = BERTClassifier(**cfg, attn_impl="flash", device="cuda")
        model.load_state_dict(bert_from_flax(init_bert_params(cfg, seed),
                                             cfg))
        rng = np.random.default_rng(seed + 23)
        inputs, y, _ = train_batch(rng, OBS_BATCH * OBS_STEPS, OBS_T,
                                   cfg["vocab"])
        vin, vy, _ = train_batch(rng, OBS_BATCH * OBS_VAL_STEPS, OBS_T,
                                 cfg["vocab"])
        data = {"x": list(inputs), "y": y}
        val = {"x": list(vin), "y": vy}
        out = {}
        a = obs_fine_tune(torch, seed, card, model, cfg["n_block"], data,
                          val, directory)
        out["a"] = {k: v for k, v in a.items() if k != "est"}
        batch = {"x": [x[:OBS_BATCH] for x in inputs], "y": y[:OBS_BATCH]}
        out["b"] = obs_sentinel(torch, card, a["est"], batch, directory)
        del a, model
        free_card(torch)
        out["c"] = obs_generation(torch, seed, card, gpt2_model)
        # (d) a bundle on demand holds every key of JAX's
        OrcaContext.observability_dir = directory
        path = o.flight_recorder.dump("smoke")
        check(path is not None, "phase 23 (d): no bundle was written")
        with open(path) as f:
            bundle = json.load(f)
        missing = [k for k in o.flight_recorder.BUNDLE_KEYS
                   if k not in bundle]
        check(not missing, f"phase 23 (d): the bundle lacks {missing}")
        out["d"] = dict(keys=sorted(bundle), ring=len(bundle["ring"]),
                        torch=bundle["torch"],
                        host_us_per_call=plane_costs(directory))
        print(f"phase 23 (d) [{card}] host microseconds a call: "
              f"{json.dumps(out['d']['host_us_per_call'])}", flush=True)
    finally:
        set_context(OrcaContext, **OBS_DEFAULTS)
        fresh_planes(o)
        shutil.rmtree(directory, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = out["a"]["on"]["launches"]
    out["launches_generation"] = out["c"]["runs"][0]["launches"]
    print("observability " + json.dumps(dict(
        card=card, seconds=out["seconds"],
        step_ms_planes_on=out["a"]["on"]["step_ms_mean"],
        step_ms_planes_off=out["a"]["off"]["off"]["step_ms_mean"],
        step_ms_planes_bare=out["a"]["off"]["bare"]["step_ms_mean"],
        goodput_ratio=out["a"]["on"]["goodput_ratio"],
        mfu_ratio=out["a"]["on"]["mfu_ratio"],
        tokens_per_s_log_on=out["c"]["tokens_per_s_on"],
        tokens_per_s_log_off=out["c"]["tokens_per_s_off"],
        sentinel=out["b"]["first_leaves"][:3], bundle_keys=out["d"]["keys"],
        host_us_per_call=out["d"]["host_us_per_call"])),
        flush=True)
    return out


# ----------------------------------------------------------------------
# phase 24: the serving-side observability planes over /generate
# (analytics_zoo_tpu_torch/observability/ slo, blame, exemplars,
# trace_context, timeline, history, alerts, telemetry_spool, fleet)
# ----------------------------------------------------------------------

#: (a): requests, new tokens each, prompt lengths [lo, hi)
SP_REQUESTS, SP_NEW, SP_PROMPTS = 16, 32, (32, 257)
#: (a)'s targets, which the card meets; (b)'s TTFT, which it cannot
SP_TARGETS = {"ttft_s": 30.0, "tpot_s": 5.0}
SP_SHED_TARGETS = {"ttft_s": 1e-5}
#: (b): the burst, its new tokens, the shedder's threshold and depth
SP_BURST, SP_BURST_NEW, SP_SHED_AT, SP_SHED_DEPTH = 12, 8, 0.99, 2
#: (c): the turns, armed and disarmed
SP_TURNS = ("on", "off", "off", "on")
#: the settings phase 24 writes, at their defaults
SP_DEFAULTS = dict(observability_dir=None, slo_targets=None,
                   metrics_history_interval_s=None, exemplar_count=16,
                   slo_shed_attainment=None)


def timeline_validator():
    """`validate_timeline` of scripts/check_timeline_schema.py, whose top
    level imports neither package."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "check_timeline_schema.py")
    spec = importlib.util.spec_from_file_location("timeline_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_timeline


def sp_launch_check(torch, label: str, n_block: int, n_pre: int,
                    n_dec: int) -> dict:
    """K1 25 a forward and K6 12 a decode step exactly, all `split`."""
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict({k: 0 for k in counts},
                layer_norm_fwd=(2 * n_block + 1) * (n_pre + n_dec),
                paged_decode=n_block * n_dec)
    check(counts == want, f"phase 24 {label}: launches {counts}, expected "
          f"{want} ({n_pre} prefills, {n_dec} decode steps)")
    split = paged_decode.launches_by_body["split"]
    check(split == want["paged_decode"], f"phase 24 {label}: {split} of "
          f"{want['paged_decode']} K6 launches on the split body")
    return counts


def sp_served(torch, seed: int, card: str, engine, srv, directory: str,
              validate) -> dict:
    """(a): the traced requests over HTTP with every plane armed, and
    the routes read back."""
    import threading

    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.serving import InputQueue

    model = engine.model
    rng = np.random.default_rng(seed + 24)
    prompts = [rng.integers(0, model.vocab, int(n)).tolist()
               for n in rng.integers(*SP_PROMPTS, SP_REQUESTS)]
    traces = [o.TraceContext(rng.bytes(16).hex(), rng.bytes(8).hex())
              for _ in prompts]
    tenants = ["acme" if j % 3 == 0 else None for j in range(SP_REQUESTS)]
    outs, echoed, errors = [None] * SP_REQUESTS, [None] * SP_REQUESTS, []

    def client(j):
        q = InputQueue(srv.host, srv.port, tenant=tenants[j])
        try:
            with o.trace_context.bind(traces[j]):
                outs[j] = q.generate_tokens(
                    prompts[j], max_new_tokens=SP_NEW, request_id=f"sp-{j}",
                    timeout=HTTP_TIMEOUT_S)
            echoed[j] = q.last_traceparent
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")

    pre0, dec0 = engine.n_prefills, engine.n_decode_steps
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(j,))
               for j in range(SP_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10 * HTTP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(not errors, f"phase 24 (a): client errors {errors[:1]}")
    launches = sp_launch_check(torch, "(a)", model.n_block,
                               engine.n_prefills - pre0,
                               engine.n_decode_steps - dec0)
    out = dict(wall_s=wall, tokens_per_s=SP_REQUESTS * SP_NEW / wall,
               launches=launches)
    # the SLO, blame and exemplar planes, read before any other request
    slo = json.loads(http_call(srv, "GET", "/slo")[2])
    check(slo["requests_judged"] == SP_REQUESTS
          and slo["attainment_by_tenant"].keys() == {"acme"},
          f"phase 24 (a): /slo {slo}")
    worst_gap, n_phases = 0.0, {}
    for j in range(SP_REQUESTS):
        rec = o.request_log.get(f"sp-{j}")
        check(rec is not None and rec["status"] == "finished"
              and rec["n_tokens"] == SP_NEW,
              f"phase 24 (a): record sp-{j} {rec}")
        led = o.phase_ledger(rec)
        gap = abs(sum(led["phases"].values()) - led["e2e_s"])
        check(led["additive_ok"] and gap <= max(
            led["tolerance"] * led["e2e_s"], 1e-4),
              f"phase 24 (a): sp-{j}'s phases {led['phases']} against "
              f"e2e {led['e2e_s']}")
        worst_gap = max(worst_gap, gap / max(led["e2e_s"], 1e-9))
        for p, v in led["phases"].items():
            n_phases[p] = n_phases.get(p, 0.0) + v
    blame = json.loads(http_call(srv, "GET", "/blame")[2])
    check(blame["requests_total"] == SP_REQUESTS
          and blame["additivity_violations"] == 0,
          f"phase 24 (a): /blame {json.dumps(blame)[:400]}")
    # traces: the echo, and every span a request's, in its client's trace
    spans = o.recent_spans(2048)
    for j, tc in enumerate(traces):
        check(echoed[j] is not None
              and echoed[j].split("-")[1] == tc.trace_id,
              f"phase 24 (a): sp-{j} echoed {echoed[j]} for {tc.trace_id}")
        mine = [s for s in spans
                if (s["attrs"] or {}).get("request_id") == f"sp-{j}"]
        check(mine and all(s["trace_id"] == tc.trace_id for s in mine)
              and any(s["parent_id"] == tc.span_id for s in mine),
              f"phase 24 (a): sp-{j}'s spans {mine}")
    # the routes
    docs = {}
    for path in ("/timeline", "/timeline?fleet=1"):
        code, _, body = http_call(srv, "GET", path)
        docs[path] = json.loads(body)
        problems = validate(docs[path])
        check(code == 200 and not problems,
              f"phase 24 (a): GET {path}: {code} {problems[:3]}")
    index = json.loads(http_call(srv, "GET", "/debug/requests")[2])
    check(index["count"] >= 1, f"phase 24 (a): /debug/requests {index}")
    rid = index["exemplars"][0]["request_id"]
    code, _, body = http_call(srv, "GET", f"/debug/requests/{rid}")
    dossier = json.loads(body)
    check(code == 200 and dossier["ledger"]["request_id"] == rid
          and dossier["record"]["request_id"] == rid,
          f"phase 24 (a): /debug/requests/{rid} {code}")
    code, _, body = http_call(
        srv, "GET", "/metrics/history?derive=rate&family="
                    "generation_tokens_total")
    hist = json.loads(body)
    rate = hist["series"].get("generation_tokens_total", [])
    check(code == 200 and len(rate) >= 2,
          f"phase 24 (a): /metrics/history rate points {rate}")
    # a dead worker's snapshot: this loop's spool, as another pid's
    snap_path = os.path.join(directory, "telemetry", "engine",
                             "snapshot.json")
    with open(snap_path) as f:
        snap = json.load(f)
    snap["pid"], snap["proc"] = -1, "worker-1"
    os.makedirs(os.path.join(directory, "telemetry", "worker-1"))
    with open(os.path.join(directory, "telemetry", "worker-1",
                           "snapshot.json"), "w") as f:
        json.dump(snap, f)
    spooled = o.parse_prometheus_text(snap["exposition"])[
        "generation_tokens_total"]["value"]
    local = o.parse_prometheus_text(http_call(srv, "GET", "/metrics")[
        2].decode())["generation_tokens_total"]["value"]
    fleet = o.parse_prometheus_text(http_call(
        srv, "GET", "/metrics?fleet=1")[2].decode())
    check(fleet["generation_tokens_total"]["value"] == local + spooled,
          f"phase 24 (a): fleet tokens {fleet['generation_tokens_total']} "
          f"!= local {local} + spooled {spooled}")
    dispatch = json.loads(http_call(srv, "GET", "/dispatch")[2])
    decode = dispatch["families"]["decode"]
    check(decode["signatures"] == 1, f"phase 24 (a): decode ledger {decode}")
    stats = json.loads(http_call(srv, "GET", "/stats")[2])
    check({"requests", "blame", "fleet"} <= stats.keys(),
          f"phase 24 (a): /stats blocks {sorted(stats)}")
    # the streams against the engine's own greedy streams
    streams = [engine.submit(p, max_new_tokens=SP_NEW) for p in prompts]
    want = [s.tokens() for s in streams]
    check(outs == want, "phase 24 (a): a served stream differs from the "
          "engine's greedy stream of its prompt")
    by_cat = {}
    for e in docs["/timeline"]["traceEvents"]:
        by_cat[e.get("cat", e["ph"])] = by_cat.get(e.get("cat", e["ph"]),
                                                    0) + 1
    out.update(slo_attainment=slo["attainment"],
               blame_dominant_tail_phase=blame["dominant_tail_phase"],
               blame_share={p: blame["rollup"][p]["share"]
                            for p in blame["rollup"]},
               phase_seconds_sum=n_phases, worst_additivity_gap=worst_gap,
               exemplars=index["count"], history_rate_points=len(rate),
               history_samples=hist["n_samples"],
               fleet_tokens=fleet["generation_tokens_total"]["value"],
               timeline_events_by_cat=by_cat,
               fleet_timeline_events=len(
                   docs["/timeline?fleet=1"]["traceEvents"]))
    print(f"phase 24 (a) [{card}] {SP_REQUESTS} traced requests x {SP_NEW} "
          f"tokens over /generate, every plane armed: "
          f"{out['tokens_per_s']:.1f} tokens/s, SLO attainment "
          f"{slo['attainment']}, blame shares {out['blame_share']}, worst "
          f"additivity gap {worst_gap:.2e}, {index['count']} exemplars, "
          f"{len(rate)} rate points, timeline events {by_cat}", flush=True)
    return out


def sp_burst(srv, headers_for):
    """SP_BURST concurrent /generate calls, started: their answers'
    list, (status, headers, body) each as they come, and the threads."""
    import threading
    got = [None] * SP_BURST

    def call(j):
        got[j] = http_call(srv, "POST", "/generate", {
            "tokens": [1 + j, 2, 3], "max_new_tokens": SP_BURST_NEW},
            headers_for(j))
    threads = [threading.Thread(target=call, args=(j,))
               for j in range(SP_BURST)]
    for t in threads:
        t.start()
    return got, threads


def sp_shed(engine, srv, card: str) -> dict:
    """(b): the SLO shedder over HTTP, armed then disarmed."""
    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext

    OrcaContext.slo_targets = SP_SHED_TARGETS
    o.reset_slo_tracker()
    # one judged request misses the target: attainment 0
    engine.generate([5, 6, 7], max_new_tokens=2)
    att = o.get_slo_tracker().attainment()
    check(att == 0.0, f"phase 24 (b): attainment {att} after a miss")
    engine.slo_shed_min_queue = SP_SHED_DEPTH
    out = {}
    for mode in ("armed", "disarmed"):
        OrcaContext.slo_shed_attainment = (SP_SHED_AT if mode == "armed"
                                           else None)
        tps = [f"00-{os.urandom(16).hex()}-{os.urandom(8).hex()}-01"
               for _ in range(SP_BURST)]
        # the loop stopped while the burst arrives: the queue holds it
        engine.stop()
        got, threads = sp_burst(srv, lambda j: {
            "X-Request-Id": f"{mode}-{j}", "traceparent": tps[j]})
        deadline = time.perf_counter() + HTTP_TIMEOUT_S
        while time.perf_counter() < deadline:
            done = sum(g is not None for g in got)
            if done + len(engine.scheduler.waiting) >= SP_BURST:
                break
            time.sleep(0.01)
        engine.ensure_started()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        shed = [(j, g) for j, g in enumerate(got) if g[0] == 503]
        ok = [g for g in got if g[0] == 200]
        check(len(shed) + len(ok) == SP_BURST,
              f"phase 24 (b) {mode}: statuses {[g[0] for g in got]}")
        if mode == "armed":
            check(len(shed) >= 1, "phase 24 (b): no request was shed")
            for j, (_code, headers, body) in shed:
                msg = json.loads(body)
                check(msg["error"].startswith("shedding under SLO pressure")
                      and float(headers["Retry-After"]) > 0
                      and msg["retry_after_s"] > 0
                      and headers["traceparent"] == tps[j],
                      f"phase 24 (b): shed answer {msg} {dict(headers)}")
            out["shed_message"] = json.loads(shed[0][1][2])["error"]
            out["retry_after_s"] = [float(g[1]["Retry-After"])
                                    for _, g in shed]
        else:
            check(not shed, f"phase 24 (b): {len(shed)} sheds disarmed")
        out[f"{mode}_503"] = len(shed)
        out[f"{mode}_200"] = len(ok)
    print(f"phase 24 (b) [{card}] SLO shedder, a burst of {SP_BURST} at "
          f"slo_shed_min_queue {SP_SHED_DEPTH}: {json.dumps(out)}",
          flush=True)
    return out


def sp_cost(torch, seed: int, card: str, engine, directory: str) -> dict:
    """(c): tokens/s with the planes armed and disarmed in turns, and the
    host cost of a recorder sample, a spool write and a timeline
    export."""
    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.observability import history
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.utils.tfrecord import crc32c

    model = engine.model
    rng = np.random.default_rng(seed + 240)
    prompts = [rng.integers(0, model.vocab, int(n)).tolist()
               for n in rng.integers(*SP_PROMPTS, SP_REQUESTS)]
    runs, streams_by_turn = [], []
    for turn, mode in enumerate(SP_TURNS):
        armed = mode == "on"
        # a recorder keeps the cadence it was made with: dropped at each
        # turn, so a disarmed turn has none
        o.reset_recorder()
        set_context(OrcaContext,
                    slo_targets=SP_TARGETS if armed else None,
                    metrics_history_interval_s=0.25 if armed else None,
                    observability_dir=directory if armed else None,
                    exemplar_count=16 if armed else 0)
        pre, dec = engine.n_prefills, engine.n_decode_steps
        kernels.reset_launch_counts()
        engine.stop()
        t0 = time.perf_counter()
        streams = [engine.submit(p, max_new_tokens=SP_NEW,
                                 request_id=f"c{turn}-{i}")
                   for i, p in enumerate(prompts)]
        engine.ensure_started()
        outs = [s.tokens() for s in streams]
        wall = time.perf_counter() - t0
        counts = sp_launch_check(torch, f"(c) {mode}", model.n_block,
                                 engine.n_prefills - pre,
                                 engine.n_decode_steps - dec)
        streams_by_turn.append(outs)
        runs.append(dict(mode=mode, wall_s=wall,
                         tokens_per_s=SP_REQUESTS * SP_NEW / wall,
                         launches=counts))
    check(all(s == streams_by_turn[0] for s in streams_by_turn),
          "phase 24 (c): the streams differ with the planes on and off")
    # host costs, the planes armed
    set_context(OrcaContext, slo_targets=SP_TARGETS,
                metrics_history_interval_s=0.25,
                observability_dir=directory, exemplar_count=16)
    rec = history.get_recorder(registries=(engine.registry,))
    walls, sizes, crcs = [], [], []
    for _ in range(50):
        t0 = time.perf_counter()
        doc = rec.sample()
        walls.append(time.perf_counter() - t0)
        payload = history._encode_sample(doc)
        sizes.append(len(payload))
        t0 = time.perf_counter()
        crc32c(payload)
        crcs.append(time.perf_counter() - t0)
    # the alert engine's pass once the ring is full: the ring's samples
    # repeated at the cadence, RING_SIZE of them
    ring = rec.tail()
    full = [dict(s, ts=ring[0]["ts"] + 0.25 * k, seq=k + 1)
            for k, s in zip(range(history.RING_SIZE),
                            itertools.cycle(ring))]
    t0 = time.perf_counter()
    rec.alerts.evaluate(full)
    full_ring_ms = (time.perf_counter() - t0) * 1e3
    spool = o.telemetry_spool.get_spool(engine.spool_name,
                                        (engine.registry,))
    spool_walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        check(spool.write(), "phase 24 (c): a spool write failed")
        spool_walls.append(time.perf_counter() - t0)
    export_walls, export_bytes = [], 0
    for _ in range(5):
        t0 = time.perf_counter()
        blob = o.timeline.timeline_json()
        export_walls.append(time.perf_counter() - t0)
        export_bytes = len(blob)
    out = dict(
        runs=runs,
        tokens_per_s_on=statistics.median(
            r["tokens_per_s"] for r in runs if r["mode"] == "on"),
        tokens_per_s_off=statistics.median(
            r["tokens_per_s"] for r in runs if r["mode"] == "off"),
        sample_us=statistics.median(walls) * 1e6,
        sample_bytes=statistics.median(sizes),
        sample_crc_us=statistics.median(crcs) * 1e6,
        ring_samples=len(ring), alert_pass_full_ring_ms=full_ring_ms,
        spool_write_us=statistics.median(spool_walls) * 1e6,
        spool_bytes=os.path.getsize(spool.path),
        timeline_export_ms=statistics.median(export_walls) * 1e3,
        timeline_bytes=export_bytes)
    print(f"phase 24 (c) [{card}] {SP_REQUESTS} requests x {SP_NEW} tokens, "
          f"the planes {SP_TURNS}: tokens/s "
          f"{[round(r['tokens_per_s'], 1) for r in runs]}, median armed "
          f"{out['tokens_per_s_on']:.1f}, disarmed "
          f"{out['tokens_per_s_off']:.1f}; a history sample "
          f"{out['sample_us']:.1f} us and {out['sample_bytes']} bytes (its "
          f"CRC32C {out['sample_crc_us']:.1f} us; {len(ring)} samples in "
          f"the ring), the alert pass over a full ring of "
          f"{history.RING_SIZE} {full_ring_ms:.1f} ms, a spool write "
          f"{out['spool_write_us']:.1f} us ({out['spool_bytes']} bytes), a "
          f"timeline export {out['timeline_export_ms']:.2f} ms "
          f"({export_bytes} bytes)", flush=True)
    return out


def phase_serving_planes(torch, seed: int, card: str, gpt2_model) -> dict:
    """Phase 24: the serving-side observability planes on phase 6's model
    behind ServingServer, parts (a)-(d)."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.serving import ServingServer
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine

    t0 = time.perf_counter()
    validate = timeline_validator()
    directory = tempfile.mkdtemp(prefix="phase24-")
    fresh_planes(o)
    set_context(OrcaContext, observability_dir=directory,
                slo_targets=SP_TARGETS, metrics_history_interval_s=0.25)
    engine = GenerationEngine(gpt2_model, max_slots=8, block_size=16,
                              max_context=1024, device="cuda")
    engine.warmup()
    srv = ServingServer(generation_engine=engine).start()
    out = {}
    try:
        out["a"] = sp_served(torch, seed, card, engine, srv, directory,
                             validate)
        out["b"] = sp_shed(engine, srv, card)
        engine.slo_shed_min_queue = engine.max_slots
        out["c"] = sp_cost(torch, seed, card, engine, directory)
        # (d) a bundle on demand, the planes armed
        path = o.flight_recorder.dump("smoke")
        check(path is not None, "phase 24 (d): no bundle was written")
        with open(path) as f:
            bundle = json.load(f)
        with open(bundle["timeline_path"] or "") as f:
            problems = validate(json.load(f))
        check(bundle["history_tail"] and bundle["exemplars"]
              and not problems,
              f"phase 24 (d): history tail {len(bundle['history_tail'])}, "
              f"exemplars {len(bundle['exemplars'])}, timeline {problems[:3]}")
        out["d"] = dict(history_tail=len(bundle["history_tail"]),
                        exemplars=len(bundle["exemplars"]),
                        alerts_active=sorted(bundle["alerts_active"]),
                        timeline_bytes=os.path.getsize(
                            bundle["timeline_path"]))
        print(f"phase 24 (d) [{card}] bundle: {json.dumps(out['d'])}",
              flush=True)
    finally:
        srv.stop()
        set_context(OrcaContext, **SP_DEFAULTS)
        fresh_planes(o)
        shutil.rmtree(directory, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = out["a"]["launches"]
    print("serving_planes " + json.dumps(dict(
        card=card, seconds=out["seconds"],
        tokens_per_s_served=out["a"]["tokens_per_s"],
        tokens_per_s_planes_on=out["c"]["tokens_per_s_on"],
        tokens_per_s_planes_off=out["c"]["tokens_per_s_off"],
        sample_us=out["c"]["sample_us"],
        sample_bytes=out["c"]["sample_bytes"],
        sample_crc_us=out["c"]["sample_crc_us"],
        alert_pass_full_ring_ms=out["c"]["alert_pass_full_ring_ms"],
        spool_write_us=out["c"]["spool_write_us"],
        timeline_export_ms=out["c"]["timeline_export_ms"],
        timeline_bytes=out["c"]["timeline_bytes"],
        shed_503=out["b"]["armed_503"],
        blame_share=out["a"]["blame_share"])), flush=True)
    return out


# ----------------------------------------------------------------------
# phase 25: serving scale-out and the durable data plane (native CRC32C,
# the worker pool, the replica router, durable streams with consumers,
# the control plane, the gRPC front end)
# ----------------------------------------------------------------------

#: (a): random bytes of the CRC comparison, TFRecord records, CSV shape
SC_CRC_BYTES, SC_RECORDS, SC_CSV = 1 << 20, 64, (2000, 16)
#: (b): client threads x pre-batched requests of rows x t tokens; the
#: served logits against the in-process model (phase 7's bf16 bound),
#: and the rows of the batch a worker is killed under
WP_CLIENTS, WP_REQS, WP_ROWS, WP_T = 8, 6, 8, 128
WP_TOL = 0.05
WP_KILL_ROWS, WP_KILL_T = 256, 512
#: (c): requests x new tokens over /generate, prompt lengths [lo, hi),
#: bench.py's served-skew bound between two replicas
RT_REQUESTS, RT_NEW, RT_PROMPTS = 32, 32, (16, 129)
RT_SKEW = 0.3
#: (d): records through each stream, new tokens a generation record,
#: the lease a killed consumer's records wait out, the full stream's bound
ST_PREDICT, ST_GENERATE, ST_NEW, ST_VISIBILITY_S = 24, 8, 16, 2.0
ST_BACKLOG = 32
#: (e): A/B draws and weights, the shadow fraction and requests, the
#: open loop's seconds, SLO and new tokens, the free tenant's quota as a
#: share of its offered rate
CP_AB_DRAWS, CP_AB = 400, {"v1": 0.8, "v2": 0.2}
CP_SHADOW, CP_SHADOW_REQS = 0.25, 40
CP_LOAD_CLIENTS, CP_LOAD_REQS, CP_NEW = 8, 3, 16
CP_LOOP_S, CP_SLO_S, CP_FREE_SHARE = 6.0, 30.0, 0.2
#: (f): AnomalyDetector windows (the gRPC wire carries f32 tensors)
GR_ROWS, GR_UNROLL = 64, 24
GR_TOL = 1e-6


def sc_native(seed: int, card: str) -> dict:
    """(a): the native library against its plain versions."""
    import io

    from analytics_zoo_tpu_torch import native
    from analytics_zoo_tpu_torch.utils import tfrecord

    t0 = time.perf_counter()
    check(native.available(), "phase 25 (a): the native library did not "
          "build or load (g++ on this machine?)")
    load_s = time.perf_counter() - t0
    check(native.crc32c(b"123456789") == 0xE3069283,
          "phase 25 (a): crc32c(b'123456789') != 0xE3069283")
    rng = np.random.default_rng(seed + 250)
    blob = rng.integers(0, 256, SC_CRC_BYTES, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    got = native.crc32c(blob)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = tfrecord.py_crc32c(blob)
    plain_s = time.perf_counter() - t0
    check(got == want, f"phase 25 (a): crc32c of 1 MiB {got:#x} != the "
          f"table's {want:#x}")
    buf = io.BytesIO()
    for n in rng.integers(0, 4096, SC_RECORDS):
        tfrecord.write_record(buf, rng.integers(0, 256, int(n),
                                                dtype=np.uint8).tobytes())
    scan = native.tfrecord_scan(buf.getvalue())
    check(scan == native.py_tfrecord_scan(buf.getvalue())
          and len(scan) == SC_RECORDS,
          "phase 25 (a): tfrecord_scan differs from its plain version")
    vals = rng.standard_normal(SC_CSV).astype(np.float32)
    text = "\n".join(",".join(repr(float(v)) for v in row)
                     for row in vals).encode()
    csv = native.csv_to_f32(text, SC_CSV[1])
    check(np.array_equal(csv, native.py_csv_to_f32(text, SC_CSV[1]))
          and np.array_equal(csv, vals),
          "phase 25 (a): csv_to_f32 differs from its plain version")
    out = dict(available=True, library=native.library_path().name,
               load_s=load_s, crc_1mib_native_ms=native_s * 1e3,
               crc_1mib_plain_ms=plain_s * 1e3, tfrecord_records=len(scan),
               csv_rows=len(csv))
    print(f"phase 25 (a) [{card}] native library {out['library']} (built "
          f"or loaded in {load_s:.2f} s): crc32c of 1 MiB "
          f"{native_s * 1e3:.3f} ms native, {plain_s * 1e3:.1f} ms plain; "
          f"tfrecord_scan of {len(scan)} records and csv_to_f32 of "
          f"{SC_CSV} equal their plain versions", flush=True)
    return out


def sc_history_crc(card: str, registries) -> dict:
    """(a): CRC32C of a metrics-history sample of the router's replicas,
    through the native path (what `utils.tfrecord.crc32c` now takes) and
    the plain table (what it took before)."""
    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.observability import history
    from analytics_zoo_tpu_torch.utils import tfrecord

    o.reset_recorder()
    set_context(OrcaContext, metrics_history_interval_s=0.25)
    try:
        rec = history.get_recorder(registries=registries)
        native_us, plain_us, sizes = [], [], []
        for _ in range(50):
            payload = history._encode_sample(rec.sample())
            sizes.append(len(payload))
            t0 = time.perf_counter()
            a = tfrecord.crc32c(payload)
            native_us.append((time.perf_counter() - t0) * 1e6)
            t0 = time.perf_counter()
            b = tfrecord.py_crc32c(payload)
            plain_us.append((time.perf_counter() - t0) * 1e6)
            check(a == b, "phase 25 (a): a history sample's CRC differs")
    finally:
        set_context(OrcaContext, metrics_history_interval_s=None)
        o.reset_recorder()
    out = dict(sample_bytes=statistics.median(sizes),
               sample_crc_us_native=statistics.median(native_us),
               sample_crc_us_plain=statistics.median(plain_us))
    print(f"phase 25 (a) [{card}] a metrics-history sample of "
          f"{out['sample_bytes']} bytes: CRC32C "
          f"{out['sample_crc_us_native']:.1f} us native, "
          f"{out['sample_crc_us_plain']:.1f} us through the plain table",
          flush=True)
    return out


def save_bert(torch, model, path: str, encrypt_key=None) -> str:
    """`ZooModel.save_model`'s format (`write_model`) for phase 7's
    BERTClassifier: its weights, encrypted at rest with `encrypt_key`,
    and constructor fields, resolved by class name at load."""
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE
    from analytics_zoo_tpu_torch.models.common.zoo_model import write_model
    return write_model(path, model.state_dict(), "BERTClassifier",
                       dict(BERT_BASE, num_classes=2, attn_impl="flash"),
                       encrypt_key)


def compute_apps() -> dict:
    """{pid: used MiB} of the card's compute processes, as nvidia-smi
    lists them (its pids are the host's where the container has a pid
    namespace of its own)."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    out = {}
    for line in lines:
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            out[int(pid)] = float(mem.strip() or 0)
    return out


def wp_traffic(torch, srv, rng, vocab: int) -> dict:
    """WP_CLIENTS threads x WP_REQS pre-batched requests over /predict;
    (wall, latencies, the requests with their served logits)."""
    import threading

    from analytics_zoo_tpu_torch.serving import InputQueue

    plans = [[bert_request(rng, WP_ROWS, WP_T, vocab)[0]
              for _ in range(WP_REQS)] for _ in range(WP_CLIENTS)]
    done, lat, errors = [], [], []
    lock = threading.Lock()

    def client(plan):
        q = InputQueue(srv.host, srv.port)
        for inputs in plan:
            t0 = time.perf_counter()
            try:
                out = q.predict(*inputs, batched=True)
            except Exception as e:
                errors.append(f"{type(e).__name__}: {e}")
                return
            with lock:
                lat.append(time.perf_counter() - t0)
                done.append((inputs, out))

    threads = [threading.Thread(target=client, args=(p,)) for p in plans]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10 * HTTP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(not errors, f"phase 25 (b): client errors {errors[:1]}")
    n = WP_CLIENTS * WP_REQS
    return dict(wall_s=wall, sequences_per_s=n * WP_ROWS / wall,
                latency_ms_p50=float(np.percentile(lat, 50)) * 1e3,
                latency_ms_p99=float(np.percentile(lat, 99)) * 1e3,
                requests=n, done=done)


def wp_gate(torch, im, done, label: str) -> float:
    """Served logits against the in-process model's on the same rows."""
    worst = 0.0
    for inputs, out in done:
        want = im.predict(*inputs)
        worst = max(worst, float(np.abs(np.asarray(out, np.float32)
                                        - want).max()))
    check(worst <= WP_TOL, f"phase 25 (b) {label}: served logits differ "
          f"from the in-process model's by {worst} > {WP_TOL}")
    return worst


def sc_worker_pool(torch, seed: int, card: str, bert_model, directory: str
                   ) -> tuple:
    """(b): phase 7's BERT-base classifier saved and served from worker
    processes on the card, behind ServingServer over /predict."""
    import signal
    import threading

    from analytics_zoo_tpu_torch.serving import (
        InferenceModel,
        ServingServer,
        WorkerPool,
    )
    from analytics_zoo_tpu_torch.serving.errors import ReplicaDiedMidPredict

    vocab = bert_model.bert.token_embed.num_embeddings
    path = save_bert(torch, bert_model, os.path.join(directory, "bert"))
    im = InferenceModel(supported_concurrent_num=4,
                        max_batch_size=WP_KILL_ROWS).load_module(bert_model)
    t0 = time.perf_counter()
    pools = {}

    def spawn(n):
        pools[n] = WorkerPool(path, n_workers=n)

    spawners = [threading.Thread(target=spawn, args=(n,)) for n in (1, 2)]
    for t in spawners:
        t.start()
    for t in spawners:
        t.join()
    check(set(pools) == {1, 2}, "phase 25 (b): a worker pool did not start")
    spawn_s = time.perf_counter() - t0
    out = dict(spawn_s=spawn_s, runs={})
    try:
        rng = np.random.default_rng(seed + 251)
        for n in (1, 2):
            pool = pools[n]
            srv = ServingServer(worker_pool=pool, max_batch_size=32,
                                batch_timeout_ms=2.0).start()
            try:
                # warm: each worker's first forward builds the Triton
                # LayerNorm (from the shared cache after the first)
                wp_traffic(torch, srv, np.random.default_rng(seed), vocab)
                pool.reset_launch_counts()
                b0 = srv._batches_run
                run = wp_traffic(torch, srv, rng, vocab)
                batches = srv._batches_run - b0
                reports = pool.launch_counts()
                stats = json.loads(http_call(srv, "GET", "/stats")[2])
            finally:
                srv.stop()
            run["max_abs_err"] = wp_gate(torch, im, run.pop("done"),
                                         f"{n} workers")
            forwards = []
            for r in reports:
                c = r["counts"]
                f = c["fused_dense_gelu"] // 12
                check(f >= 1 and c == dict(
                    {k: 0 for k in c}, layer_norm_fwd=25 * f,
                    fused_dense_gelu=12 * f, flash_fwd=12 * f),
                    f"phase 25 (b): worker {r['pid']} launches {c}, "
                    "expected K1 25, K2 12 and K3 12 a forward")
                check(r["device"].startswith("cuda")
                      and r["allocated_bytes"] > 0,
                      f"phase 25 (b): worker {r['pid']} runs on "
                      f"{r['device']} with {r['allocated_bytes']} bytes")
                forwards.append(f)
            check(sum(forwards) == batches, f"phase 25 (b): {forwards} "
                  f"worker forwards for {batches} batches")
            check(stats["replicas"] == n
                  and stats["worker_pool"]["n_workers"] == n,
                  f"phase 25 (b): /stats {stats.get('worker_pool')}")
            run.update(batches=batches, forwards_by_worker=forwards,
                       launches_by_worker=[r["counts"] for r in reports],
                       worker_bytes=[r["allocated_bytes"] for r in reports])
            out["runs"][n] = run
            print(f"phase 25 (b) [{card}] BERT-base over /predict from {n} "
                  f"worker process(es): {run['requests']} requests of "
                  f"{WP_ROWS} x {WP_T} = {run['sequences_per_s']:.1f} "
                  f"sequences/s, p50 {run['latency_ms_p50']:.1f} ms, p99 "
                  f"{run['latency_ms_p99']:.1f} ms; {batches} batches, "
                  f"forwards by worker {forwards}, launches by worker "
                  f"{run['launches_by_worker']}; logits max abs err "
                  f"{run['max_abs_err']:.3e} (tol {WP_TOL})", flush=True)
        pool = pools[2]
        # each worker holds a CUDA context of its own
        apps = compute_apps()
        pids = pool.pids()
        listed = [p for p in pids if p in apps]
        out["compute_apps"] = {str(p): apps[p] for p in listed}
        out["context_evidence"] = ("nvidia-smi" if len(listed) == len(pids)
                                   else "worker-reported")
        print(f"phase 25 (b) [{card}] worker pids {pids}; nvidia-smi "
              f"compute apps {apps} (MiB); each worker's context shown by "
              f"{out['context_evidence']}", flush=True)
        # a worker killed under its batch: that batch alone fails
        kill_inputs = bert_request(rng, WP_KILL_ROWS, WP_KILL_T, vocab)[0]
        results = [None, None]

        def call(k):
            try:
                results[k] = ("ok", pool.predict(*kill_inputs))
            except ReplicaDiedMidPredict as e:
                results[k] = ("died", str(e))

        threads = [threading.Thread(target=call, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        while pool.busy_workers < 2:
            check(time.perf_counter() - t0 < 60,
                  "phase 25 (b): the two batches never ran together")
            time.sleep(0.001)
        victim = pids[0]
        os.kill(victim, signal.SIGKILL)
        for t in threads:
            t.join(timeout=300)
        kinds = sorted(r[0] for r in results)
        check(kinds == ["died", "ok"], f"phase 25 (b): killing worker "
              f"{victim} under its batch gave {kinds}")
        ok = next(r[1] for r in results if r[0] == "ok")
        err = float(np.abs(ok - im.predict(*kill_inputs)).max())
        check(err <= WP_TOL, f"phase 25 (b): the surviving batch's "
              f"logits are {err} off")
        check(victim not in pool.pids() and len(pool.pids()) == 2,
              f"phase 25 (b): the pool did not respawn: {pool.pids()}")
        after = pool.predict(*bert_request(rng, WP_ROWS, WP_T, vocab)[0])
        check(after.shape == (WP_ROWS, 2), "phase 25 (b): no service "
              "after the respawn")
        out["kill"] = dict(victim=victim, outcomes=kinds,
                           survivor_max_abs_err=err,
                           respawned_pid=pool.pids()[0])
        print(f"phase 25 (b) [{card}] worker {victim} killed under a "
              f"{WP_KILL_ROWS} x {WP_KILL_T} batch: {kinds}, respawned as "
              f"{pool.pids()[0]}, serving on", flush=True)
    except BaseException:
        for p in pools.values():
            p.stop()
        raise
    pools[1].stop()
    launches = {}
    for r in out["runs"][2]["launches_by_worker"]:
        for k, v in r.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out, pools[2], im


def rt_engines(torch, model, n: int, **geom):
    from analytics_zoo_tpu_torch.observability.registry import (
        MetricsRegistry,
    )
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine
    geom = dict(dict(max_slots=8, block_size=16, max_context=1024), **geom)
    engines = [GenerationEngine(model, registry=MetricsRegistry(),
                                device="cuda", **geom) for _ in range(n)]
    for e in engines:
        e.warmup()
    return engines


def rt_served(srv, prompts, new: int, headers_for=None) -> tuple:
    """Every prompt over /generate from its own client thread: (wall,
    the streams, the served model of each)."""
    import threading

    from analytics_zoo_tpu_torch.serving import InputQueue

    outs, models, errors = [None] * len(prompts), [None] * len(prompts), []

    def client(j):
        q = InputQueue(srv.host, srv.port,
                       **(headers_for(j) if headers_for else {}))
        try:
            outs[j] = q.generate_tokens(prompts[j], max_new_tokens=new,
                                        timeout=HTTP_TIMEOUT_S)
            models[j] = q.last_model
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(j,))
               for j in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10 * HTTP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(not errors, f"phase 25: client errors {errors[:1]}")
    return wall, outs, models


def sc_router(torch, seed: int, card: str, gpt2_model) -> dict:
    """(c): two GPT-2 small engines behind ReplicaRouter over /generate."""
    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    from analytics_zoo_tpu_torch.serving import ServingServer
    from analytics_zoo_tpu_torch.serving.distributed import ReplicaRouter
    from analytics_zoo_tpu_torch.serving.errors import QueueFull

    model = gpt2_model
    rng = np.random.default_rng(seed + 252)
    prompts = [rng.integers(0, model.vocab, int(n)).tolist()
               for n in rng.integers(*RT_PROMPTS, RT_REQUESTS)]
    single, = rt_engines(torch, model, 1)
    streams = [single.submit(p, max_new_tokens=RT_NEW) for p in prompts]
    single.run_until_idle()
    want = [s.tokens() for s in streams]
    set_context(OrcaContext, slo_targets=SP_TARGETS)
    out = {}
    # one replica
    srv = ServingServer(router=ReplicaRouter([single])).start()
    try:
        wall1, outs, _ = rt_served(srv, prompts, RT_NEW)
    finally:
        srv.stop()
    check(outs == want, "phase 25 (c): a stream through a one-replica "
          "router differs from the engine's")
    # two replicas
    engines = rt_engines(torch, model, 2)
    router = ReplicaRouter(engines)
    srv = ServingServer(router=router).start()
    try:
        pre = [(e.n_prefills, e.n_decode_steps) for e in engines]
        kernels.reset_launch_counts()
        wall2, outs, _ = rt_served(srv, prompts, RT_NEW)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        split = paged_decode.launches_by_body["split"]
        steps = [(e.n_prefills - p, e.n_decode_steps - d)
                 for e, (p, d) in zip(engines, pre)]
        check(outs == want, "phase 25 (c): a routed stream differs from "
              "one engine's greedy stream")
        n_block = model.n_block
        want_counts = dict({k: 0 for k in counts},
                           layer_norm_fwd=sum((2 * n_block + 1) * (a + b)
                                              for a, b in steps),
                           paged_decode=sum(n_block * b for _, b in steps))
        check(counts == want_counts and split == counts["paged_decode"]
              and all(b > 0 for _, b in steps),
              f"phase 25 (c): launches {counts} ({split} split) for "
              f"(prefills, decode steps) {steps} by replica, expected "
              f"{want_counts}")
        served = [r.served for r in router.replicas]
        skew = abs(served[0] - served[1]) / max(1, sum(served))
        check(skew <= RT_SKEW, f"phase 25 (c): served {served}, skew "
              f"{skew:.2f} > {RT_SKEW}")
        # the three engines of one geometry (each replica and the one
        # that gave the reference streams) share one decode signature
        decode = o.ledger_snapshot()["families"]["decode"]
        check(decode["signatures"] == 1,
              f"phase 25 (c): decode ledger {decode}")
        stats = json.loads(http_call(srv, "GET", "/stats")[2])
        text = http_call(srv, "GET", "/metrics")[2].decode()
        check(stats["replicas"] == 2 and all(
            f'generation_requests_total{{replica="{r.name}"}}' in text
            for r in router.replicas)
            and set(stats["fleet"].get("replicas", {})) == {
                r.name for r in router.replicas},
            f"phase 25 (c): /stats replicas {stats['replicas']}, fleet "
            f"rows {stats['fleet'].get('replicas')}")
        out["history_crc"] = sc_history_crc(
            card, tuple(r.engine.registry for r in router.replicas))
        # a fully drained router sheds, with a comeback hint
        router.drain()
        code, headers, _ = http_call(srv, "POST", "/generate",
                                     {"tokens": prompts[0]})
        try:
            router.submit(prompts[0], max_new_tokens=2)
            shed = None
        except QueueFull as e:
            shed = e.retry_after_s
        router.undrain()
        check(code == 503 and float(headers["Retry-After"]) > 0
              and shed is not None and shed > 0,
              f"phase 25 (c): a drained router answered {code}, "
              f"retry_after_s {shed}")
    finally:
        srv.stop()
        set_context(OrcaContext, slo_targets=None)
    # a replica stopped mid-stream: the request re-queued under its id
    small = rt_engines(torch, model, 2, max_slots=2, max_context=256)
    router = ReplicaRouter(small)
    try:
        rs = router.submit(prompts[0], max_new_tokens=RT_NEW,
                           request_id="requeue-0")
        victim = next(r for r in router.replicas
                      if r.name == rs.replica_name)
        survivor = next(r for r in router.replicas if r is not victim)
        for _ in range(4):
            victim.engine.step()
        victim.engine.stop()
        survivor.engine.ensure_started()
        got = list(rs)
    finally:
        router.stop()
    check(got == want[0] and rs.request_id == "requeue-0"
          and rs.replica_name == survivor.name
          and router.stats()["requeues"] == 1,
          f"phase 25 (c): the re-queued stream (on {rs.replica_name}, id "
          f"{rs.request_id}) differs from the single engine's")
    out.update(tokens_per_s_1=RT_REQUESTS * RT_NEW / wall1,
               tokens_per_s_2=RT_REQUESTS * RT_NEW / wall2,
               served=served, skew=skew, steps_by_replica=steps,
               launches=counts, drained_retry_after_s=shed,
               requeued_to=rs.replica_name)
    print(f"phase 25 (c) [{card}] {RT_REQUESTS} requests x {RT_NEW} tokens "
          f"over /generate: {out['tokens_per_s_1']:.1f} tokens/s with 1 "
          f"replica, {out['tokens_per_s_2']:.1f} with 2 (one card: no "
          f"scale gate); served {served} (skew {skew:.3f}); launches "
          f"{counts}; streams equal one engine's; drained: 503, "
          f"retry_after_s {shed:.3f}; a replica stopped mid-stream "
          f"re-queued the request to {rs.replica_name} under its id",
          flush=True)
    return out


class GatedCall:
    """Calls `fn`; the `park_at`-th call waits for `release` first (set
    `parked` when it does), so a test can kill its caller while it holds
    leased records."""

    def __init__(self, fn, park_at: int):
        import threading
        self.fn, self.park_at, self.calls = fn, park_at, 0
        self.parked, self.release = threading.Event(), threading.Event()

    def __call__(self, *args, **kw):
        self.calls += 1
        if self.calls == self.park_at:
            self.parked.set()
            self.release.wait(60)
        return self.fn(*args, **kw)


def wait_for(cond, what: str, timeout: float = 120.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"phase 25: {what}")
        time.sleep(0.01)


def sc_streams(torch, seed: int, card: str, pool, im, vocab: int,
               gpt2_model, directory: str) -> dict:
    """(d): records through enqueue(stream=) drained by predict_consumer
    (the worker pool) and generation_consumer (an engine), each consumer
    killed mid-backlog; a full backlog's 429; a torn fsync's recovery."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.observability import get_registry
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.resilience.faults import SimulatedCrash
    from analytics_zoo_tpu_torch.serving import InputQueue, ServingServer
    from analytics_zoo_tpu_torch.serving.streaming import (
        DurableStream,
        StreamHub,
        generation_consumer,
        predict_consumer,
    )
    from analytics_zoo_tpu_torch.serving.streaming.log import encode_frame

    rng = np.random.default_rng(seed + 253)
    hub = StreamHub(os.path.join(directory, "hub"),
                    visibility_timeout_s=ST_VISIBILITY_S,
                    max_backlog=ST_BACKLOG)
    srv = ServingServer(stream_hub=hub).start()
    replays = get_registry().counter("stream_redeliveries_total")
    r0 = replays.value
    out = {}
    try:
        iq = InputQueue(srv.host, srv.port)
        rows = [bert_request(rng, 1, WP_T, vocab)[0]
                for _ in range(ST_PREDICT)]
        for k, (ids, seg, mask) in enumerate(rows):
            iq.enqueue(f"bert-{k}", stream="bert-in", ids=ids[0],
                       seg=seg[0], mask=mask[0])
            check(iq.last_record_id == k + 1, "phase 25 (d): record ids")
        gate = GatedCall(pool.predict, park_at=3)
        c1 = predict_consumer(hub.get("bert-in"), gate,
                              out_stream=hub.get("bert-out"),
                              consumer="p1", batch_size=4, poll_s=0.01)
        check(gate.parked.wait(120), "phase 25 (d): the predict consumer "
              "never reached its third batch")
        c1.kill()
        gate.release.set()
        c1.stop(timeout=60)
        c2 = predict_consumer(hub.get("bert-in"), pool.predict,
                              out_stream=hub.get("bert-out"),
                              consumer="p2", batch_size=4, poll_s=0.01)
        wait_for(lambda: hub.get("bert-in").lag("predict") == 0,
                 "the predict stream never drained")
        c2.stop(timeout=60)
        docs = {}
        for rid in hub.get("bert-out").log.ids():
            doc = json.loads(hub.get("bert-out").log.read(rid))
            docs.setdefault(doc["record_id"], doc)
        check(sorted(docs) == list(range(1, ST_PREDICT + 1)),
              f"phase 25 (d): predict records out {sorted(docs)}")
        from analytics_zoo_tpu_torch.serving.codec import decode_ndarray
        worst = 0.0
        for rid, doc in docs.items():
            want = im.predict(*rows[rid - 1])
            worst = max(worst, float(np.abs(
                decode_ndarray(doc["outputs"][0]) - want).max()))
            check(doc["uri"] == f"bert-{rid - 1}", "phase 25 (d): a "
                  "replayed record changed its id")
        check(worst <= WP_TOL, f"phase 25 (d): stream predictions off "
              f"by {worst}")
        out["predict"] = dict(records=ST_PREDICT, handled_by_killed=(
            c1.records_handled), handled_by_survivor=c2.records_handled,
            max_abs_err=worst)
        # generation: records posted to the stream route, an engine
        # consuming them under stable ids
        prompts = [rng.integers(0, gpt2_model.vocab, int(n)).tolist()
                   for n in rng.integers(16, 65, ST_GENERATE)]
        for k, p in enumerate(prompts):
            code, _, _ = http_call(srv, "POST", "/streams/gen-in/enqueue",
                                   {"uri": f"gen-{k}", "tokens": p,
                                    "max_new_tokens": ST_NEW})
            check(code == 200, f"phase 25 (d): enqueue answered {code}")
        eng, = rt_engines(torch, gpt2_model, 1)
        ref = [eng.generate(p, max_new_tokens=ST_NEW) for p in prompts]
        eng.ensure_started()
        proxy = type("Gated", (), {})()
        proxy.submit = GatedCall(eng.submit, park_at=3)
        g1 = generation_consumer(hub.get("gen-in"), proxy,
                                 out_stream=hub.get("gen-out"),
                                 consumer="g1", poll_s=0.01)
        check(proxy.submit.parked.wait(120), "phase 25 (d): the "
              "generation consumer never reached its third record")
        pre, dec = eng.n_prefills, eng.n_decode_steps
        kernels.reset_launch_counts()
        g1.kill()
        proxy.submit.release.set()
        g1.stop(timeout=60)
        g2 = generation_consumer(hub.get("gen-in"), eng,
                                 out_stream=hub.get("gen-out"),
                                 consumer="g2", poll_s=0.01)
        wait_for(lambda: hub.get("gen-in").lag("generate") == 0,
                 "the generation stream never drained")
        g2.stop(timeout=60)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        n_pre, n_dec = eng.n_prefills - pre, eng.n_decode_steps - dec
        eng.stop()
        nb = gpt2_model.n_block
        check(counts == dict({k: 0 for k in counts},
                             layer_norm_fwd=(2 * nb + 1) * (n_pre + n_dec),
                             paged_decode=nb * n_dec) and n_dec > 0,
              f"phase 25 (d): generation consumer launches {counts} for "
              f"{n_pre} prefills and {n_dec} decode steps")
        gens = {}
        for rid in hub.get("gen-out").log.ids():
            doc = json.loads(hub.get("gen-out").log.read(rid))
            gens.setdefault(doc["record_id"], doc)
        check(sorted(gens) == list(range(1, ST_GENERATE + 1)),
              f"phase 25 (d): generation records out {sorted(gens)}")
        for rid, doc in gens.items():
            check(doc["request_id"] == f"strm-gen-in-{rid}"
                  and doc["tokens"] == ref[rid - 1],
                  f"phase 25 (d): generation record {rid}: "
                  f"{doc['request_id']}, stream equal "
                  f"{doc['tokens'] == ref[rid - 1]}")
        replayed = replays.value - r0
        check(replayed >= 2, f"phase 25 (d): {replayed} redeliveries after "
              "two consumers were killed holding leases")
        out["generate"] = dict(records=ST_GENERATE, launches=counts,
                               prefills=n_pre, decode_steps=n_dec)
        out["redeliveries"] = replayed
        # a full backlog: 429 with Retry-After
        for k in range(ST_BACKLOG):
            code, _, _ = http_call(srv, "POST", "/streams/full/enqueue",
                                   {"uri": f"f{k}"})
            check(code == 200, f"phase 25 (d): enqueue {k} answered {code}")
        code, headers, body = http_call(srv, "POST",
                                        "/streams/full/enqueue", {"uri": "x"})
        check(code == 429 and float(headers["Retry-After"]) > 0,
              f"phase 25 (d): a full backlog answered {code}")
        out["full_backlog"] = dict(code=code,
                                   retry_after=headers["Retry-After"])
    finally:
        srv.stop()
        hub.close()
    # a torn fsync: recovery truncates at the last good frame
    d = os.path.join(directory, "torn")
    s = DurableStream(d, name="torn", fsync_every_n=7)
    for i in range(6):
        s.enqueue(b"payload-%02d" % i)
    set_context(OrcaContext, fault_plan={"faults": [
        {"site": "stream.fsync", "action": "torn_write"}]})
    try:
        s.enqueue(b"payload-06")
        torn = False
    except SimulatedCrash:
        torn = True
    finally:
        set_context(OrcaContext, fault_plan=None)
    s.close()
    s2 = DurableStream(d, name="torn")
    seg = os.path.join(d, "segments", os.listdir(os.path.join(
        d, "segments"))[0])
    frame = len(encode_frame(1, b"payload-00"))
    ids, tf = s2.log.ids(), s2.log.torn_frames
    check(torn and ids == [1, 2, 3] and tf == 1
          and os.path.getsize(seg) == 3 * frame
          and s2.enqueue(b"after") == 4,
          f"phase 25 (d): after a torn fsync: ids {ids}, torn frames {tf}")
    s2.close()
    out["torn_fsync"] = dict(kept=ids, torn_frames=tf)
    print(f"phase 25 (d) [{card}] {ST_PREDICT} BERT records through "
          f"enqueue(stream=) and predict_consumer over the pool, "
          f"{ST_GENERATE} prompts through generation_consumer, each "
          f"consumer killed holding leases: every record out once under "
          f"its id ({out['redeliveries']} redeliveries), predictions max "
          f"abs err {out['predict']['max_abs_err']:.3e}, streams equal the "
          f"engine's; a full backlog 429 Retry-After "
          f"{out['full_backlog']['retry_after']}; a torn fsync kept ids "
          f"{ids}", flush=True)
    return out


def sc_control_plane(torch, seed: int, card: str, gpt2_model,
                     directory: str) -> dict:
    """(e): two GPT-2 small versions from two seeds in a ModelRegistry
    behind ServingServer: hot swap under load, rollback, the A/B split,
    shadow traffic, and two tenants under an open loop at twice the
    measured capacity."""
    import threading

    from analytics_zoo_tpu_torch import observability as o
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.convert import (
        causal_lm_from_flax,
        init_causal_lm_params,
    )
    from analytics_zoo_tpu_torch.observability.registry import (
        MetricsRegistry,
    )
    from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
        save_checkpoint,
    )
    from analytics_zoo_tpu_torch.serving import ServingServer
    from analytics_zoo_tpu_torch.serving.control_plane import (
        ModelRegistry,
        ShadowSampler,
        WeightedAB,
        reset_tenant_ledger,
    )
    from analytics_zoo_tpu_torch.serving.errors import (
        UncommittedCheckpointError,
    )
    from analytics_zoo_tpu_torch.serving.generation import (
        GPT2_SMALL,
        CausalLM,
    )
    from analytics_zoo_tpu_torch.serving.streaming import (
        poisson_trace,
        run_open_loop,
    )

    v2_model = CausalLM(**GPT2_SMALL, device="cuda")
    v2_model.load_state_dict(causal_lm_from_flax(
        init_causal_lm_params(GPT2_SMALL, seed=seed + 1), GPT2_SMALL))
    v2_model.eval()
    ckpt = os.path.join(directory, "ckpt-v2")
    save_checkpoint(ckpt, {"model": v2_model.state_dict()}, block=True)
    torn = os.path.join(directory, "ckpt-torn")
    os.makedirs(torn)
    e1, = rt_engines(torch, gpt2_model, 1)
    e2, = rt_engines(torch, v2_model, 1)
    reg = ModelRegistry(metrics_registry=MetricsRegistry())
    try:
        reg.register("chat", "v-torn", e2, checkpoint=torn, warm=False)
        refused = False
    except UncommittedCheckpointError:
        refused = True
    check(refused, "phase 25 (e): a checkpoint with no commit marker "
          "was registered")
    reg.register("chat", "v1", e1)
    reg.register("chat", "v2", e2, checkpoint=ckpt)
    rng = np.random.default_rng(seed + 254)
    prompts = [rng.integers(0, gpt2_model.vocab, int(n)).tolist()
               for n in rng.integers(16, 65, CP_LOAD_CLIENTS * CP_LOAD_REQS)]
    refs = {}
    for name, eng in (("chat@v1", e1), ("chat@v2", e2)):
        streams = [eng.submit(p, max_new_tokens=CP_NEW) for p in prompts]
        eng.run_until_idle()
        refs[name] = [s.tokens() for s in streams]
    srv = ServingServer(model_registry=reg).start()
    out = {}
    try:
        # hot swap under load
        from analytics_zoo_tpu_torch.serving import InputQueue
        got, labels, errors = {}, {}, []
        started = threading.Semaphore(0)

        def client(c):
            q = InputQueue(srv.host, srv.port, model="chat")
            for r in range(CP_LOAD_REQS):
                j = c * CP_LOAD_REQS + r
                started.release()
                try:
                    got[j] = q.generate_tokens(prompts[j],
                                               max_new_tokens=CP_NEW,
                                               timeout=HTTP_TIMEOUT_S)
                    labels[j] = q.last_model
                except Exception as e:
                    errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CP_LOAD_CLIENTS)]
        for t in threads:
            t.start()
        for _ in range(CP_LOAD_CLIENTS + 2):
            started.acquire()
        reg.hot_swap("chat", "v2")
        for t in threads:
            t.join(timeout=10 * HTTP_TIMEOUT_S)
        n = CP_LOAD_CLIENTS * CP_LOAD_REQS
        check(not errors and len(got) == n,
              f"phase 25 (e): across the swap {len(got)} of {n} requests "
              f"finished, errors {errors[:1]}")
        for j, toks in got.items():
            check(toks == refs[labels[j]][j], f"phase 25 (e): request {j} "
                  f"served by {labels[j]} differs from that version's "
                  "stream")
        by_version = {v: sum(1 for x in labels.values() if x == v)
                      for v in refs}
        check(min(by_version.values()) > 0, f"phase 25 (e): versions "
              f"served {by_version}")
        reg.rollback("chat")
        q = InputQueue(srv.host, srv.port, model="chat")
        toks = q.generate_tokens(prompts[0], max_new_tokens=CP_NEW)
        check(reg.serving_version("chat") == "v1"
              and q.last_model == "chat@v1" and toks == refs["chat@v1"][0],
              f"phase 25 (e): after rollback {reg.serving_version('chat')}, "
              f"served {q.last_model}")
        out["swap"] = dict(requests=n, served_by=by_version,
                           stats={k: reg.stats()[k] for k in
                                  ("swaps", "rollbacks", "swap_refused")})
        # the A/B split, within a binomial bound, and JAX's picks
        reg.set_ab("chat", CP_AB, seed=seed)
        streams = [reg.submit(prompts[k % len(prompts)], max_new_tokens=1)
                   for k in range(CP_AB_DRAWS)]
        check(all(len(s.tokens()) == 1 for s in streams),
              "phase 25 (e): an A/B request did not finish")
        picks = [s.model_label for s in streams]
        p = CP_AB["v2"]
        n_v2 = picks.count("chat@v2")
        bound = 4 * (CP_AB_DRAWS * p * (1 - p)) ** 0.5
        replay = WeightedAB(CP_AB, seed=seed)
        check(abs(n_v2 - CP_AB_DRAWS * p) <= bound
              and picks == [f"chat@{replay.choose()}"
                            for _ in range(CP_AB_DRAWS)],
              f"phase 25 (e): {n_v2} of {CP_AB_DRAWS} on v2, expected "
              f"{CP_AB_DRAWS * p} +- {bound:.1f}")
        reg.set_ab("chat", None)
        out["ab"] = dict(draws=CP_AB_DRAWS, v2=n_v2,
                         expected=CP_AB_DRAWS * p, bound=bound)
        # shadow traffic: verdicts on the shadow tracker alone
        set_context(OrcaContext, slo_targets={"e2e_s": CP_SLO_S})
        primary = o.reset_slo_tracker()
        shadow = o.get_shadow_slo_tracker()
        s0 = shadow.snapshot()["requests_judged"]
        reg.set_shadow("chat", "v2", CP_SHADOW, seed=seed)
        wall, outs, models = rt_served(
            srv, [prompts[k % len(prompts)]
                  for k in range(CP_SHADOW_REQS)], CP_NEW,
            lambda j: {"model": "chat"})
        sampler = ShadowSampler("v2", CP_SHADOW, seed=seed)
        n_shadow = sum(sampler.sample() for _ in range(CP_SHADOW_REQS))
        wait_for(lambda: shadow.snapshot()["requests_judged"] - s0
                 >= n_shadow, "the shadow copies were never judged")
        judged = primary.snapshot()["requests_judged"]
        check(judged == CP_SHADOW_REQS and all(
            m == "chat@v1" for m in models)
            and shadow.snapshot()["requests_judged"] - s0 == n_shadow,
              f"phase 25 (e): primary judged {judged} of "
              f"{CP_SHADOW_REQS}, shadow "
              f"{shadow.snapshot()['requests_judged'] - s0} of {n_shadow}")
        reg.set_shadow("chat", None)
        out["shadow"] = dict(requests=CP_SHADOW_REQS, shadowed=n_shadow,
                             primary_judged=judged)
        # two tenants at twice the measured capacity
        cap_wall, _, _ = rt_served(srv, prompts[:16], CP_NEW,
                                   lambda j: {"model": "chat"})
        capacity = 16 / cap_wall
        free_rate = capacity * CP_FREE_SHARE
        reset_tenant_ledger()
        set_context(OrcaContext, tenant_quotas={
            "free": {"rate": free_rate, "burst": 2.0}})
        arrivals = poisson_trace(2 * capacity, CP_LOOP_S, seed=seed)

        def submit(i):
            tenant = "free" if i % 2 == 0 else "gold"
            code, headers, body = http_call(
                srv, "POST", "/generate",
                {"tokens": prompts[i % len(prompts)],
                 "max_new_tokens": CP_NEW},
                {"X-Model": "chat", "X-Tenant": tenant})
            status = ("ok" if code == 200 and b'"done"' in body
                      else "shed" if code in (429, 503) else "error")
            return {"status": status, "code": code, "tenant": tenant,
                    "retry_after": "Retry-After" in headers}

        loop = run_open_loop(submit, arrivals, slo_s=CP_SLO_S)
        res = loop["results"]
        free = [r for r in res if r["tenant"] == "free"]
        gold = [r for r in res if r["tenant"] == "gold"]
        free_shed = [r for r in free if r["status"] == "shed"]
        gold_ok = [r for r in gold if r["status"] == "ok"]
        admitted_cap = 2.0 + free_rate * (max(arrivals) + 1.0)
        check(all(r["code"] == 429 and r["retry_after"] for r in free_shed)
              and sum(1 for r in free if r["status"] == "ok")
              <= admitted_cap and free_shed
              and not any(r["status"] == "error" for r in res)
              and all(r["status"] == "ok" for r in gold),
              f"phase 25 (e): free {len(free)} offered, "
              f"{len(free_shed)} shed (codes "
              f"{sorted({r['code'] for r in free_shed})}), gold "
              f"{len(gold_ok)} of {len(gold)} served")
        gold_att = (sum(1 for r in gold_ok if r["e2e_s"] <= CP_SLO_S)
                    / max(1, len(gold_ok)))
        out["tenants"] = dict(
            capacity_rps=capacity, offered_rps=loop["offered_rate_hz"],
            free_offered=len(free), free_shed=len(free_shed),
            free_quota_rps=free_rate, gold_offered=len(gold),
            gold_attainment_admitted=gold_att,
            gold_p99_s=float(np.percentile([r["e2e_s"] for r in gold_ok],
                                           99)),
            time_to_shed_p50_s=loop["time_to_shed_p50_s"])
    finally:
        srv.stop()
        set_context(OrcaContext, slo_targets=None, tenant_quotas=None)
        reset_tenant_ledger()
        o.reset_slo_tracker()
    print(f"phase 25 (e) [{card}] registry: {out['swap']['requests']} "
          f"requests across a hot swap, none dropped, served by "
          f"{out['swap']['served_by']}, rollback to v1; A/B "
          f"{out['ab']['v2']} of {CP_AB_DRAWS} on v2 (expected "
          f"{out['ab']['expected']:.0f} +- {out['ab']['bound']:.1f}); "
          f"shadow {out['shadow']['shadowed']} of {CP_SHADOW_REQS} judged "
          f"on the shadow side only; open loop at "
          f"{out['tenants']['offered_rps']:.1f} requests/s (2 x "
          f"{out['tenants']['capacity_rps']:.1f}): free "
          f"{out['tenants']['free_shed']} of "
          f"{out['tenants']['free_offered']} shed with 429 and "
          f"Retry-After, gold attainment of admitted "
          f"{out['tenants']['gold_attainment_admitted']:.3f} (p99 "
          f"{out['tenants']['gold_p99_s']:.2f} s)", flush=True)
    return out


def sc_grpc(torch, seed: int, card: str, directory: str) -> dict:
    """(f): protocol "both" answers the same over gRPC as over HTTP, on a
    machine where `grpc` imports."""
    try:
        import grpc  # noqa: F401
    except ImportError:
        print(f"phase 25 (f) [{card}] grpc does not import on this "
              "machine: the gRPC leg was not run", flush=True)
        return dict(run=False)
    from analytics_zoo_tpu_torch.models.anomalydetection import (
        AnomalyDetector,
    )
    from analytics_zoo_tpu_torch.serving import (
        InputQueue,
        ServingConfig,
        start_serving,
        stop_serving,
    )
    from analytics_zoo_tpu_torch.serving.grpc_frontend import GrpcInputQueue

    torch.manual_seed(seed + 255)
    path = AnomalyDetector(feature_dim=1, device="cuda").save_model(
        os.path.join(directory, "anomaly"))
    x = np.random.default_rng(seed + 255).standard_normal(
        (GR_ROWS, GR_UNROLL, 1)).astype(np.float32)
    servers = start_serving(ServingConfig(
        modelPath=path, port=0, grpcPort=0, protocol="both",
        batchTimeoutMs=1.0))
    try:
        srv = servers["http"]
        http = InputQueue(srv.host, srv.port).predict(x, batched=True)
        g = GrpcInputQueue(srv.host, servers["grpc"].port)
        try:
            over_grpc = g.predict(x, batched=True)
        finally:
            g.close()
    finally:
        stop_serving(servers)
    err = float(np.abs(np.asarray(over_grpc) - np.asarray(http)).max())
    check(np.asarray(over_grpc).shape == (GR_ROWS, 1) and err <= GR_TOL,
          f"phase 25 (f): gRPC and HTTP differ by {err} > {GR_TOL}")
    print(f"phase 25 (f) [{card}] protocol both: AnomalyDetector on "
          f"{GR_ROWS} windows, gRPC equal to HTTP (max abs diff {err:.1e}, "
          f"tol {GR_TOL})", flush=True)
    return dict(run=True, max_abs_diff=err)


def phase_scale_out(torch, seed: int, card: str, gpt2_model,
                    bert_model) -> dict:
    """Phase 25: serving scale-out and the durable data plane, parts
    (a)-(f), on phase 6's GPT-2 small and phase 7's BERT-base."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch import observability as o

    t0 = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="phase25-")
    fresh_planes(o)
    out = {}
    pool = None
    try:
        out["a"] = sc_native(seed, card)
        out["b"], pool, im = sc_worker_pool(torch, seed, card, bert_model,
                                            directory)
        out["c"] = sc_router(torch, seed, card, gpt2_model)
        out["a"]["history"] = out["c"].pop("history_crc")
        out["d"] = sc_streams(
            torch, seed, card, pool, im,
            bert_model.bert.token_embed.num_embeddings, gpt2_model,
            directory)
        pool.stop()
        pool = None
        out["e"] = sc_control_plane(torch, seed, card, gpt2_model,
                                    directory)
        out["f"] = sc_grpc(torch, seed, card, directory)
    finally:
        if pool is not None:
            pool.stop()
        fresh_planes(o)
        shutil.rmtree(directory, ignore_errors=True)
        free_card(torch)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {"worker_pool_bert": out["b"]["launches"],
                       "router_generate_http": out["c"]["launches"],
                       "generation_consumer": out["d"]["generate"][
                           "launches"]}
    b = out["b"]["runs"]
    print("scale_out " + json.dumps(dict(
        card=card, seconds=out["seconds"],
        history_sample_bytes=out["a"]["history"]["sample_bytes"],
        history_crc_us_native=out["a"]["history"]["sample_crc_us_native"],
        history_crc_us_plain=out["a"]["history"]["sample_crc_us_plain"],
        crc_1mib_native_ms=out["a"]["crc_1mib_native_ms"],
        worker_sequences_per_s={n: b[n]["sequences_per_s"] for n in b},
        worker_latency_ms_p50={n: b[n]["latency_ms_p50"] for n in b},
        worker_latency_ms_p99={n: b[n]["latency_ms_p99"] for n in b},
        worker_spawn_s=out["b"]["spawn_s"],
        router_tokens_per_s={1: out["c"]["tokens_per_s_1"],
                             2: out["c"]["tokens_per_s_2"]},
        router_skew=out["c"]["skew"],
        stream_redeliveries=out["d"]["redeliveries"],
        capacity_rps=out["e"]["tenants"]["capacity_rps"],
        gold_attainment=out["e"]["tenants"]["gold_attainment_admitted"],
        free_shed=out["e"]["tenants"]["free_shed"],
        grpc=out["f"])), flush=True)
    return out


# ----------------------------------------------------------------------
# phase 26: resilience and long context (encrypted models, the elastic
# training driver, ring attention over two ranks sharing the card, the
# router's shared host tier and phase-aware routing)
# ----------------------------------------------------------------------

#: (a): the key, the environment variable `decryptKeyEnv` names, the
#: served traffic's gate (phase 7's bf16 bound, as phase 25 (b))
EN_KEY, EN_ENV = "phase 26 key", "ZOO_PHASE26_MODEL_KEY"
#: (b): the member's fine-tune (BERT-base at 32 x 128 with a one-logit
#: head under binary cross-entropy: float labels, which the "nan"
#: action poisons; it poisons float leaves only, as JAX's, and BERT's
#: inputs are ids): epochs of steps, the step "nan" poisons, the step
#: attempt 1 is
#: SIGKILLed after, the `train.step` hit attempt 3 stalls at (counted
#: from its resume at step 9: step 18), the heartbeat deadline
EL_BATCH, EL_T, EL_EPOCHS, EL_STEPS = 32, 128, 3, 8
EL_NAN_STEP, EL_KILL_STEP, EL_STALL_HIT = 5, 11, 10
EL_HEARTBEAT_S = 10.0
#: (c): bench.py:432's long-context shape (b 1, h 8, d 64, bf16, t
#: 16384), the keys the mask pads, the dropout rate and seed; a ring
#: result against the unsharded kernels', element by element, within
#: RG_GATE (|unsharded| + m + e) + e + 2e-6, m the sum of |terms| of the
#: element's product (`bwd_magnitudes`) and e what the two calls'
#: deltas, rowsum(dO O), can move it by (`rg_shares`): the unsharded
#: call and each ring block are within 2^-7 (|x| + m) of the exact
#: value (the kernels' bf16 gate, held at this shape by `rg_kernels`),
#: the blocks' |x| and m sum to at most m, and the ring's last bf16
#: rounding adds 2^-9 |x|, so the two differ by at most 3 x 2^-7 (|x| +
#: m) besides e; and, over each whole result, within RG_TOL of its
#: largest unsharded magnitude (each ring block rounds its partial to
#: bf16 once and the merge casts once: at most three bf16 roundings, 3 x
#: 2^-8, of a partial no larger than about the whole), which a fault
#: that moves every element of dq a little fails where no one element
#: does; the Keras step's losses within RG_LOSS_TOL of each other,
#: relative
RG_B, RG_T, RG_H, RG_D = 1, 16384, 8, 64
RG_PAD, RG_DROPOUT, RG_SEED = 1000, 0.1, 26
RG_GATE, RG_TOL, RG_LOSS_TOL = 3 * 2.0 ** -7, 0.03, 1e-3
RG_CASES = {"non-causal": {}, "causal": dict(causal=True),
            "kv_mask": dict(kv_mask=True),
            "dropout-bias": dict(dropout=True, bias=True)}
#: (d): the shared tier's bytes, the long prompt's tokens (6 blocks of
#: 16), requests and new tokens through the phase-aware router
RO_TIER_BYTES, RO_PROMPT, RO_REQUESTS, RO_NEW = 1 << 30, 96, 16, 16
#: BERT-base's blocks: the member's launches a step are counted in them
BERT_BASE_BLOCKS = 12


def rs_encrypted(torch, seed: int, card: str, bert_model,
                 directory: str) -> dict:
    """(a): phase 7's BERT-base saved encrypted, loaded and served."""
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.serving import (
        InferenceModel,
        ServingConfig,
        start_serving,
        stop_serving,
    )
    from analytics_zoo_tpu_torch.serving.encrypt import format_of

    plain = save_bert(torch, bert_model, os.path.join(directory, "plain"))
    t0 = time.perf_counter()
    locked = save_bert(torch, bert_model, os.path.join(directory, "locked"),
                       encrypt_key=EN_KEY)
    save_s = time.perf_counter() - t0
    with open(os.path.join(locked, "weights.pt.enc"), "rb") as f:
        fmt = format_of(f.read())
    vocab = bert_model.bert.token_embed.num_embeddings
    rng = np.random.default_rng(seed + 261)
    (ids, seg, mask), _ = bert_request(rng, WP_ROWS, WP_T, vocab)
    t0 = time.perf_counter()
    im = InferenceModel().load_model(locked, decrypt_key=EN_KEY)
    load_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    got = im.predict(ids, seg, mask)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = InferenceModel().load_model(plain).predict(ids, seg, mask)
    check(np.array_equal(got, want),
          "phase 26 (a): the decrypted model's outputs differ from the "
          "model saved in the clear")
    n_block = bert_model.bert.n_block
    check(counts == dict({k: 0 for k in counts},
                         layer_norm_fwd=2 * n_block + 1,
                         fused_dense_gelu=n_block, flash_fwd=n_block),
          f"phase 26 (a): launches {counts} for one forward")
    try:
        InferenceModel().load_model(locked, decrypt_key="wrong")
        wrong = None
    except ValueError as e:
        wrong = str(e)
    check(wrong == "decryption failed: wrong key or corrupted file "
          "(integrity tag mismatch)",
          f"phase 26 (a): a wrong key gave {wrong!r}, not JAX's error")
    # two worker processes on the card, the key from the environment
    os.environ[EN_ENV] = EN_KEY
    t0 = time.perf_counter()
    servers = start_serving(ServingConfig(
        modelPath=locked, port=0, replicas=2, maxBatchSize=32,
        batchTimeoutMs=2.0, decryptKeyEnv=EN_ENV))
    try:
        spawn_s = time.perf_counter() - t0
        pool = servers["pool"]
        wp_traffic(torch, servers["http"], np.random.default_rng(seed),
                   vocab)
        pool.reset_launch_counts()
        run = wp_traffic(torch, servers["http"], rng, vocab)
        reports = pool.launch_counts()
    finally:
        stop_serving(servers)
        del os.environ[EN_ENV]
    im_plain = InferenceModel(supported_concurrent_num=4).load_module(
        bert_model)
    err = wp_gate(torch, im_plain, run.pop("done"), "phase 26 (a)")
    served = []
    for r in reports:
        c = r["counts"]
        fwd = c["fused_dense_gelu"] // n_block
        check(fwd > 0 and c == dict({k: 0 for k in c},
                                    layer_norm_fwd=(2 * n_block + 1) * fwd,
                                    fused_dense_gelu=n_block * fwd,
                                    flash_fwd=n_block * fwd),
              f"phase 26 (a): a worker's launches {c} for {fwd} forwards")
        served.append(fwd)
    out = dict(format=fmt, save_s=save_s, load_s=load_s, spawn_s=spawn_s,
               launches=counts, worker_forwards=served, served_err=err,
               sequences_per_s=run["sequences_per_s"])
    print(f"phase 26 (a) [{card}] BERT-base saved encrypted as {fmt} in "
          f"{save_s:.2f} s, loaded with its key in {load_s:.2f} s: "
          f"outputs bitwise the model saved in the clear; a wrong key "
          f"raises JAX's error; start_serving(decryptKeyEnv, replicas=2) "
          f"up in {spawn_s:.2f} s, {run['sequences_per_s']:.1f} sequences/s "
          f"over /predict, logits within {err:.3g} of the in-process model, "
          f"worker forwards {served}", flush=True)
    return out


def el_plan(scenario: str, attempt: int):
    """The fault plan of one elastic member: the reference's "nan" at
    step 5; the faulted run's attempts 1 ("nan" at step 5, then a
    SIGKILL after step 11 from the member's trigger), 2 (a crash in the
    middle of the epoch-2 checkpoint's write), 3 (a stall at step 18)
    and 4 (none)."""
    nan = {"site": "train.step", "at": EL_NAN_STEP, "action": "nan"}
    if scenario == "reference" or attempt == 1:
        return {"faults": [nan]}
    if attempt == 2:
        return {"faults": [{"site": "checkpoint.mid_write", "at": 1,
                            "action": "crash"}]}
    if attempt == 3:
        return {"faults": [{"site": "train.step", "at": EL_STALL_HIT,
                            "action": "stall", "delay_s": 3600.0}]}
    return None


def el_heartbeat(hb_dir: str):
    """Start an elastic member's heartbeat before anything slow (the
    import of torch included): the file `touch_heartbeat` writes, touched
    at once and each second until the first step ends and while a
    checkpoint is written.  Returns the (first step ended, writing a
    checkpoint) events the member sets and the time it started."""
    import threading

    started, saving = threading.Event(), threading.Event()
    path = os.path.join(hb_dir, "heartbeat-0")

    def touch():
        os.makedirs(hb_dir, exist_ok=True)
        with open(path, "a"):
            os.utime(path, None)

    def beat_outside_steps():
        # the trigger beats after each step, so a stall inside a step
        # stops every beat
        while True:
            time.sleep(1.0)
            if saving.is_set() or not started.is_set():
                touch()

    touch()
    threading.Thread(target=beat_outside_steps, daemon=True).start()
    return started, saving, time.time()


def el_member(torch, argv, seed: int, beats) -> int:
    """One process member of (b) (`--elastic-member`): BERT-base with a
    one-logit head fine-tuned through `Estimator.fit` on the card, resumed
    from the newest commit, under `el_plan`; it writes the per-step
    losses of each epoch it ends, the nan step's check, its launches a
    step and, at the end, its weights."""
    import signal

    ckpt_dir, out_dir, attempt, resume, hb_dir, scenario, init = argv
    attempt = int(attempt)
    from analytics_zoo_tpu_torch.resilience import touch_heartbeat
    started, saving, t_start = beats
    stages = {"torch_imported": time.time()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import (
        Estimator,
        EveryEpoch,
        optimizers,
    )
    from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
        async_save_enabled,
    )

    cfg = dict(BERT_BASE, num_classes=1)
    model = fit_surface_model(torch, cfg, torch.load(
        init, map_location="cuda", weights_only=True))
    stages["model_built"] = time.time()
    est = Estimator.from_torch(model, loss="binary_crossentropy",
                               optimizer=optimizers.Adam(2e-5), seed=seed,
                               model_dir=ckpt_dir)
    rng = np.random.default_rng(seed + 262)
    inputs, y, _ = train_batch(rng, EL_BATCH * EL_STEPS, EL_T, cfg["vocab"])
    y = y.astype(np.float32)
    out = dict(attempt=attempt, scenario=scenario, losses={},
               resumed=est.resume_latest() if resume else None,
               start_epoch=est.epoch,
               async_saves=async_save_enabled(torch.device("cuda")))
    stages["resumed"] = time.time()
    OrcaContext.fault_plan = el_plan(scenario, attempt)
    OrcaContext.nonfinite_watchdog = True
    capture = {}
    save = est.save_checkpoint

    def save_beating(*args, **kwargs):
        saving.set()
        t = time.perf_counter()
        try:
            return save(*args, **kwargs)
        finally:
            out.setdefault("save_s", []).append(time.perf_counter() - t)
            saving.clear()

    est.save_checkpoint = save_beating

    class Hook(EveryEpoch):
        """Beats, records, checks; fires at each epoch's end."""

        def __call__(self, *, epoch, step, epoch_end):
            if not started.is_set():
                started.set()
                stages["first_step"] = out["first_step_at"] = time.time()
                since = {k: round(t - t_start, 2) for k, t in stages.items()}
                print(f"phase 26 (b) {scenario} attempt {attempt}: seconds "
                      f"since the interpreter's start {since}", flush=True)
            touch_heartbeat(hb_dir, 0)
            if epoch_end:
                out["losses"][str(epoch)] = [
                    s["loss"] for s in est.engine.last_steps]
            elif step == EL_NAN_STEP - 1:
                capture["before"] = params_of(model)
            elif step == EL_NAN_STEP and "before" in capture:
                out["nan_step_unchanged"] = all(
                    torch.equal(p, capture["before"][n])
                    for n, p in model.named_parameters())
                capture.clear()
            if scenario == "faulted" and attempt == 1 \
                    and step == EL_KILL_STEP and not epoch_end:
                # preempted: no goodbye, no flush
                os.kill(os.getpid(), signal.SIGKILL)
            return epoch_end

    name = os.path.join(out_dir, f"{scenario}-{attempt}")
    try:
        first = est.engine.host_step if est.engine is not None else 0
        kernels.reset_launch_counts()
        with deterministic(torch):
            est.fit({"x": list(inputs), "y": y},
                    epochs=EL_EPOCHS - est.epoch, batch_size=EL_BATCH,
                    checkpoint_trigger=Hook(), max_failures=0)
        torch.cuda.synchronize()
        steps = est.engine.host_step - first
        out["steps"] = steps
        out["launches_per_step"] = {k: c / steps for k, c in
                                    kernels.launch_counts().items()}
        torch.save({n: p.detach().cpu() for n, p in
                    model.named_parameters()}, name + ".pt")
    finally:
        with open(name + ".json", "w") as f:
            json.dump(out, f)
    return 0


def el_run(torch, scenario: str, directory: str, attempts: int,
           seed: int, init: str):
    """One `ElasticTrainingDriver` over a process member of `scenario`:
    (the driver, the seconds since the last heartbeat at each fence,
    each attempt's spawn time)."""
    from analytics_zoo_tpu_torch.resilience import (
        ElasticTrainingDriver,
        RetryPolicy,
    )

    ckpt, hb = (os.path.join(directory, scenario, d) for d in ("ckpt", "hb"))
    os.makedirs(ckpt)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    if scenario == "faulted":
        # synchronous saves: the crash at `checkpoint.mid_write` must end
        # the member inside its write, as a host lost mid-save does; in
        # the background writer it would surface only at the next drain.
        # The reference keeps the card's default, asynchronous saves
        env["ZOO_ASYNC_CHECKPOINT"] = "0"
    else:
        env.pop("ZOO_ASYNC_CHECKPOINT", None)
    spawned = []

    def spawn(wid, resume, attempt):
        spawned.append(time.time())
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--elastic-member",
             ckpt, directory, str(attempt), resume or "", hb, scenario,
             init, "--seed", str(seed)], env=env)

    class Timed(ElasticTrainingDriver):
        fenced = []

        def _teardown(self, members):
            # the seconds since the member's last heartbeat when the
            # driver fences the gang
            beat = os.path.join(hb, "heartbeat-0")
            self.fenced.append(time.time() - os.path.getmtime(beat)
                               if os.path.exists(beat) else None)
            print(f"phase 26 (b) {scenario}: attempt {len(self.history) + 1} "
                  f"fenced {self.fenced[-1]} s after the member's last "
                  f"heartbeat", flush=True)
            super()._teardown(members)

    drv = Timed(1, spawn=spawn, checkpoint_dir=ckpt, heartbeat_dir=hb,
                heartbeat_timeout_s=EL_HEARTBEAT_S,
                restart=RetryPolicy(max_attempts=attempts, backoff_s=0.0,
                                    name=f"phase26_{scenario}"))
    drv.run()
    return drv, Timed.fenced, spawned


def rs_elastic(torch, seed: int, card: str, directory: str) -> dict:
    """(b): the elastic driver over process members on the card."""
    from analytics_zoo_tpu_torch.resilience import (
        ElasticRestartExceeded,
        ElasticTrainingDriver,
        RetryPolicy,
    )

    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE

    # the members' initial weights, drawn once
    cfg = dict(BERT_BASE, num_classes=1)
    init = os.path.join(directory, "init.pt")
    torch.save(bert_from_flax(init_bert_params(cfg, seed=seed), cfg), init)
    # the uninterrupted run beside the faulted one: two members on the
    # card at once, each deterministic
    import threading
    done = {}

    def reference():
        t = time.perf_counter()
        done["ref"] = el_run(torch, "reference", directory, 1, seed,
                             init)[0]
        done["ref_s"] = time.perf_counter() - t

    ref_thread = threading.Thread(target=reference)
    ref_thread.start()
    t0 = time.perf_counter()
    try:
        drv, fenced, spawned = el_run(torch, "faulted", directory, 4,
                                      seed, init)
    finally:
        ref_thread.join()
    faulted_s = time.perf_counter() - t0
    check("ref" in done, "phase 26 (b): the uninterrupted run failed")
    ref, ref_s = done["ref"], done["ref_s"]
    hist = drv.history
    check(ref.restarts == 0 and drv.restarts == 3
          and [h["ok"] for h in hist] == [False, False, False, True]
          and [h.get("dead") for h in hist[:3]] == [[0], [0], []]
          and hist[2].get("stalled") == [0]
          and "rc=-9" in hist[0]["errors"][0]
          and hist[0]["resume"] is None
          and [os.path.basename(h["resume"]) for h in hist[1:]]
          == [f"ckpt-{EL_STEPS}"] * 2 + [f"ckpt-{2 * EL_STEPS}"],
          f"phase 26 (b): the attempt ledger {hist}")

    def report(scenario, attempt):
        with open(os.path.join(directory, f"{scenario}-{attempt}.json")) \
                as f:
            return json.load(f)

    want = report("reference", 1)
    # attempt 1's and 3's members were SIGKILLed: no report
    reports = [report("faulted", a) for a in (2, 4)]
    check(want["async_saves"] and not any(r["async_saves"] for r in reports),
          "phase 26 (b): the reference must save in the background and "
          "the faulted run synchronously")
    losses = {}
    for r in reports:
        losses.update(r["losses"])
    check(want["nan_step_unchanged"] and len(want["losses"]) == EL_EPOCHS
          and all(losses[e] == want["losses"][e] for e in losses)
          and set(losses) == {"2", "3"},
          f"phase 26 (b): per-step losses {losses} against the "
          f"uninterrupted run's {want['losses']}; the nan step left the "
          f"weights: {want.get('nan_step_unchanged')}")
    a = torch.load(os.path.join(directory, "reference-1.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(directory, "faulted-4.pt"),
                   weights_only=True)
    check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
          "phase 26 (b): the resumed run's weights differ from the "
          "uninterrupted run's")
    launches = reports[-1]["launches_per_step"]
    n_block = BERT_BASE_BLOCKS
    check(launches == dict({k: 0 for k in launches},
                           layer_norm_fwd=2 * n_block + 1,
                           layer_norm_bwd=2 * n_block + 1,
                           fused_dense_gelu=n_block, flash_fwd=n_block,
                           flash_bwd_dq=n_block, flash_bwd_dkv=n_block),
          f"phase 26 (b): the member's launches a step {launches}")
    # the budget: a member that always fails
    budget = ElasticTrainingDriver(
        1, spawn=lambda w, r, a: subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.exit(3)"]),
        restart=RetryPolicy(max_attempts=2, backoff_s=0.0))
    try:
        budget.run()
        raised = None
    except ElasticRestartExceeded as e:
        raised = str(e)
    check(raised is not None and budget.restarts == 1,
          f"phase 26 (b): a spent budget gave {raised!r}")
    out = dict(reference_s=ref_s, faulted_s=faulted_s,
               stall_detected_after_beat_s=fenced[2],
               fence_after_beat_s=fenced,
               restart_first_step_s=reports[-1]["first_step_at"]
               - spawned[-1],
               save_s=dict(reference=want.get("save_s"),
                           faulted=reports[-1].get("save_s")),
               attempts=len(hist), launches_per_step=launches)
    out["launches"] = {k: int(c * reports[-1]["steps"])
                       for k, c in launches.items()}
    print(f"phase 26 (b) [{card}] ElasticTrainingDriver over a process "
          f"member fine-tuning BERT-base at {EL_BATCH} x {EL_T} "
          f"({EL_EPOCHS} epochs of {EL_STEPS}): SIGKILL after step "
          f"{EL_KILL_STEP}, a crash in the epoch-2 checkpoint's write "
          f"(its torn save skipped: attempt 3 resumed from ckpt-"
          f"{EL_STEPS}), a stall found "
          f"{fenced[2]:.2f} s after the last heartbeat (deadline "
          f"{EL_HEARTBEAT_S} s); 4 attempts in {faulted_s:.1f} s "
          f"(synchronous saves) against {ref_s:.1f} s uninterrupted "
          f"(asynchronous saves, the default); weights and per-step losses "
          f"bitwise; the nan step {EL_NAN_STEP} skipped with the weights "
          f"unchanged; a restarted member's first step "
          f"{out['restart_first_step_s']:.2f} s after its spawn; a save's "
          f"call took {out['save_s']} s; launches a "
          f"step {launches}; a spent budget raised ElasticRestartExceeded",
          flush=True)
    return out


def rg_inputs(torch, seed: int):
    """(c)'s global inputs, the same on every rank: q, k, v and the
    cotangent [b, t, h, d] bf16, the kv_mask padding the last RG_PAD
    keys, a [1, 1, t, t] bf16 bias."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (RG_B, RG_T, RG_H, RG_D)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(4))
    mask = torch.ones(RG_B, RG_T, dtype=torch.int32, device="cuda")
    mask[:, RG_T - RG_PAD:] = 0
    bias = torch.randn(1, 1, RG_T, RG_T, generator=gen, device="cuda",
                       dtype=torch.bfloat16).mul_(0.5)
    return q, k, v, dout, mask, bias


def rg_run(torch, fn, q, k, v, dout, bias=None):
    """fn(q, k, v, bias) forward and backward from fresh leaves: (out,
    grads, forward ms, backward ms, forward launches, backward
    launches)."""
    from analytics_zoo_tpu_torch.ops import kernels
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    b = None if bias is None else bias.detach().requires_grad_(True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*leaves, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = kernels.launch_counts()
    kernels.reset_launch_counts()
    out.backward(dout)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = [x.grad for x in leaves] + ([] if b is None else [b.grad])
    return (out.detach(), grads, 1e3 * (t1 - t0), 1e3 * (t2 - t1), fwd,
            kernels.launch_counts())


def rg_keras_step(torch, seed: int) -> dict:
    """One SGD step of a MultiHeadAttention at (c)'s shape (hidden 512,
    8 heads, dropout 0.1, bf16) with attn_impl "ring" and "flash" from
    the same weights and generator: their losses before and after."""
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        MultiHeadAttention,
    )
    hid = RG_H * RG_D
    torch.manual_seed(seed)
    layers = {impl: MultiHeadAttention(hid, RG_H, attn_dropout=RG_DROPOUT,
                                       attn_impl=impl, device="cuda")
              for impl in ("ring", "flash")}
    layers["flash"].load_state_dict(layers["ring"].state_dict())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn(RG_B, RG_T, hid, generator=gen, device="cuda")
    losses = {}
    for impl, layer in layers.items():
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + 1)
        opt = torch.optim.SGD(layer.parameters(), lr=0.1)
        layer.train()
        loss = layer(x, generator=g).float().pow(2).mean()
        loss.backward()
        opt.step()
        layer.eval()
        with torch.no_grad():
            after = layer(x).float().pow(2).mean()
        losses[impl] = (float(loss), float(after))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["ring"], losses["flash"]))
    check(rel <= RG_LOSS_TOL, f"phase 26 (c): the ring layer's losses "
          f"{losses['ring']} against flash's {losses['flash']}")
    return dict(losses=losses, rel_err=rel)


def rg_shares(torch, q, k, v, dout, kv_mask, bias, causal, rate, got,
              want) -> dict:
    """The largest share of the per-element gate (RG_GATE) each of the
    ring's results (out, dq, dk, dv[, dbias]) takes against the
    unsharded call's, one head at a time: a head's magnitudes take a few
    [t, t] f32 planes."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_fwd_reference,
    )
    labels = ("out", "dq", "dk", "dv", "dbias")[:len(got)]
    shares = dict.fromkeys(labels, 0.0)
    bias32 = None if bias is None else bias.float()
    seed3 = (torch.tensor([RG_SEED, 0, 0], dtype=torch.int32,
                          device="cuda") if rate > 0.0 else None)

    def share(g, w, mag, moved):
        w = w.float()
        return float(((g.float() - w).abs()
                      / (RG_GATE * (w.abs() + mag + moved) + moved + 2e-6))
                     .max())

    db = [0.0, 0.0]
    for j in range(RG_H):
        qj, kj, vj, gj, oj, rj = (x[:, :, j:j + 1].contiguous()
                                  for x in (q, k, v, dout, want[0], got[0]))
        _, lse = flash_fwd_reference(qj, kj, vj, kv_mask=kv_mask,
                                     bias=bias32, causal=causal)
        delta = (gj.float() * oj.float()).sum(-1).reshape(1, RG_T)
        # the two deltas, rowsum(dO O), differ by at most eps: the ring's
        # O is its f32 merge, within 2^-8 of its bf16 output, and that
        # output is within |ring - unsharded| of the unsharded one
        eps = (gj.float().abs() * ((rj.float() - oj.float()).abs()
                                   + 2.0 ** -8 * rj.float().abs())) \
            .sum(-1).reshape(1, RG_T) * (1 + 2.0 ** -16)
        o_mag, mags = bwd_magnitudes(
            torch, qj, kj, vj, gj, lse, delta, kv_mask=kv_mask,
            bias=bias32, seed3=seed3, causal=causal, dropout=rate, bh0=j,
            out_mag=True)
        # what eps moves each result by: the magnitudes with p eps for
        # |ds| (dO = 0, delta = eps); zero for out and dv
        moved = bwd_magnitudes(
            torch, qj, kj, vj, torch.zeros_like(gj), lse, eps,
            kv_mask=kv_mask, bias=bias32, seed3=seed3, causal=causal,
            dropout=rate, bh0=j)
        for i, (mag, mv) in enumerate(zip([o_mag] + mags[:3],
                                          [0.0] + moved[:3])):
            shares[labels[i]] = max(shares[labels[i]], share(
                got[i][:, :, j:j + 1], want[i][:, :, j:j + 1], mag, mv))
        if bias is not None:
            db = [db[0] + mags[3], db[1] + moved[3]]
        del lse, o_mag, mags, moved, eps
    if bias is not None:
        shares["dbias"] = share(got[4], want[4], *db)
    del db
    free_card(torch)
    return shares


def rg_rank(torch, argv, seed: int) -> int:
    """One rank of (c) (`--ring-rank`): every case through the ring and
    through one unsharded flash call on the same card; the errors, walls
    and launches to a JSON file."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.common.context import (
        OrcaContext,
        init_orca_context,
        stop_orca_context,
    )
    from analytics_zoo_tpu_torch.ops.attention import flash_attention
    from analytics_zoo_tpu_torch.parallel import ring_self_attention

    rank, port, out_path = int(argv[0]), int(argv[1]), argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_orca_context(cluster_mode="distributed",
                            mesh_shape={"sp": 2},
                            coordinator_address=f"localhost:{port}",
                            num_processes=2, process_id=rank)
    res = dict(rank=rank, backend=OrcaContext.mesh.backend, device=str(dev),
               cases={})
    try:
        q, k, v, dout, mask, bias = rg_inputs(torch, seed)
        plain_out = None
        for name, kw in RG_CASES.items():
            causal = kw.get("causal", False)
            m = mask if kw.get("kv_mask") else None
            rate = RG_DROPOUT if kw.get("dropout") else 0.0
            bb = bias if kw.get("bias") else None

            def ring(q, k, v, b):
                return ring_self_attention(
                    q, k, v, causal=causal, kv_mask=m, bias=b,
                    dropout_rate=rate, dropout_rng=RG_SEED, impl="auto")

            def whole(q, k, v, b):
                return flash_attention(
                    q, k, v, causal=causal, kv_mask=m, bias=b,
                    dropout_rate=rate, dropout_seed=RG_SEED)

            dist.barrier()
            r_out, r_grads, f_ms, b_ms, f_l, b_l = rg_run(
                torch, ring, q, k, v, dout, bb)
            u_out, u_grads, u_f_ms, u_b_ms, _, _ = rg_run(
                torch, whole, q, k, v, dout, bb)
            errs = {label: float((got.float() - want.float()).abs().max())
                    for label, got, want in zip(
                        ("out", "dq", "dk", "dv", "dbias"),
                        [r_out] + r_grads, [u_out] + u_grads)}
            shares = rg_shares(torch, q, k, v, dout, m, bb, causal, rate,
                               [r_out] + r_grads, [u_out] + u_grads)
            tensor_shares = {
                label: errs[label] / (RG_TOL * float(want.float().abs().max()))
                for label, want in zip(errs, [u_out] + u_grads)}
            check(max(shares.values()) <= 1.0
                  and max(tensor_shares.values()) <= 1.0,
                  f"phase 26 (c) rank {rank} {name}: the ring against the "
                  f"unsharded kernels {errs} ({shares} of the per-element "
                  f"tolerance, {tensor_shares} of the whole-tensor one)")
            live = 2 if not causal else rank + 1
            zero = {k: 0 for k in f_l}
            check(f_l == dict(zero, flash_fwd=live)
                  and b_l == dict(zero, flash_bwd_dq=live,
                                  flash_bwd_dkv=live,
                                  flash_bwd_dbias=live if bb is not None
                                  else 0),
                  f"phase 26 (c) rank {rank} {name}: launches {f_l} "
                  f"forward, {b_l} backward, {live} live steps")
            case = dict(errors=errs, shares=shares,
                        whole_shares=tensor_shares, ring_fwd_ms=f_ms,
                        ring_bwd_ms=b_ms, whole_fwd_ms=u_f_ms,
                        whole_bwd_ms=u_b_ms, launches_fwd=f_l,
                        launches_bwd=b_l)
            if plain_out is None:
                plain_out = r_out
            elif rate > 0.0:
                # the mask dropped something: far from the no-dropout
                # output, while within the gates of the unsharded call's
                case["dropout_moved"] = float(
                    (r_out.float() - plain_out.float()).abs().max())
                check(case["dropout_moved"] > 10 * errs["out"],
                      f"phase 26 (c) rank {rank}: dropout moved the output "
                      f"by {case['dropout_moved']}")
            res["cases"][name] = case
            del r_grads, u_grads, r_out, u_out
        dist.barrier()
        res["keras"] = rg_keras_step(torch, seed)
    finally:
        stop_orca_context()
        with open(out_path, "w") as f:
            json.dump(res, f)
    return 0


def rg_kernels(torch, seed: int, card: str) -> dict:
    """(c)'s unsharded kernels at t = 16384 with the kv_mask and the
    bias: K3, K4a, K4b and K5 against their plain versions one head at a
    time (phase 5's and 5c's per-element bf16 gates; a head's plain
    scores alone take 1.07 GB in f32), then their device times beside
    their bounds and SDPA's."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd_dbias,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_reference,
        flash_fwd,
        flash_fwd_reference,
    )
    q, k, v, dout, mask, bias = rg_inputs(torch, seed)
    kw = dict(kv_mask=mask, bias=bias.float().contiguous())
    del bias
    out, lse = flash_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(RG_B * RG_H, RG_T).contiguous()
    args = (q, k, v, dout, lse, delta)
    got = [flash_bwd_dq(*args, **kw), *flash_bwd_dkv(*args, **kw),
           flash_bwd_dbias(*args, **kw)]
    shares = dict(out=0.0, dq=0.0, dk=0.0, dv=0.0)
    lse_err = 0.0
    db_want = torch.zeros_like(got[3])
    db_tol = torch.zeros_like(got[3])
    for j in range(RG_H):
        qj, kj, vj, gj = (x[:, :, j:j + 1].contiguous()
                          for x in (q, k, v, dout))
        rout, rlse = flash_fwd_reference(qj, kj, vj, **kw)
        mag, _ = flash_fwd_reference(qj.float(), kj.float(),
                                     vj.float().abs(), **kw)
        tol = 2.0 ** -7 * (rout.float().abs() + mag) + 1e-6
        shares["out"] = max(shares["out"], float(
            ((out[:, :, j:j + 1].float() - rout.float()).abs() / tol).max()))
        lse_err = max(lse_err, float((lse[j] - rlse[0]).abs().max()))
        del rout, rlse, mag, tol
        hl, hd = lse[j:j + 1].contiguous(), delta[j:j + 1].contiguous()
        want = flash_bwd_reference(qj, kj, vj, gj, hl, hd, **kw,
                                   bias_grad=True)
        mags = bwd_magnitudes(torch, qj, kj, vj, gj, hl, hd, **kw)
        for label, g, w, mg in zip(("dq", "dk", "dv"), got, want, mags):
            tol = 2.0 ** -7 * (w.float().abs() + mg) + 1e-6
            shares[label] = max(shares[label], float(
                ((g[:, :, j:j + 1].float() - w.float()).abs() / tol).max()))
        db_want += want[3]
        db_tol += 2.0 ** -7 * (want[3].abs() + mags[3])
        del want, mags
        free_card(torch)
    shares["dbias"] = float(((got[3] - db_want).abs() / (db_tol + 1e-6))
                            .max())
    del db_want, db_tol
    padded = mask[0] == 0
    check(max(shares.values()) <= 1.0 and lse_err <= 1e-4
          and bool((got[1][:, padded] == 0).all())
          and bool((got[2][:, padded] == 0).all()),
          f"phase 26 (c): K3/K4a/K4b/K5 at t = {RG_T} against their plain "
          f"versions head by head: shares of the tolerance {shares}, lse "
          f"err {lse_err}")
    del got
    # device times, bounds (the valid keys' work), SDPA's
    tv = RG_T - RG_PAD
    unit = 2.0 * RG_B * RG_H * RG_D * RG_T * tv      # one product's FLOPs
    elt = RG_B * RG_T * RG_H * RG_D * 2              # one bf16 [b,t,h,d]
    row = RG_B * RG_H * RG_T * 4                     # lse / delta
    bias_b = RG_T * RG_T * 4
    ms = dict(
        flash_fwd=cuda_ms(lambda: flash_fwd(q, k, v, **kw), iters=10),
        flash_bwd_dq=cuda_ms(lambda: flash_bwd_dq(*args, **kw), iters=10),
        flash_bwd_dkv=cuda_ms(lambda: flash_bwd_dkv(*args, **kw),
                              iters=10),
        flash_bwd_dbias=cuda_ms(lambda: flash_bwd_dbias(*args, **kw),
                                iters=10))
    bounds = dict(
        flash_fwd=bound(4 * elt + row + bias_b, 2 * unit, BF16_FLOPS),
        flash_bwd_dq=bound(5 * elt + 2 * row + bias_b, 3 * unit,
                           BF16_FLOPS),
        flash_bwd_dkv=bound(6 * elt + 2 * row + bias_b, 4 * unit,
                            BF16_FLOPS),
        flash_bwd_dbias=bound(4 * elt + 2 * row + 2 * bias_b, 2 * unit,
                              BF16_FLOPS))
    add = (kw["bias"] + torch.where(mask[:, None, None, :] != 0, 0.0,
                                    float("-inf"))).to(torch.bfloat16)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=add), iters=5)

    def sdpa_step():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add)
        o.backward(dout.transpose(1, 2))

    sdpa_bwd = cuda_ms(sdpa_step, iters=5) - sdpa_fwd
    # K5's: the same step with the mask needing its gradient (dq, dk,
    # dv, dbias together, whichever backend SDPA takes), forward
    # subtracted, as phase 5c's K5 row
    add_g = add.detach().requires_grad_(True)

    def sdpa_bias_step():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add_g)
        o.backward(dout.transpose(1, 2))

    sdpa_dbias = cuda_ms(sdpa_bias_step, iters=5) - sdpa_fwd
    del add, add_g, qs, ks, vs
    free_card(torch)
    library = dict(flash_fwd=sdpa_fwd, flash_bwd_dq=sdpa_bwd,
                   flash_bwd_dkv=sdpa_bwd, flash_bwd_dbias=sdpa_dbias)
    times = {n: dict(ms=ms[n], bound_ms=bounds[n][0],
                     bound_by=bounds[n][1], library_ms=library[n])
             for n in ms}
    for n, t in times.items():
        print(f"{n} t={RG_T} b={RG_B} h={RG_H} d={RG_D} bf16 kv_mask + "
              f"[1, 1, t, t] bias, device time per call [{card}]: "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), library "
              + (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
                 else "none") + " (SDPA, float mask"
              + (" needing its gradient)" if n == "flash_bwd_dbias"
                 else ")"), flush=True)
    return dict(shares=shares, lse_err=lse_err, times=times)


def rs_ring(torch, seed: int, card: str, directory: str) -> dict:
    """(c): two ranks sharing the card, as fresh interpreters."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(directory, f"ring-{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--ring-rank", str(r), str(port), outs[r],
                               "--seed", str(seed)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    check(rcs == [0, 0], f"phase 26 (c): the ring ranks exited {rcs}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    check(all(r["backend"] == "gloo" for r in ranks),
          f"phase 26 (c): backends {[r['backend'] for r in ranks]}")
    kernels_ = rg_kernels(torch, seed, card)
    out = dict(wall_s=wall, backend=ranks[0]["backend"], ranks=ranks,
               kernels=kernels_)
    out["launches"] = {f"rank{r['rank']}": {
        k: sum(c["launches_fwd"][k] + c["launches_bwd"][k]
               for c in r["cases"].values())
        for k in r["cases"]["causal"]["launches_fwd"]} for r in ranks}
    for r in ranks:
        walls = {n: (round(c["ring_fwd_ms"], 2), round(c["ring_bwd_ms"], 2))
                 for n, c in r["cases"].items()}
        shares = {n: (round(max(c["shares"].values()), 4),
                      round(max(c["whole_shares"].values()), 4))
                  for n, c in r["cases"].items()}
        print(f"phase 26 (c) [{card}] rank {r['rank']} of 2 on one card "
              f"({r['backend']}, host-staged exchange) t = {RG_T}: ring "
              f"(forward, backward) ms {walls}; against the unsharded "
              f"kernels, shares of the (per-element, whole-tensor) "
              f"gates {shares}; "
              f"Keras ring step losses {r['keras']['losses']['ring']} vs "
              f"flash {r['keras']['losses']['flash']}", flush=True)
    return out


def rs_router(torch, seed: int, card: str, gpt2_model) -> dict:
    """(d): two GPT-2 small replicas from `ReplicaRouter.build`, one
    shared host tier, phase-aware routing on."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    from analytics_zoo_tpu_torch.serving.distributed import ReplicaRouter

    model = gpt2_model
    n_block = model.n_block
    geom = dict(max_slots=8, block_size=16, max_context=1024)
    rng = np.random.default_rng(seed + 264)
    long = rng.integers(0, model.vocab, RO_PROMPT).tolist()

    def prompt(j):
        # cached prefixes of the long prompt and short prompts (decode
        # heavy), and fresh long prompts (prefill heavy)
        extra = rng.integers(0, model.vocab, 8).tolist()
        if j % 4 == 0:
            return long[:RO_PROMPT - 16 * (j % 3)] + extra
        if j % 4 == 1:
            return rng.integers(0, model.vocab, 64).tolist()
        return extra[:4 + j % 4]

    prompts = [prompt(j) for j in range(RO_REQUESTS)]
    single, = rt_engines(torch, model, 1)
    streams = [single.submit(p, max_new_tokens=RO_NEW)
               for p in [long + [1, 2]] + prompts]
    single.run_until_idle()
    want = [s.tokens() for s in streams]
    set_context(OrcaContext, kv_host_tier_bytes=RO_TIER_BYTES,
                router_phase_aware=True)
    try:
        router = ReplicaRouter.build(model, n_replicas=2, device="cuda",
                                     prefix_caching=True, **geom)
    finally:
        set_context(OrcaContext, kv_host_tier_bytes=0,
                    router_phase_aware=False)
    engines = [r.engine for r in router.replicas]
    tier = engines[0].host_tier
    check(tier is not None and all(e.host_tier is tier for e in engines)
          and router.phase_aware
          and engines[0].prefix_cache.host_write_through,
          "phase 26 (d): the replicas do not share one host tier")
    # replica 0 prefills the long prompt (its blocks written through to
    # the tier) and evicts them; replica 1 restores them
    s0 = engines[0].submit(long, max_new_tokens=2)
    engines[0].run_until_idle()
    s0.tokens()
    spilled = tier.n_spilled
    engines[0].prefix_cache.evict(RO_PROMPT // geom["block_size"])
    before = engines[1].n_host_restores
    pre = (engines[1].n_prefills, engines[1].n_decode_steps)
    kernels.reset_launch_counts()
    split0 = paged_decode.launches_by_body["split"]
    s1 = engines[1].submit(long + [1, 2], max_new_tokens=RO_NEW)
    engines[1].run_until_idle()
    got1 = s1.tokens()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    restored = engines[1].n_host_restores - before
    steps = engines[1].n_decode_steps - pre[1]
    check(got1 == want[0] and restored == RO_PROMPT // geom["block_size"]
          and spilled > 0,
          f"phase 26 (d): replica 1 restored {restored} blocks of what "
          f"replica 0 spilled ({spilled}); its stream equal to one "
          f"engine's: {got1 == want[0]}")
    check(counts["paged_decode"] == n_block * steps and steps > 0
          and paged_decode.launches_by_body["split"] - split0
          == counts["paged_decode"],
          f"phase 26 (d): K6 launches {counts['paged_decode']} for "
          f"{steps} decode steps")
    # phase-aware routing: the streams are one engine's
    pre = [(e.n_prefills, e.n_decode_steps) for e in engines]
    kernels.reset_launch_counts()
    split0 = paged_decode.launches_by_body["split"]
    rstreams = [router.submit(p, max_new_tokens=RO_NEW) for p in prompts]
    router.run_until_idle()
    got = [s.tokens() for s in rstreams]
    torch.cuda.synchronize()
    counts2 = kernels.launch_counts()
    steps2 = [(e.n_prefills - p, e.n_decode_steps - d)
              for e, (p, d) in zip(engines, pre)]
    phases = (router.registry.counter("router_phase_prefill_total").value,
              router.registry.counter("router_phase_decode_total").value)
    check(got == want[1:], "phase 26 (d): a phase-aware routed stream "
          "differs from one engine's greedy stream")
    check(counts2["paged_decode"] == n_block * sum(d for _, d in steps2)
          and paged_decode.launches_by_body["split"] - split0
          == counts2["paged_decode"] and min(phases) > 0,
          f"phase 26 (d): K6 {counts2['paged_decode']} for (prefills, "
          f"decode steps) {steps2}; phases {phases}")
    served = [r.served for r in router.replicas]
    router.stop()
    single.stop()
    out = dict(spilled=spilled, restored=restored, steps=steps,
               launches=counts, routed_launches=counts2, served=served,
               phases=phases, tier_bytes=tier.bytes_used)
    print(f"phase 26 (d) [{card}] two GPT-2 small replicas, one host tier "
          f"of {RO_TIER_BYTES >> 20} MiB ({tier.bytes_used} bytes held): "
          f"replica 1 restored {restored} blocks replica 0 spilled "
          f"({spilled} spills), its stream one engine's, K6 "
          f"{counts['paged_decode']} = {n_block} x {steps} decode steps, "
          f"all split; phase-aware: {RO_REQUESTS} streams equal one "
          f"engine's, prefill/decode {phases}, served {served}",
          flush=True)
    return out


def phase_resilience(torch, seed: int, card: str, gpt2_model,
                     bert_model) -> dict:
    """Phase 26: (a) encrypted models, (b) the elastic driver, (c) ring
    attention at t = 16384 on two ranks, (d) the router's shared host
    tier and phase-aware routing."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch import observability as o

    t0 = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="phase26-")
    fresh_planes(o)
    out = {}
    try:
        out["a"] = rs_encrypted(torch, seed, card, bert_model, directory)
        free_card(torch)
        out["b"] = rs_elastic(torch, seed, card, directory)
        out["c"] = rs_ring(torch, seed, card, directory)
        free_card(torch)
        out["d"] = rs_router(torch, seed, card, gpt2_model)
    finally:
        fresh_planes(o)
        shutil.rmtree(directory, ignore_errors=True)
        free_card(torch)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {
        "encrypted_bert": out["a"]["launches"],
        "elastic_member_fine_tune": out["b"]["launches"],
        "ring_rank0": out["c"]["launches"]["rank0"],
        "ring_rank1": out["c"]["launches"]["rank1"],
        "router_shared_tier": out["d"]["launches"],
        "router_phase_aware": out["d"]["routed_launches"]}
    print("resilience " + json.dumps(dict(
        card=card, seconds=out["seconds"], format=out["a"]["format"],
        stall_detected_after_beat_s=out["b"]["stall_detected_after_beat_s"],
        restart_first_step_s=out["b"]["restart_first_step_s"],
        ring_wall_s=out["c"]["wall_s"],
        long_context=out["c"]["kernels"]["times"],
        restored=out["d"]["restored"])), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    # phase 26's children: a member of the elastic driver, a ring rank
    ap.add_argument("--elastic-member", nargs=7, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ring-rank", nargs=3, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    beats = (el_heartbeat(args.elastic_member[4]) if args.elastic_member
             else None)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.elastic_member:
        return el_member(torch, args.elastic_member, args.seed, beats)
    if args.ring_rank:
        return rg_rank(torch, args.ring_rank, args.seed)
    from analytics_zoo_tpu_torch.ops.kernels import _build

    # phase 1: setup
    start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build(_build.cuda_sources(), extra_flags=["-Xptxas", "-v"])
    print(f"built CUDA sources {_build.cuda_sources()} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    from analytics_zoo_tpu_torch.ops.kernels.layer_norm import layer_norm_fwd
    x = torch.ones(1, D_MODEL, device="cuda")
    layer_norm_fwd(x, x[0], x[0])
    torch.cuda.synchronize()
    print(f"built the Triton LayerNorm kernel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    clocks("before phase 2", start)
    ln = phase_layer_norm(torch, gen)
    pd = phase_paged(torch, gen)
    fd = phase_fused_dense(torch, gen)
    fa, fa_edges = phase_flash(torch, gen)
    lnb = phase_layer_norm_bwd(torch, gen)
    fab, fab_ragged = phase_flash_bwd(torch, gen)
    wide = phase_flash_wide(torch)
    threads = phase_threads(torch)
    clocks("after phase 5d", start)
    runs, engine = phase_slice(torch, args.requests, args.seed, card)
    clocks("after phase 6", start)
    gen_breadth = phase_generation_breadth(torch, args.seed, card,
                                           engine.model)
    clocks("after phase 14", start)
    bert_runs, bert_model = phase_bert(torch, args.seed, card)
    clocks("after phase 7", start)
    train, est, train_batch_ = phase_train(torch, args.seed, card)
    bias_run, bias_est, bias_batch = phase_bias_path(torch, args.seed, card)
    clocks("after phase 9", start)
    fit_surface, fit_ctx = phase_fit_surface(torch, args.seed, card)
    clocks("after phase 12", start)
    rec = phase_recommendation(torch, args.seed, card)
    clocks("after phase 11", start)
    data_path = phase_data_path(torch, args.seed, card, rec, train)
    clocks("after phase 13", start)
    serving = phase_serving(torch, args.seed, card, engine.model,
                            bert_model, runs[0], bert_runs[0])
    clocks("after phase 15", start)
    int8 = phase_int8_serving(torch, args.seed, card, bert_model)
    clocks("after phase 16", start)
    zoo = phase_image_zoo(torch, args.seed, card)
    clocks("after phase 17", start)
    zoo_rest = phase_zoo_rest(torch, args.seed, card)
    clocks("after phase 18", start)
    keras = phase_keras(torch, args.seed, card)
    clocks("after phase 19", start)
    importers = phase_importers(torch, args.seed, card)
    clocks("after phase 20", start)
    chronos = phase_chronos(torch, args.seed, card)
    clocks("after phase 21", start)
    chronos_rest = phase_chronos_rest(torch, args.seed, card)
    clocks("after phase 22", start)
    observability = phase_observability(torch, args.seed, card,
                                        engine.model)
    clocks("after phase 23", start)
    serving_planes = phase_serving_planes(torch, args.seed, card,
                                          engine.model)
    clocks("after phase 24", start)
    scale_out = phase_scale_out(torch, args.seed, card, engine.model,
                                bert_model)
    clocks("after phase 25", start)
    resilience = phase_resilience(torch, args.seed, card, engine.model,
                                  bert_model)
    clocks("after phase 26", start)

    # phase 10: device times from the profiler, after the timed serving
    # (a profiler session may leave tracing costs behind on the host)
    for shape in ln + pd + fd + fa + lnb + [s for v in fab.values()
                                             for s in v]:
        device_times(shape)
        subtract_forward(shape, "library_ms")
        what = {k: shape[k] for k in ("rows", "pool", "dtype", "m", "k", "n",
                                      "b", "t") if k in shape}
        print(f"{shape['name']} {what} device time per call [{card}] "
              f"({shape['ms_from']}): kernel {shape['ms']:.5f} ms, plain "
              f"{shape['plain_ms']:.5f} ms, library "
              f"{shape['library_ms']:.5f} ms, bound {shape['bound_ms']:.5f} "
              f"ms" + (f", cp_async body {shape['cp_async_ms']:.5f} ms"
                       if "cp_async_ms" in shape else "")
              + (f", rows body (the PR 1 design) {shape['rows_ms']:.5f} ms"
                 f", every lane at 16 tokens {shape['floor_ms']:.5f} ms"
                 if "rows_ms" in shape else ""), flush=True)
    clocks("after phase 10 kernel timings", start)
    engine.keep_logits = False
    runs[0]["decode_profile"] = decode_profile(
        torch, engine, engine.model.vocab, args.seed + 7)
    print(f"decode step profile [{card}]: "
          f"{json.dumps(runs[0]['decode_profile'])}", flush=True)
    gen_breadth["step_profiles"] = gb_step_profiles(torch, engine.model)
    print(f"phase 14 step profiles [{card}]: "
          f"{json.dumps(gen_breadth['step_profiles'])}", flush=True)
    bert_runs[0]["forward_profile"] = bert_profile(torch, bert_model,
                                                   args.seed + 9)
    print(f"BERT forward profile [{card}]: "
          f"{json.dumps(bert_runs[0]['forward_profile'])}", flush=True)
    train["step_profile"] = train_profile(torch, est, train_batch_)
    # the fit's steps run back to back, with no host wait between them
    train["step_profile"]["device_share_of_fit_step_p50"] = \
        train["step_profile"]["device_ms_per_step_all_events"] \
        / train["step_ms_p50"]
    print(f"BERT train step profile [{card}]: "
          f"{json.dumps(train['step_profile'])}", flush=True)
    bias_run["step_profile"] = train_profile(torch, bias_est, bias_batch)
    print(f"learnable-bias step profile [{card}]: "
          f"{json.dumps(bias_run['step_profile'])}", flush=True)
    fit_surface_profiles(torch, fit_surface, fit_ctx, args.seed, card)
    del fit_ctx

    clocks("at the end", start)
    gpt2, bert = runs[0]["launches"], bert_runs[0]["launches"]
    tr, remat = train["launches"], fit_surface["launches"]
    xs_bert = data_path["d"]["launches"]
    srv_bert = serving["launches"]["serving_bert"]
    srv_gen = serving["launches"]["serving_generate"]
    int8_bert = int8["a"]["launches"]
    pretrained = zoo_rest["a"]["launches"]
    k_bert, k_gpt = keras["b"]["launches"], keras["c"]["launches"]
    obs_fit = observability["launches"]
    obs_gen = observability["launches_generation"]
    planes_gen = serving_planes["launches"]
    scale = scale_out["launches"]
    res = resilience["launches"]
    kernels = [
        kernel_entry("layer_norm_fwd", "triton",
                     "analytics_zoo_tpu_torch/ops/kernels/layer_norm.py",
                     "analytics_zoo_tpu/ops/pallas/layer_norm.py:78",
                     tr["layer_norm_fwd"], ln, 2),
        kernel_entry("layer_norm_bwd", "triton",
                     "analytics_zoo_tpu_torch/ops/kernels/layer_norm.py",
                     "analytics_zoo_tpu/ops/pallas/layer_norm.py:108",
                     tr["layer_norm_bwd"], lnb, 0),
        kernel_entry("fused_dense_gelu", "cuda",
                     "analytics_zoo_tpu_torch/csrc/fused_dense.cu",
                     "analytics_zoo_tpu/ops/pallas/fused_dense.py:79",
                     tr["fused_dense_gelu"], fd, 2),
        kernel_entry("flash_fwd", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_fwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:408",
                     tr["flash_fwd"], fa, 2,
                     [c["max_abs_err"] for c in fa_edges.values()]),
        kernel_entry("flash_bwd_dq", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:741",
                     tr["flash_bwd_dq"], fab["flash_bwd_dq"], 2,
                     [c["max_abs_err"][0] for c in fab_ragged.values()]),
        kernel_entry("flash_bwd_dkv", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:825",
                     tr["flash_bwd_dkv"], fab["flash_bwd_dkv"], 2,
                     [c["max_abs_err"][1] for c in fab_ragged.values()]),
        kernel_entry("flash_bwd_dbias", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:807",
                     bias_run["launches"]["flash_bwd_dbias"],
                     fab["flash_bwd_dbias"], 2),
        kernel_entry("paged_decode", "cuda",
                     "analytics_zoo_tpu_torch/csrc/paged_decode.cu",
                     "analytics_zoo_tpu/ops/pallas/paged_attention.py:155",
                     gpt2["paged_decode"], pd, 0),
    ]
    breadth = gen_breadth["launches"]
    by_path = {"layer_norm_fwd": {"generation": gpt2,
                                  "generation_breadth": breadth,
                                  "bert_serving": bert,
                                  "bert_fine_tune": tr,
                                  "bert_fine_tune_remat": remat,
                                  "bert_fine_tune_xshards": xs_bert,
                                  "serving_bert_http": srv_bert,
                                  "serving_generate_http": srv_gen,
                                  "int8_bert_serving": int8_bert,
                                  "bert_pretrained_fine_tune": pretrained,
                                  "keras_bert_fit": k_bert,
                                  "keras_transformer_layer_fit": k_gpt,
                                  "observed_fine_tune": obs_fit,
                                  "observed_generation": obs_gen,
                                  "serving_planes_http": planes_gen,
                                  "worker_pool_bert_http":
                                      scale["worker_pool_bert"],
                                  "router_generate_http":
                                      scale["router_generate_http"],
                                  "generation_stream_consumer":
                                      scale["generation_consumer"],
                                  "encrypted_bert_serving":
                                      res["encrypted_bert"],
                                  "elastic_member_fine_tune":
                                      res["elastic_member_fine_tune"],
                                  "router_shared_tier":
                                      res["router_shared_tier"],
                                  "router_phase_aware":
                                      res["router_phase_aware"]},
               "layer_norm_bwd": {"bert_fine_tune": tr,
                                  "bert_fine_tune_remat": remat,
                                  "bert_fine_tune_xshards": xs_bert,
                                  "bert_pretrained_fine_tune": pretrained,
                                  "keras_bert_fit": k_bert,
                                  "keras_transformer_layer_fit": k_gpt,
                                  "observed_fine_tune": obs_fit,
                                  "elastic_member_fine_tune":
                                      res["elastic_member_fine_tune"]},
               "fused_dense_gelu": {"bert_serving": bert,
                                    "bert_fine_tune": tr,
                                    "bert_fine_tune_remat": remat,
                                    "bert_fine_tune_xshards": xs_bert,
                                    "serving_bert_http": srv_bert,
                                    "worker_pool_bert_http":
                                        scale["worker_pool_bert"],
                                    "int8_bert_serving": int8_bert,
                                    "bert_pretrained_fine_tune": pretrained,
                                    "keras_bert_fit": k_bert,
                                    "keras_transformer_layer_fit": k_gpt,
                                    "observed_fine_tune": obs_fit,
                                    "encrypted_bert_serving":
                                        res["encrypted_bert"],
                                    "elastic_member_fine_tune":
                                        res["elastic_member_fine_tune"]},
               "flash_fwd": {"bert_serving": bert, "bert_fine_tune": tr,
                             "learnable_bias": bias_run["launches"],
                             "bert_fine_tune_remat": remat,
                             "bert_fine_tune_xshards": xs_bert,
                             "serving_bert_http": srv_bert,
                             "worker_pool_bert_http":
                                 scale["worker_pool_bert"],
                             "int8_bert_serving": int8_bert,
                             "bert_pretrained_fine_tune": pretrained,
                             "keras_transformer_layer_fit": k_gpt,
                             "observed_fine_tune": obs_fit,
                             "encrypted_bert_serving":
                                 res["encrypted_bert"],
                             "elastic_member_fine_tune":
                                 res["elastic_member_fine_tune"],
                             "ring_attention_rank0": res["ring_rank0"],
                             "ring_attention_rank1": res["ring_rank1"]},
               "flash_bwd_dq": {"bert_fine_tune": tr,
                                "learnable_bias": bias_run["launches"],
                                "bert_fine_tune_remat": remat,
                                "bert_fine_tune_xshards": xs_bert,
                                "bert_pretrained_fine_tune": pretrained,
                                "keras_transformer_layer_fit": k_gpt,
                                "observed_fine_tune": obs_fit,
                                "elastic_member_fine_tune":
                                    res["elastic_member_fine_tune"],
                                "ring_attention_rank0": res["ring_rank0"],
                                "ring_attention_rank1": res["ring_rank1"]},
               "flash_bwd_dkv": {"bert_fine_tune": tr,
                                 "learnable_bias": bias_run["launches"],
                                 "bert_fine_tune_remat": remat,
                                 "bert_fine_tune_xshards": xs_bert,
                                 "bert_pretrained_fine_tune": pretrained,
                                 "keras_transformer_layer_fit": k_gpt,
                                 "observed_fine_tune": obs_fit,
                                 "elastic_member_fine_tune":
                                     res["elastic_member_fine_tune"],
                                 "ring_attention_rank0": res["ring_rank0"],
                                 "ring_attention_rank1": res["ring_rank1"]},
               "flash_bwd_dbias": {"learnable_bias": bias_run["launches"],
                                   "ring_attention_rank0":
                                       res["ring_rank0"],
                                   "ring_attention_rank1":
                                       res["ring_rank1"]},
               "paged_decode": dict(
                   {f"generation_{r['label']}": r["launches"]
                    for r in runs}, generation_breadth=breadth,
                   serving_generate_http=srv_gen,
                   observed_generation=obs_gen,
                   serving_planes_http=planes_gen,
                   router_generate_http=scale["router_generate_http"],
                   generation_stream_consumer=scale[
                       "generation_consumer"],
                   router_shared_tier=res["router_shared_tier"],
                   router_phase_aware=res["router_phase_aware"])}
    for k in kernels:
        paths = by_path.get(k["name"])
        if paths:
            k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        # no kernel lies on phase 11's path nor on phase 13's NCF and
        # optimizer runs (checked there: all 0)
        k.setdefault("launches_by_path", {})["recommendation_training"] = \
            rec["launches"][k["name"]]
        k["launches_by_path"]["data_path_recommendation"] = \
            data_path["launches_recommendation"][k["name"]]
        # nor on phase 15's NCF served over HTTP (checked there: all 0)
        k["launches_by_path"]["serving_ncf_http"] = \
            serving["launches"]["serving_ncf"][k["name"]]
        # nor on phase 16's ResNet-50 nor anywhere in phase 17 (checked
        # there: all 0)
        k["launches_by_path"]["int8_resnet50_serving"] = \
            int8["b"]["launches"][k["name"]]
        k["launches_by_path"]["image_zoo"] = zoo["launches"][k["name"]]
        # nor on phase 18's models other than BERT (checked there: all 0)
        k["launches_by_path"]["zoo_rest_other_models"] = \
            zoo_rest["launches"][k["name"]]
        # nor on phase 19's NCF toy and conv / recurrent stacks (checked
        # there: all 0)
        k["launches_by_path"]["keras_ncf_toy"] = \
            keras["a"]["launches"][k["name"]]
        k["launches_by_path"]["keras_stacks"] = \
            keras["d"]["launches"][k["name"]]
        # nor anywhere in phase 20 (checked there: all 0)
        k["launches_by_path"]["importers"] = \
            importers["launches"][k["name"]]
        # nor anywhere in phase 21 (checked there: all 0)
        k["launches_by_path"]["chronos_autots"] = \
            chronos["launches"][k["name"]]
        # nor anywhere in phase 22 (checked there: all 0)
        k["launches_by_path"]["chronos_rest"] = \
            chronos_rest["launches"][k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    print(json.dumps({"card": card, "slice": runs,
                      "generation_breadth": gen_breadth, "bert": bert_runs,
                      "train": train, "bias_path": bias_run,
                      "recommendation": rec, "fit_surface": fit_surface,
                      "data_path": data_path, "serving": serving,
                      "int8_serving": int8, "image_zoo": zoo,
                      "zoo_rest": zoo_rest, "keras": keras,
                      "importers": importers,
                      "chronos": chronos, "chronos_rest": chronos_rest,
                      "observability": observability,
                      "serving_planes": serving_planes,
                      "scale_out": scale_out,
                      "resilience": resilience,
                      "flash_fwd_boundary": fa_edges,
                      "flash_bwd_ragged_t": fab_ragged,
                      "flash_bh_past_65535": wide,
                      "threads": threads}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
