"""Smoke run of the PyTorch/CUDA port (``mme_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.
2. Build: every CUDA kernel from ``mme_tpu_torch/csrc/`` (flash forward
   and backward, the fused MLP, the fused LayerNorm, the fused Adam
   update), one ``nvcc`` per source started together; prints the build
   time, ``-Xptxas -v`` of the flash kernels and a summary of the fused
   MLP's (registers, spills), of every flash kernel's (registers, spills,
   wgmma serialized by ptxas or not), of every LayerNorm instance's
   (registers, spills, static shared memory; the ring's dynamic shared
   memory is printed per shape in phase 3) and of the Adam kernel's.
3. Kernels against their plain PyTorch versions on the card:
   - the flash forward (K1) and backward (K2), q/k/v as strided views of a
     fused QKV tensor, at the four model shapes, wav2vec2-base's
     [8, 299, 12 heads] and phase 10's [8, 499], [8, 1 568] (no key mask)
     and [8, 71] at 12 heads, phase 11's length buckets below the cap
     (audio [8, 124 | 249 | 374] at 16 heads and fusion [8, 298 | 423 |
     548] at 12, key mask) in bf16 and fp32, a ragged
     key length with head_dim 128, rows whose every key is masked by bias
     and, for K2, a sentinel row (every score -inf). Times each kernel, its
     plain version and ``scaled_dot_product_attention`` forward / backward
     (a yardstick the port never calls) at the bf16 shapes with CUDA events;
   - the fused bf16-moment Adam update (K3) on the model's leaf shapes:
     exact in ``zero_noise`` mode, and with noise every moment is one of
     the two bf16 neighbours, the mean error is within 5 standard errors,
     other leaves and steps get other dither, and the moments equal the
     plain version's bit for bit on the same Philox words; one launch over
     a mixed list (fp32 and bf16 gradients, 1 to 38.6 M elements, a leaf
     not 16-byte aligned), fresh and in place; one launch over the step's
     725 trainable leaves against the plain version on the same words.
     Times one call over the step's trainable leaves (and over its 235 big
     ones, the per-leaf kernel's old set): wrapper by CUDA events, kernel
     alone in a profiler trace, host µs per call, the plain version once;
   - the fused LayerNorm forward (K4a) and backward (K4b) at [2 392, 1024],
     [11 712, 768], [3 784, 768], [153 592, 512], wav2vec2-base's
     [2 392, 768] and [2 392, 512], phase 10's [3 992, 768], [3 992, 512]
     and [12 544, 768], the 1 024-row gate ([992 | 1 023 | 1 024 | 1 025 |
     1 992, 1 024] and [992, 512]), a ragged [3 001, 768] and
     the widest row [1 024, 8 192] in bf16 and fp32, fp32 in / bf16 out, and
     x as a row-offset view: y, dx, dscale, dbias, two runs bit-equal. Times
     them at every shape a training step launches, beside ``F.layer_norm``
     and its backward (weight and bias cast to bf16 once, outside the
     timed call), with the bounds of ``ops/layer_norm.py::bounds``;
   - the wgmma/TMA product core of the bf16 MLP kernels alone
     (``gemm_bf16``) against an fp32 product at the four operand orders,
     ragged extents and the video tower's product shapes;
   - the fused MLP forward (K5a) and backward (K5b) at the four full-width
     tower shapes and wav2vec2-base's (2 392, 768, 3072) in bf16, phase
     10's (3 992 | 12 544 | 568, 768, 3072) in bf16 and fp32, a small
     shape in fp32 and bf16 with each of the four activations, N = 1, 17
     and 129 at H = 256 to 1024 in bf16, and a wide fp32 shape: out, dx,
     dW1, dW2, db1, db2, two runs bit-equal.
     Times them at the tower shapes beside the unfused
     ``F.linear → gelu → F.linear`` and its autograd backward.
4. Serving at full width: ``init_params(TAVSpec(output_dim=7))`` →
   ``from_flax`` → ``TAVModel`` → ``Predictor(batch_size=8)`` serving ragged
   requests (8, 5 and 11 utterances, uint8 video) in an fp32 and a bf16
   leg. Each leg is held against the same Predictor with ``MME_FLASH=0``
   (54 flash launches per chunk), then served again with
   ``MME_FUSED_LN=1 MME_FUSED_MLP=1`` and held against the knobs-off
   probabilities: 54 K5a launches per chunk and the K4a count computed from
   the spec. Prints ms per batch of 8 with the knobs off and on,
   utterances per second and peak device memory for the bf16 leg.
5. Training at full width and depth through ``build_tav`` (70 tokens,
   96 000 samples, a 16x224x224 clip, shared audio frontend, no remat, no
   accumulation buffer):
   (1) fp32 compute, dropout and SpecAugment off, batch 4: loss and
       gradients of one batch with the kernels against ``MME_FLASH=0``
       (54 forward and 54 backward launches with, none without), and with
       both knobs on against both off: 54 + 54 launches of K5a/K5b and
       K1/K2, the computed K4a/K4b counts;
   (2) a deterministic bf16 leg (dropout off) on one fixed batch of 8: the
       loss after four steps must lie below the first;
   (3) the benchmark configuration: bf16 compute, batch 8, dropout and
       SpecAugment on, ``MME_OPT_STATE=bf16``, lr 5e-6, cosine warm
       restarts; 2 warm-up and 4 timed steps, 54 + 54 launches per step;
       prints ms per step, utterances per second, peak memory and a
       forward / backward / optimizer split by CUDA events;
   (4) the same state with ``MME_FUSED_ADAM=1``: one K3 launch per step
       covering every trainable leaf, the moments bf16 and updated in
       place, peak memory within 0.2 GB of leg (3)'s; device kernels per
       step beside leg (3)'s (profiler);
   (5) the same state with ``MME_FUSED_LN=1 MME_FUSED_MLP=1``: launches per
       step, ms per step, the split and peak memory beside leg (3)'s.
6. The training loop at full width and cut depth: phase 5's weights of
   every tower's and the trunk's first ``LOOP_DEPTH`` (6) layers (text 6,
   audio 6 of 24, video 6 of 12, fusion 6 of 12: 24 attention layers,
   half the weights) in a fresh bf16
   ``TAVModel`` (dropout 0.1, shared audio frontend) through the CLI's
   ``cli/common.py::run_classifier`` with ``MME_OPT_STATE=bf16
   MME_FUSED_ADAM=1`` on synthetic records (70 tokens, 96 000 samples, a
   16x224x224 clip; 16 / 8 / 8 utterances), batch 8, two epochs,
   validation every 2 steps, random keep-masks and SpecAugment, checkpoints
   in a temporary directory deleted at the end. Epoch 0 runs the weighted
   sampler and plain loss; epoch 1 runs in order with class weights and
   dialog accumulation (dialogs of 16: two batches per update). Checks:
   finite losses in both epochs; 24 K1 launches per train step and eval
   batch, 24 K2 per train step, one K3 per applied update (3 for 4
   steps); no saved state carries the accumulation buffer; the best
   checkpoint restored into fresh tensors equals the state the loop
   returned bit for bit; a save followed by a train step before its
   ``wait()`` still restores the state of the save (the step rewrites
   parameters and moments in place); ``MME_EVAL_ONLY=1`` on the same
   directory reproduces the test matrix and loss. Prints the loop's
   utterances per second, peak memory,
   checkpoint size, the host ms of each save's blocking part, of each
   ``wait()`` and of each restore, free disk space and the phase's time;
   the training run goes under ``torch.profiler`` (device activity only)
   for the device's busy share of its two epochs. The eval-only run also
   sets ``MME_PREDICT_OUT`` and ``MME_EXPORT_BUNDLE`` to a temporary
   directory: phase 7's first leg.
7. The serving front ends at full width, on phase 6's trained model (bf16
   compute over fp32 weights, batch 8, 24 attention layers):
   (1) the eval-only run's exports: one prediction row per test utterance,
       probabilities summing to 1; a bundle whose program calls K1 as the
       operator ``mme_tpu_torch::flash_fwd``; export, save and load
       seconds and the bundle's size;
   (2) the bundle loaded with ``load_bundle(device="cuda")`` serves phase
       4's requests (video normalised, fixed keep-masks) against a live
       ``Predictor`` on the bundle's weights: probabilities within
       ``SERVE_TOL[bf16]``, predictions equal where the top-2 margin
       exceeds it, one K1 launch per attention layer and chunk and no
       other kernel; ms per batch of 8 of both;
   (3) a second bundle exported with ``MME_FUSED_LN=1 MME_FUSED_MLP=1``
       from the served model cut to its first ``P7_KNOBS_DEPTH`` (2)
       layers of every tower and the trunk (full width, a 0.8 GB bundle),
       served with the knobs unset: K1, K5a (8 each)
       and K4a (the cut spec's count) per chunk through the operators,
       against the cut model served live with the knobs off;
   (4) ``python -m mme_tpu_torch.cli.serve`` on the first bundle in a
       process of its own: ``/healthz`` and one float-video utterance
       against leg (2); then a live ``Predictor`` behind ``make_server`` in
       this process with 3 uint8-video utterances against the Predictor
       itself, one timed request each after a warm-up
       (``P7_HTTP_REQUESTS``). Prints ms per request and request bytes,
       the phase's time and peak memory; the temporary directory is
       deleted.
8. The rest of the fusion family at full width and depth: ``TAVFormer``,
   ``TAVForMAE2Tower``, ``TAVForW2V2`` and the sparse-MoE ``TAVMoE``, each
   ``TAVSpec(output_dim=7)`` with weights from ``init_params(spec, seed,
   model=name)``, one after another, each freed before the next:
   (1) served by ``Predictor(batch_size=8)`` on phase 4's requests in bf16
       against ``MME_FLASH=0`` (K1 per chunk: 12, 18, 12, 12), then with
       ``MME_FUSED_LN=1 MME_FUSED_MLP=1`` against the knobs-off
       probabilities (K5a: 12, 18, 12, 6; K4a from the spec,
       ``time_layer_norm.ln_sites(model=name)``); a zero-padded partial
       chunk gives its rows the probabilities of a full chunk. ``TAVMoE``
       holds both comparisons in fp32, where every token's expert set must
       agree (a flip is allowed only at a near-tie of the router, and then
       the run is not held to the fp32 tolerance but says so); its bf16 leg
       checks finite probabilities and prints how many tokens routed
       differently;
   (2) trained: fp32, no dropout, batch 4, loss and gradients with the
       kernels against ``MME_FLASH=0`` (K1 and K2 as in serving; for
       ``TAVMoE`` the aux term finite, positive and in the loss, the
       router's gradient nonzero); then four bf16 steps on one batch of 8
       with ``MME_OPT_STATE=bf16 MME_FUSED_ADAM=1`` and both knobs on: the
       eval loss after them below the one before, one K3 launch per step;
   (3) ``TAVMoE`` only: ``run_classifier(..., has_aux_loss=True)`` for one
       epoch of 4 steps and one validation (bf16, ``MME_OPT_STATE=bf16
       MME_FUSED_ADAM=1``) with ``MME_EXPORT_BUNDLE`` set, and the bundle
       loaded with ``load_bundle(device="cuda")`` against a live
       ``Predictor`` on its weights (12 K1 per chunk through the operator).
   Prints one JSON line per model: parameters, ms per batch of 8 served
   with the knobs off and on, ms per bf16 train step, peak memory, every
   launch count, the model's seconds and the card.

9. The audio classifier and the BatchNorm models at full width, each freed
   before the next:
   (1) ``Wav2Vec2Classifier(Wav2Vec2Spec.base(), output_dim=7)`` with
       weights from ``init_variables``, through ``BatchModel`` and phase
       10's legs: served by
       ``Predictor(batch_size=8)`` in bf16 on 8, 5 and 11 utterances of
       96 000 samples with ragged keep-masks (``synthetic_audio_dataset``)
       against ``MME_FLASH=0`` (12 K1 per chunk), then with both knobs on
       against both off (12 K5a, 26 K4a per chunk); fp32 loss and gradient
       norm of a batch of 8 with K1/K2 against ``MME_FLASH=0``; four bf16
       steps on one batch with ``MME_OPT_STATE=bf16 MME_FUSED_ADAM=1`` and
       both knobs (12 K1, K2, K5a, K5b, 26 K4a, K4b and one K3 per step),
       the eval loss after them below the one before; ``run_classifier``
       for one epoch of 4 steps with ``MME_EXPORT_BUNDLE``, the bundle
       against a live ``Predictor`` (12 K1 per chunk through the operator);
   (2) ``SlowR50(output_dim=7)`` at ``visual_nn``'s full size (stages
       (3, 4, 6, 3), batch 8 of 16x224x224 clips, fp32): one train step
       whose stem BatchNorm statistics are held against
       0.9 · init + 0.1 · (mean, ``var(unbiased=False)``) of the stem's
       output, three more steps with the eval loss falling, a checkpoint
       round trip restoring parameters and statistics bit for bit after a
       step moved them, a bundle against the live ``Predictor``;
   (3) ``ResnetClassifier(output_dim=2)`` at 224x224 through
       ``run_classifier`` for one epoch with ``images_nn``'s frozen-backbone
       mask: every backbone parameter but ``backbone.fc`` unchanged bit for
       bit, the running statistics moved, the head moved;
   (4) ``Conv3DClassifier`` and ``ConvNetClassifier`` at their CLIs' full
       sizes: a forward and two train steps each.
   Prints one JSON line per model: parameters, ms per served batch or train
   step, peak memory, launch counts, the model's seconds and the card.
10. The text and two-modality classifiers at full width, each with weights
   from ``init_variables`` behind ``cli/common.BatchModel`` and freed
   before the next: ``BertClassifier`` (DistilRoBERTa, 70 tokens),
   ``BertAudioClassifier`` (+ wav2vec2-base over 160 000 samples with
   ragged keep-masks), ``BertVideoMAELateFusion`` and
   ``BertVideoMAEMTLShared`` (+ VideoMAE over 16x224x224 clips),
   ``VBertClassifier`` (70 tokens and one 1 024-d visual vector, 2
   classes) and ``VideoMAEClassifier``:
   (1) served by ``Predictor(batch_size=8)`` in bf16 on 8, 5 and 11 rows
       drawn as their CLIs draw them (the MTL with a per-row task) against
       ``MME_FLASH=0`` (K1 per chunk: 6, 18, 18, 18, 12, 12), then with
       both knobs on against both off (K5a as many, K4a from
       ``time_layer_norm.classifier_ln_sites``: 0, 26, 24, 24, 0, 24);
       ``VBertClassifier``'s decoder is the word table's own tensor;
   (2) but ``VideoMAEClassifier``: fp32, no dropout, batch 8, loss and
       gradient norm with K1/K2 against ``MME_FLASH=0``; the MTL once with
       task 0 and once with task 1, the other tower's gradients exactly
       zero and the chosen tower's, ``shared_layer``'s and the head's not;
   (3) ``BertClassifier``, ``BertAudioClassifier``, the late fusion and
       ``VBertClassifier``: four bf16 steps on one batch of 8 with
       ``MME_OPT_STATE=bf16 MME_FUSED_ADAM=1`` and both knobs, every
       step's launches as served plus K2, K5b, K4b and one K3, the eval
       loss after them below the one before;
   (4) ``BertAudioClassifier`` through ``run_classifier`` for one epoch of
       4 steps with ``MME_EXPORT_BUNDLE``, the bundle against a live
       ``Predictor`` (18 K1 per chunk through the operator);
   (5) ``LSTMClassifier`` at ``text_nn``'s size (vocabulary 5 000,
       300-wide, one layer) over 8 x 70 tokens: a forward and two steps
       launching no kernel of the port;
   (6) ``text_nn`` (BERT and LSTM), ``text_audio_nn``, ``text_video_nn -m
       1MTL`` and ``visual_bert_nn`` for one synthetic epoch at batch 8 on
       the card, at their tiny specs.
   Prints one JSON line per model: parameters, ms per served batch of 8
   with the knobs off and on, ms per bf16 step, peak memory serving and
   training, launches per chunk and per step, the largest probability gap
   against ``MME_FLASH=0``, the model's seconds and the card.

11. The data path at full width, as ``cli/tav_nn``'s pickle branch runs it
   (the card's machine has no pandas, cv2 or PIL, so
   ``records.build_tav_dataset`` reads a mapping of columns in place of
   the frame):
   (1) builds the port's WAV decoder (``data/wavio.py::build_library``,
       ``g++`` on ``mme_tpu_torch/native/wavio.cpp``) and prints the
       command and its seconds;
   (2) writes 144 utterances of 1.5–11 s: most 48 kHz stereo 16-bit
       through stdlib ``wave``, some 44.1 kHz mono, 24-bit and float32
       with a header written here; 128 train (32 in each bucket of the
       160 000-sample cap, so that epoch 0's weighted draw with
       replacement still trains at least two full batches of 8 in every
       bucket), 8 validation, 8 test;
   (3) decodes them with ``load_waveforms_parallel`` natively, against the
       numpy path within 1e-5, with no fallback; prints the decode rate on
       the card machine's host CPU;
   (4) ``resample_waveform`` on the card (48 kHz → 16 kHz over
       [8, 288 000]) against ``resample_numpy`` within 1e-5;
   (5) TAV records through ``build_tav_dataset``: hash-tokenized text
       (``get_tokenizer(None, 50 265)``), ``load_audio_bucket`` at the
       cap, MELD emotion strings with ``build_label_map``'s sorted map,
       then uint8 video drawn from a seed;
   (6) ``tav_nn.build_model`` and ``tav_nn.train`` on them: full-width
       ``TAVSpec(output_dim=7)`` from ``init_params``, bf16,
       ``MME_OPT_STATE=bf16 MME_FUSED_ADAM=1 MME_FUSED_LN=1
       MME_FUSED_MLP=1``, length buckets on (``make_bucket_iter``), one
       epoch and the test pass, ``MME_PREDICT_OUT`` and the checkpoints in
       a temporary directory removed afterwards;
   (7) checks every train step and eval batch: its audio length is a
       bucket bound (every bound trains at least two steps), its
       K1/K2/K3/K4a/K4b/K5a/K5b launches are those the spec gives at the
       batch fed (K4 from ``time_layer_norm.ln_sites``: the 40 000-sample
       bucket's 992-row audio sites stay under the kernel's 1 024-row
       gate), its logits and the losses are finite, and the prediction
       log's labels are the label map's names;
   (8) prints per bucket the first and the steady (median of the rest) ms
       per step and the launches of a step, and the peak memory; holds
       every kernel against its plain version at the shapes the run fed
       it (K1/K2 at the four towers' attention in bf16, K4a/K4b at every
       LayerNorm shape the kernel takes and K5a/K5b at the four towers'
       MLPs, both in bf16 and fp32); then times K1/K2 at each bucket's
       audio and fusion lengths and K4a/K4b at its LayerNorm shapes, each
       beside its plain version, ``scaled_dot_product_attention`` or
       ``F.layer_norm`` and its bound.

12. The pretrained import at full width, as the CLIs run it with
   ``MME_PRETRAINED`` (the card's machine has no ``transformers`` and no
   ``safetensors``, and nothing is downloaded):
   (1) writes five checkpoints into a temporary directory, removed
       afterwards, in the layouts of the reference's (the name → shape
       tables ``roberta_layout``, ``wav2vec2_layout``, ``videomae_layout``,
       ``slow_r50_layout``; ``tests/test_torch_pretrained.py`` holds them
       to the ``transformers`` classes), values drawn from a seed:
       emotion-english-distilroberta-base (``model.safetensors`` by this
       script's writer, under its full repo id), wav2vec2-lg-xlsr
       (``pytorch_model.bin``, the positional conv as ``weight_g`` /
       ``weight_v``), videomae-base-finetuned-kinetics
       (``model.safetensors``), wav2vec2-base-superb-er
       (``pytorch_model.bin``, the parametrization keys) and
       ``slow_r50.pyth`` under ``model_state``, 2.44 GB in all;
   (2) per checkpoint its bytes and the seconds to draw, write, read (the
       port's safetensors reader or ``torch.load``), convert and merge
       into its model's shape-only flax tree, and load onto the card;
   (3) ``tav_nn.build_model`` at full width in bf16: the three towers
       printed; on the card, bit for bit, the word table, text layer 0's
       fused qkv weight and bias, the VideoMAE tubelet kernel and its
       q / zero k / v bias, the PreFormer's copies of the towers' leaves and
       the fusion trunk, heads and norms as ``init_params`` draws them; the
       folded positional conv within ``POS_FOLD_RTOL`` of a float64 fold;
   (4) phase 4's batch of 8 served with the knobs off and on (54 K1; 54
       K5a and 114 K4a with the knobs), then ``tav_nn.train`` for one
       epoch of 3 bf16 steps with every knob, a validation and the test
       pass, every call's K1–K5 launches as the spec gives them at the
       batch fed, and K1/K2/K4/K5 held against their plain versions at
       those shapes;
   (5) ``BertClassifier``, wav2vec2-base's ``Wav2Vec2Classifier`` and
       ``SlowR50`` at full width through ``text_nn``'s,
       ``audio_nn_wav2vec``'s and ``visual_nn``'s ``load_weights``: a leaf
       of each against its file, SlowR50's BatchNorm buffers against the
       file's running statistics, one served batch of 8 each.

13. The parallel axes, part one: two ranks on the one card. NCCL refuses
   two ranks on one GPU, so they join a gloo group (``MME_DIST_BACKEND=
   gloo``) and every collective and ring hop of a CUDA tensor goes through
   pinned host memory; the ranks are processes of a
   ``parallel/launch.py::RankPool`` started through the env contract
   (``MME_COORDINATOR`` on a free local port, ``MME_NUM_PROCESSES=2``,
   ``MME_PROCESS_ID``), each on ``cuda:0``, each call under a time limit.
   Full-width ``TAVSpec(output_dim=7)`` cut to its first ``P13_DEPTH``
   (6) layers in every tower and the trunk (24 attention layers, 307.8 M
   parameters; the whole 54-layer model before this cut), on phase 5's
   draw cut to those layers, for phases 13, 14 and 15:
   (1) on this process, the single-rank fp32 step (global batch 4, no
       dropout) whose loss, grad norm and gradients (as the optimizer is
       handed them) the ranks are held to, and the single-rank fp32
       ``Predictor``'s probabilities on phase 4's requests;
   (2) dp=2, fp32: ``replicate`` broadcasts rank 0's weights, each rank
       steps on its 2 rows: loss and grad norm as phase 5 holds them, every
       gradient leaf the optimizer is handed (after the all-reduce) within
       ``P13_GRAD_RTOL`` of its largest element in the single-rank step,
       24 K1 and K2;
   (3) dp=2, bf16 at the global batch of 8 with every knob on: 1 warm-up
       and 1 timed step, ms per step, the all-reduce's share of a step
       (timed around it, synchronised), each rank's peak memory (the two
       must fit the card), one step's launches (24 K1, K2, K5a, K5b, the
       spec's K4a/K4b at 4 rows, one K3); the warm-up's gradient
       all-reduce held leaf by leaf: one fixed projection of each leaf
       after it equals the sum of the ranks' projections before it;
   (4) sp=2 through the CLI path (``tav_nn.tav_spec``, ``parallel_spec``
       with ``MME_SP=2``, ``MME_SHARE_FRONTEND=1`` and ``MME_SP_TOWER``
       fusion, then video, ``build_model`` on the phase's weights) in fp32
       without dropout, beside the unsharded model
       on the same weights: the eval probabilities within
       ``SERVE_TOL[fp32]``, the training loss and grad norm as phase 5
       holds them, every gradient leaf within ``P13_GRAD_RTOL`` of its
       largest element, K1 and K2 per call equal to ring layers × 2 hops
       plus the other towers' layers (30), one global pre-pass per ring
       layer (6); the ring's training forward and backward timed beside
       the unsharded model's;
   (5) mesh serving: ``Predictor(mesh=dp2)`` on phase 4's requests, each
       rank computing 4 rows of a chunk, against (1)'s probabilities;
   (6) back on this process, K1 per hop and K2's kernels per hop with the
       one global pre-pass at the local shapes the ranks fed the ring, in
       fp32 and bf16, against their plain versions and against the whole
       sequence; a fully masked row's dV as a per-block pre-pass would give
       it (too large) beside the ring's, and SDPA's forward and backward
       at the same shapes. Prints the phase's seconds. Its weights are
       phase 5's draw cut to the phase's layers (no draw of their own).

14. The parallel axes, part two, on phase 13's two ranks and references:
   (1) tp, fp32: a ``("dp", "mp")`` mesh of dp=1 and mp=2,
       ``build_tav(mesh=...)`` cutting the weights by JAX's rule (the qkv
       heads and fc1 column-parallel, attention/out and fc2
       row-parallel: 6 of 12 and 8 of 16 heads, F 1536 of 3072 and 2048
       of 4096 a rank); phase 4's first request served across the mesh
       against (13)(1)'s probabilities (``SERVE_TOL[fp32]``, 24 K1 a
       chunk), then one step on the global batch of 4: loss and grad norm
       as phase 5 holds them, every gathered gradient leaf within
       ``P13_GRAD_RTOL`` of its largest single-rank element, 24 K1/K2;
   (2) tp, bf16 at the global batch of 8 with every knob: one timed step
       (no warm-up: gloo's host reductions take ~0.9 of it), the mp
       reductions' count, GB, ms and share, each rank's peak, one step's
       launches (24 K1, K2, K5a, K5b on the local shapes, the spec's K4
       at full rows, one K3 over the shards' leaves);
   (3) ep: ``TAVMoE`` at full width and the phase's depth with its
       experts cut over dp=2 (``MoESpec(ep_axis="dp", ep_mesh=...)``),
       its single-rank reference on this process first: a served chunk
       (each rank 4 rows, 6 K1) against the single-rank probabilities, one fp32 step on 2
       rows a rank (loss, grad norm, every gathered gradient leaf), then a
       second step with its ``all_to_all`` ms and share;
   (4) back here, K1/K2 at every local-heads shape the ranks fed (fp32
       at 4 and 8 rows, bf16 at 8), K5a/K5b at the local F slices (bf16)
       and K3 over the shards' leaves, each against its plain version,
       timed beside it, SDPA or the unfused MLP, with its bound.

15. Pipeline parallelism on phase 13's two ranks and references: a
   ``("dp", "pp")`` mesh of dp=1 and pp=2 from ``tav_nn.parallel_spec``
   (``MME_PP=2``, ``MME_PP_TOWER``, ``MME_PP_MICRO``), every rank holding
   the whole model and its stage's layers running as a GPipe pipeline
   (``parallel/pipeline.py``: activations and their gradients between
   the stages, the last stage's output broadcast, each staged through
   pinned host memory):
   (1) fp32 on the fusion trunk (3 of its 6 layers a stage), phase 4's
       first request served across the mesh against (13)(1)'s
       probabilities (``SERVE_TOL[fp32]``, 24 K1 a chunk at M=2: the 18
       layers every rank runs and 3 x 2), then one step on the global
       batch of 4 at M=2 against (13)(1)'s single-rank step: loss and grad
       norm as phase 5 holds them, every gradient leaf the optimizer is
       handed (stage leaves summed over pp) within ``P13_GRAD_RTOL`` of
       its largest element, 24 K1/K2;
   (2) the same step on the video tower (``MME_PP_TOWER=video``, 1 464
       tokens) at the global batch of 2 and M=2, against a single-rank
       step at 2 made on this process with (13)(1);
   (3) bf16 on the fusion trunk at the global batch of 8, M=4, every
       knob on: 1 warm-up and 1 timed step, ms, the point-to-point
       traffic's (the stages' sends and waits and the output's and input
       gradient's broadcasts) ms, GB and share, the gradient sync's ms and
       share, the bubble (P - 1) / (M + P - 1), each rank's peak, one
       step's launches against the count predicted from the spec: K1 =
       K2 = K5a = K5b = 18 (the towers every rank runs) + 3 M = 30, K4
       the spec's sites outside the trunk (the trunk's microbatch rows,
       2 x 473, fall under K4's 1 024-row gate), one K3;
   (4) back here, K1/K2 at the microbatch shapes (fusion B=2, video B=1)
       in fp32 and bf16 against their plain versions, timed beside them
       and SDPA with their bounds.
   ``python3 chip_smoke.py --parallel`` runs the build and phases 13, 14
   and 15 alone, and prints no result lines.
16. The sweeps, the forced alignment and the two timing tools:
   (1) ``cli/sweep.main`` on the card through ``text_nn`` at full width
       (DistilRoBERTa, 768 wide, 6 layers, hash-tokenised): a mapping
       pickle of MELD-like utterances (64 train / 16 validation / 16 test
       rows; the card's machine has no pandas) and ``configs/bert.yaml``'s
       space with one epoch of batch 8 and the metric ``val/loss``; six
       trials in process with bf16 moments and K3 (the sixth a TPE
       proposal); each trial's parameters against the sweep's numpy draws
       replayed on the trials before it, its K1 / K2 / K3 launches against
       the count the spec gives (6 layers x (8 steps + 4 eval batches), 6
       x 8, 8), its losses finite, trial 6's peak memory within 5 % of
       trial 1's, the best the minimum by the metric; beside them, started
       first as a process of its own (``python -m mme_tpu_torch.cli.sweep
       --workers 2``; the workers' cold start overlaps the trials), two
       workers of one trial each sharing the card: the merged results
       (the in-process run's first two trials) and each worker's own
       checkpoint directory; K3 at the sweep model's leaves against its
       plain version first;
   (2) ``cli/align.main`` on the card: 8 rows of planted-span emissions
       (``.npy``), a label file and a mapping pickle; the timings equal
       the same call with ``device="cpu"``, every planted span recovered,
       the row without emissions None;
   (3) ``flash_crossover`` at its four shapes (K1 + K2 once per flash
       call) and ``profile_towers`` at ``PROF_STEPS=3``,
       ``PROF_WINDOWS=1`` with K3 (each tower's K1 / K2 per call from the
       spec, one K3 per update).
   ``python3 chip_smoke.py --tools`` runs the build and phase 16 alone,
   and prints no result lines.

Then one JSON line of per-kernel results (seven kernels;
``launches_<model>`` gives phases 8, 9 and 10's counts: a served chunk
with both knobs on for a forward kernel, a bf16 train step for the
others, the MTL's fp32 step, 0 for a model without a train leg;
``launches_data_path`` phase 11's whole run and
``launches_data_path_step`` one of its train steps per bucket bound,
``launches_pretrained`` phase 12's train run, ``launches_parallel_dp``
a bf16 dp=2 step of rank 0 and ``launches_parallel_sp_{fusion,video}`` a
fp32 sp=2 training forward and backward of rank 0,
``launches_parallel_tp`` a bf16 mp=2 step of rank 0,
``launches_parallel_ep`` an fp32 ep=2 step of rank 0,
``launches_parallel_pp`` a bf16 pp=2 step of rank 0 and
``launches_sweep`` phase 16's first sweep trial), before it each
phase's seconds (``phase_seconds``), the card's name and power limit, and
last the line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import io
import json
import os
import pickle
import re
import select
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mme_tpu_torch.cli import (audio_nn_wav2vec, images_nn, tav_nn,
                               text_audio_nn, text_nn, text_video_nn,
                               visual_bert_nn, visual_nn)
from mme_tpu_torch.cli.common import (BatchModel, invert_label_map,
                                      make_bucket_iter, run_classifier)
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import (ShapeDtype, flax_shapes, from_flax,
                                   init_params, init_variables)
from mme_tpu_torch.data import wavio
from mme_tpu_torch.data.dataset import batches
from mme_tpu_torch.data.records import (PickleDatasetConfig,
                                        build_label_map, build_tav_dataset,
                                        get_tokenizer)
from mme_tpu_torch.data.synthetic import (synthetic_audio_dataset,
                                          synthetic_image_dataset,
                                          synthetic_tav_dataset,
                                          synthetic_text_dataset)
from mme_tpu_torch.data.wavio import load_waveforms_parallel
from mme_tpu_torch.device import PEAK_BF16_FLOPS, PEAK_BYTES, card_line
from mme_tpu_torch.models.audio import Wav2Vec2Classifier, Wav2Vec2Spec
from mme_tpu_torch.models.fusion import (FUSION_MODELS, TAVModel,
                                         TAVMoEFormer, TAVSpec)
from mme_tpu_torch.models.hf_import import (convert_slow_r50,
                                            convert_text_encoder,
                                            convert_videomae,
                                            convert_wav2vec2, state_dict_np)
from mme_tpu_torch.models.image import ConvNetClassifier, ResnetClassifier
from mme_tpu_torch.models.moe import MoEMlp, router_gates
from mme_tpu_torch.models.pretrained import (AUDIO_SUPERB, AUDIO_XLSR,
                                             SLOW_R50, TEXT_EMOTION,
                                             VIDEO_MAE, find_checkpoint_dir,
                                             load_local_state_dict,
                                             merge_params,
                                             strip_model_prefix)
from mme_tpu_torch.models.text import (BertClassifier, LSTMClassifier,
                                       TextEncoderSpec)
from mme_tpu_torch.models.text_audio import BertAudioClassifier, TextAudioSpec
from mme_tpu_torch.models.text_video import (BertVideoMAELateFusion,
                                             BertVideoMAEMTLShared,
                                             TextVideoSpec)
from mme_tpu_torch.models.video import (Conv3DClassifier, SlowR50,
                                        VideoMAEClassifier, VideoMAESpec)
from mme_tpu_torch.models.visualbert import VBertClassifier, VisualBertSpec
from mme_tpu_torch import time_adam
from mme_tpu_torch.ops import adam_update, kernels
from mme_tpu_torch.ops.adam_update import (adam_update_leaf,
                                           adam_update_leaf_plain,
                                           adam_update_leaves,
                                           adam_update_leaves_plain)
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.fused_mlp import (ACTS, fused_mlp_bwd,
                                         fused_mlp_bwd_plain, fused_mlp_fwd,
                                         fused_mlp_fwd_plain, gemm_bf16,
                                         gemm_operand_major, kernel_supports)
from mme_tpu_torch.ops.fused_mlp import bounds as mlp_bounds
from mme_tpu_torch.ops.layer_norm import bounds as ln_bounds
from mme_tpu_torch.ops.layer_norm import (fused_layer_norm_bwd,
                                          fused_layer_norm_bwd_plain,
                                          fused_layer_norm_fwd,
                                          fused_layer_norm_fwd_plain,
                                          launch_geometry, smem_bytes)
from mme_tpu_torch.ops.flash_attention import (bounds as flash_bounds,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd,
                                               flash_attention_fwd_plain)
from mme_tpu_torch.ops.resample import resample_numpy, resample_waveform
from mme_tpu_torch.ops.video import normalize_uint8_video
from mme_tpu_torch.serve import Predictor, export_bundle, load_bundle
from mme_tpu_torch.serve_http import PredictionService, make_server
from mme_tpu_torch.time_layer_norm import (classifier_ln_sites,
                                           fused_ln_shapes, fused_ln_sites,
                                           ln_sites)
from mme_tpu_torch.train.build_tav import (build_tav, example_tav_batch,
                                           make_video_keep_transform)
from mme_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from mme_tpu_torch.train.losses import cross_entropy
from mme_tpu_torch.train.optim import AdamWState, global_norm_f32
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_eval_step,
                                       make_optimizer, make_train_step,
                                       model_buffers, to_device)

SEED = 0
# tolerances of the flash kernel against its plain version, elementwise
# |O - O_plain| <= atol + rtol |O_plain| and relative on LSE:
# fp32 — both sum fp32 products, in other orders: a few fp32 ulps of |O|;
# bf16 — the kernel rounds the unnormalised P to bf16 and the plain version
# the normalised probabilities, and O itself is rounded to bf16 (one ulp is
# 2^-8 relative): a bf16 ulp or two of |O|; LSE is summed in fp32 on both
# sides.
TOL = {torch.float32: {"atol": 1e-5, "rtol": 1e-5, "lse": 1e-5},
       torch.bfloat16: {"atol": 2e-2, "rtol": 1e-2, "lse": 1e-3}}
# served probabilities, flash against MME_FLASH=0 on the same weights and
# requests: fp32 agrees to fp32 rounding carried through 54 attention
# layers; bf16 carries the per-layer bf16 differences above through the
# towers' depth (24 audio layers)
SERVE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# gradients of the flash backward against its plain version, as a share of
# each gradient's largest element (a gradient that is zero but for
# cancellation is held to a twentieth of the largest of the three): fp32 —
# sums of up to 1568 fp32 products in another order; bf16 — P and dS are
# rounded to bf16 on both sides at fp32 values that differ in the last
# place, and the result is rounded to bf16 once more. The kernel has no
# atomics: two runs give the same bits.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# fused Adam: the update `out` may differ from the plain version's by this
# many fp32 units in the last place (division and square root round to
# nearest on both sides; measured 0); the moments must be equal
ADAM_OUT_ULPS = 2
# training, kernels against MME_FLASH=0 from the same state, fp32 compute:
# fp32 rounding carried through 54 layers, forward and backward
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-3
# fused LayerNorm against its plain version, elementwise |y - y_plain| <=
# atol + rtol |y_plain| on y and dx: both sides compute in fp32 and differ by
# an ulp or so (rsqrt, fused multiply-adds) before the cast, so a few fp32
# ulps, or one bf16 step after a bf16 cast; dscale and dbias are fp32 sums
# over up to 153 592 rows in another order, held to 1e-4 of their largest
# element. No atomics: two runs give the same bits.
LN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
LN_SUM_RTOL = 1e-4
# fused MLP against its plain version, as a share of each tensor's largest
# element: fp32 — sums of up to 4096 (dW: N) fp32 products in another order;
# bf16 — `a` and `dh` are rounded to bf16 on both sides at fp32 values that
# differ in the last place and each result is rounded to bf16 once more.
# db1 and db2 are fp32 sums on both sides (1e-4 in bf16, where db1 sums the
# unrounded dh). No atomics: two runs give the same bits.
MLP_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MLP_BIAS_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}
# both knobs on against both off, same weights and inputs: served
# probabilities as SERVE_TOL; training in fp32 as TRAIN_*_RTOL (LayerNorm
# and the MLP products summed in other orders through 54 layers)
KNOBS = {"MME_FUSED_LN": "1", "MME_FUSED_MLP": "1"}
# (name, batch, seq, heads) of the attention calls of one served chunk:
# 6 text, 24 audio, 12 video and 12 fusion layers, head_dim 64
SERVED = (("text", 8, 70, 12, 6), ("audio", 8, 299, 16, 24),
          ("video", 8, 1464, 12, 12), ("fusion", 8, 473, 12, 12))
LAUNCHES_PER_CHUNK = sum(n for *_, n in SERVED)   # 54
# (name, seq, key mask) of phase 10's attention calls beyond SERVED's, batch
# 8, 12 heads of 64: wav2vec2-base over 160 000 samples, VideoMAE over
# 16x224x224 clips (no key mask), VisualBERT's 70 tokens and 1 visual
SLICE_ATTENTION = (("audio_base_160k", 499, True), ("videomae", 1568, False),
                   ("visualbert", 71, True))
# the audio samples of phase 11's length buckets below the cap (the cap's
# 499 frames are phase 10's): quarters of the CLI's 160 000
BUCKET_SAMPLES = (40000, 80000, 120000)


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory and spills of every kernel in one
    source's ``-Xptxas -v`` output (the fused MLP's shared memory is
    dynamic, sized per launch)."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    return {"kernels": len(regs), "registers": sorted(regs),
            "max_registers": max(regs), "spill_bytes": sum(spills),
            "static_smem_bytes": sorted(set(smem))}


def kernel_ptxas(log: str) -> list:
    """Registers, spill bytes and static shared memory of every kernel in
    one source's ``-Xptxas -v`` output, by kernel and template arguments
    (D and element type; for LayerNorm x and y or g in bf16 (1) or fp32 (0)
    and the chunks per thread)."""
    out = []
    # ptxas names each kernel whose wgmma it serialised (C7512, C7515, ...)
    serialized = set(re.findall(r"are serialized[^\n]*'([^'\n]+)'", log))
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"'([^'\n]+)'", block).group(1)
        # _ZN..._<source>_cu_<8 hex digits><length><kernel name>I...
        at = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
        base = (name[at.end():at.end() + int(at.group(1))] if at
                else name)
        args = re.findall(r"Li(\d+)E", name)
        if "bfloat16" in name:
            args.append("bf16")
        elif re.search(r"IfLi", name):
            args.append("fp32")
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", block)
        out.append({"kernel": base + "<" + ",".join(args) + ">",
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": (int(spills.group(1)) + int(spills.group(2))
                                    if spills else None),
                    "static_smem_bytes": int(smem.group(1)) if smem else 0,
                    "serialized_wgmma": name in serialized})
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def attention_inputs(B, Sq, Sk, H, D, dtype, masked_rows, seed):
    """q, k, v as strided views of fused QKV tensors (the layout the model
    hands the kernel) and a key-mask bias with ragged lengths; the first
    ``masked_rows`` batch rows have every key masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, Sk, 3, H, D, generator=g, device="cuda").to(dtype)
    q = qkv[:, :, 0] if Sq == Sk else torch.randn(
        B, Sq, 3, H, D, generator=g, device="cuda").to(dtype)[:, :, 0]
    lengths = torch.randint(1, Sk + 1, (B,), generator=g, device="cuda")
    lengths[:masked_rows] = 0
    keep = torch.arange(Sk, device="cuda")[None, :] < lengths[:, None]
    bias = additive_mask(keep)[:, 0, 0, :]
    return q, qkv[:, :, 1], qkv[:, :, 2], bias


def flash_fwd_hold(name, B, Sq, Sk, H, D, dtype, masked, has_bias,
                   seed) -> float:
    """K1 against its plain version on one case; raises if they disagree.
    Returns max |O - O_plain|."""
    q, k, v, bias = attention_inputs(B, Sq, Sk, H, D, dtype, masked, seed)
    bias = bias if has_bias else None
    o, lse = flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, bias)
    tol = TOL[dtype]
    d = (o.float() - o_ref.float()).abs()
    err = d.max().item()
    excess = (d - tol["rtol"] * o_ref.float().abs()).max().item()
    lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)
               ).max().item()
    finite = bool(torch.isfinite(o.float()).all())
    print(f"flash_fwd {name:12s} {str(dtype)[6:]:8s} B={B} Sq={Sq} "
          f"Sk={Sk} H={H} D={D} bias={has_bias} masked_rows={masked}: "
          f"max|dO|={err:.3e}, max(|dO| - rtol|O|)={excess:.3e} "
          f"(atol {tol['atol']}, rtol {tol['rtol']}); "
          f"max rel dLSE={lse_err:.3e} (tol {tol['lse']})", flush=True)
    if not (finite and excess <= tol["atol"] and lse_err <= tol["lse"]):
        raise SystemExit(f"flash_fwd disagrees with its plain version "
                         f"on case {name} {dtype}")
    return err


def check_flash(card: str):
    """Phase 3. Returns (max |O - O_plain| over all cases, per-shape
    results at the served bf16 shapes)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, H, _ in SERVED:
            masked = 0 if name == "video" else 1
            cases.append((name, B, S, S, H, 64, dtype, masked,
                          name != "video"))
        cases.append(("audio_base", 8, 299, 299, 12, 64, dtype, 1, True))
        cases += [(name, 8, s, s, 12, 64, dtype, int(bias), bias)
                  for name, s, bias in SLICE_ATTENTION]
        cases += [(name, 8, s, s, h, 64, dtype, 1, True)
                  for samples in BUCKET_SAMPLES
                  for name, s, h in bucket_attention(TAVSpec(), samples)]
        cases.append(("ragged_d128", 3, 100, 333, 4, 128, dtype, 1, True))
    max_err = max(flash_fwd_hold(*case, seed=i)
                  for i, case in enumerate(cases))

    shapes = []
    for i, (name, B, S, H, n) in enumerate(SERVED):
        q, k, v, bias = attention_inputs(B, S, S, H, 64, torch.bfloat16,
                                         0, 100 + i)
        bias = None if name == "video" else bias
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, bias))
        plain = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, bias),
                        iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        (flops, nbytes, bound, by), _ = flash_bounds(B, S, S, H, 64, 2,
                                                     bias is not None)
        row = {"shape": name, "B": B, "S": S, "H": H, "D": 64,
               "dtype": "bf16", "launches_per_chunk": n, "ms": ms,
               "tflops": flops / ms / 1e9, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_by": by, "card": card}
        print(json.dumps({"flash_fwd_shape": row}), flush=True)
        shapes.append(row)
    return max_err, shapes


def grads_close(got, want, dtype):
    """(ok, largest error as a share of its tolerance, largest |error|)."""
    floor = 0.05 * max(b.float().abs().max().item() for b in want)
    worst, worst_abs, finite = 0.0, 0.0, True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        finite = finite and bool(torch.isfinite(a).all())
        err = (a - b).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst = max(worst, err / (BWD_TOL[dtype]
                                  * max(b.abs().max().item(), floor)))
    return finite and worst <= 1.0, worst, worst_abs


def flash_bwd_hold(name, B, Sq, Sk, H, D, dtype, masked, has_bias,
                   sentinel, seed) -> float:
    """K2 against its plain version on one case (``sentinel``: the last
    row's keys all at -inf); raises if they disagree. Returns the largest
    |error| of dQ, dK, dV."""
    q, k, v, bias = attention_inputs(B, Sq, Sk, H, D, dtype, masked, seed)
    bias = bias if has_bias else None
    if sentinel:
        bias = bias.clone()
        bias[-1] = float("-inf")       # every score -inf in this row
    g = torch.Generator(device="cuda").manual_seed(1000 + seed)
    do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    out, lse = flash_attention_fwd(q, k, v, bias)
    got = flash_attention_bwd(q, k, v, bias, out, lse, do)
    again = flash_attention_bwd(q, k, v, bias, out, lse, do)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, bias, out, lse, do)
    ok, share, err = grads_close(got, want, dtype)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # a row masked by bias keeps the uniform P (dV not zero); a sentinel row
    # gets no gradient at all
    masked_dv = got[2][0].float().abs().max().item() if masked else None
    dead = (all(bool((x[-1] == 0).all()) for x in got) if sentinel
            else None)
    print(f"flash_bwd {name:12s} {str(dtype)[6:]:8s} B={B} Sq={Sq} "
          f"Sk={Sk} H={H} D={D} bias={has_bias} masked_rows={masked}: "
          f"max|dgrad|={err:.3e} = {share:.3f} of tolerance "
          f"({BWD_TOL[dtype]} of max|grad|); two runs equal {same}; "
          f"max|dV| of the masked row {masked_dv}; sentinel row zero "
          f"{dead}", flush=True)
    if not (ok and same and (masked_dv is None or sentinel
                             or masked_dv > 0)
            and dead is not False):
        raise SystemExit(f"flash_bwd disagrees with its plain version "
                         f"on case {name} {dtype}")
    return err


def check_flash_bwd(card: str):
    """Phase 3, K2. Returns (max |error| over all cases, per-shape results
    at the bf16 model shapes)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, H, _ in SERVED:
            masked = 0 if name == "video" else 1
            cases.append((name, B, S, S, H, 64, dtype, masked,
                          name != "video", False))
        cases.append(("audio_base", 8, 299, 299, 12, 64, dtype, 1, True,
                      False))
        cases += [(name, 8, s, s, 12, 64, dtype, int(bias), bias, False)
                  for name, s, bias in SLICE_ATTENTION]
        cases += [(name, 8, s, s, h, 64, dtype, 1, True, False)
                  for samples in BUCKET_SAMPLES
                  for name, s, h in bucket_attention(TAVSpec(), samples)]
        cases.append(("ragged_d128", 3, 100, 333, 4, 128, dtype, 1, True,
                      False))
        cases.append(("sentinel", 3, 130, 130, 4, 64, dtype, 1, True, True))
    max_err = max(flash_bwd_hold(*case, seed=i)
                  for i, case in enumerate(cases))

    shapes = []
    for i, (name, B, S, H, n) in enumerate(SERVED):
        q, k, v, bias = attention_inputs(B, S, S, H, 64, torch.bfloat16,
                                         0, 200 + i)
        bias = None if name == "video" else bias
        do = torch.randn(B, S, H, 64, device="cuda").to(torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, bias)
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, bias, out, lse, do))
        plain = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, bias, out, lse, do), iters=3, warmup=1)
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        do_t = do.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, do_t,
                                                  retain_graph=True))
        _, (flops, nbytes, bound, by) = flash_bounds(B, S, S, H, 64, 2,
                                                     bias is not None)
        row = {"shape": name, "B": B, "S": S, "H": H, "D": 64,
               "dtype": "bf16", "launches_per_step": n, "ms": ms,
               "tflops": flops / ms / 1e9, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_by": by, "card": card}
        print(json.dumps({"flash_bwd_shape": row}), flush=True)
        shapes.append(row)
        del o_lib, leaves
    return max_err, shapes


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in fp32 units in the last place."""
    ia = a.float().contiguous().view(torch.int32).long()
    ib = b.float().contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max().item())


def adam_leaf(shape, seed, gdtype=torch.float32, offset=0):
    """A leaf's gradient and moments on the card; with ``offset`` each is a
    view that many elements into its storage (1: not 16-byte aligned)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))

    def at(x, dtype):
        buf = torch.empty(n + offset, dtype=dtype, device="cuda")
        buf[offset:] = x
        return buf[offset:].view(shape)

    return (at(torch.randn(n, generator=g, device="cuda") * 1e-3, gdtype),
            at(torch.randn(n, generator=g, device="cuda") * 1e-3,
               torch.bfloat16),
            at(torch.rand(n, generator=g, device="cuda") * 1e-6,
               torch.bfloat16))


def adam_same_bits(got, want) -> Tuple[bool, int]:
    """(every moment bit-equal, largest ulp distance of out) of two
    (outs, mu's, nu's) lists."""
    exact = all(torch.equal(a, b) for xs, ys in zip(got[1:], want[1:])
                for a, b in zip(xs, ys))
    return exact, max(ulps(a, b) for a, b in zip(got[0], want[0]))


def check_adam(spec: TAVSpec, card: str):
    """Phase 3, K3. Returns (max |out - out_plain|, times and bound of one
    call over the step's trainable leaves and over its 235 big ones)."""
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    bc1, bc2 = 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    max_err = 0.0
    # embedding, an MLP weight (port layout), an audio MLP weight, a conv
    for i, shape in enumerate(((50265, 768), (3072, 768), (1024, 4096),
                               (512, 512, 3))):
        grad, mu, nu = adam_leaf(shape, 300 + i)
        out, mu2, nu2 = adam_update_leaf(grad, mu, nu, bc1, bc2, 7,
                                         zero_noise=True, **kw)
        torch.cuda.synchronize()
        o_ref, mu_ref, nu_ref = adam_update_leaf_plain(
            grad, mu, nu, bc1, bc2, zero_noise=True, **kw)
        exact = torch.equal(mu2, mu_ref) and torch.equal(nu2, nu_ref)
        d_ulp = ulps(out, o_ref)
        err = (out - o_ref).abs().max().item()
        max_err = max(max_err, err)

        # with noise: each moment is one of its fp32 value's two bf16
        # neighbours, the mean error is within 5 standard errors (the
        # truncated value's is far outside), and the dither differs
        # between leaves (seed) and between steps (seed)
        m32 = 0.9 * mu.float() + (1.0 - 0.9) * grad
        bits = m32.view(torch.int32) & -65536
        lo, hi = bits.view(torch.float32), (bits + 65536).view(torch.float32)
        noisy = adam_update_leaf(grad, mu, nu, bc1, bc2, 11, **kw)
        a = noisy[1].float()
        b = adam_update_leaf(grad, mu, nu, bc1, bc2, 11, **kw)[1].float()
        c = adam_update_leaf(grad, mu, nu, bc1, bc2, 12, **kw)[1].float()
        bracket = bool(((a == lo) | (a == hi)).all())
        e = (a - m32).double()
        n = e.numel()
        se = e.std().item() / n ** 0.5
        mean_err, trunc = e.mean().item(), (lo.abs() - m32.abs()).double(
            ).mean().item()
        seeded = torch.equal(a, b) and not torch.equal(a, c)
        # noise on, the same Philox words: the plain version's bits
        same, n_ulp = adam_same_bits(
            [[x] for x in noisy],
            adam_update_leaves_plain([grad], [mu], [nu], bc1, bc2, [11],
                                     **kw))
        print(f"adam_update {str(shape):14s}: zero_noise moments equal "
              f"{exact}, out within {d_ulp} ulp (tol {ADAM_OUT_ULPS}); "
              f"noise: neighbours {bracket}, mean error {mean_err:.3e} = "
              f"{abs(mean_err) / se:.2f} standard errors (tol 5; "
              f"truncation {trunc / se:.1f}), same seed same bits and "
              f"other seed other bits {seeded}; same words as the plain "
              f"version: moments equal {same}, out within {n_ulp} ulp",
              flush=True)
        if not (exact and d_ulp <= ADAM_OUT_ULPS and bracket and seeded
                and abs(mean_err) <= 5 * se and trunc < -20 * se
                and same and n_ulp <= ADAM_OUT_ULPS):
            raise SystemExit(f"adam_update check failed on leaf {shape}")
        del grad, mu, nu, noisy, a, b, c, e, m32

    # one launch over a mixed list, fresh and in place, noise on
    specs = [((1,), torch.float32, 0), ((7,), torch.bfloat16, 0),
             ((768,), torch.float32, 0), ((70001,), torch.bfloat16, 0),
             ((3072, 768), torch.float32, 0), ((4099,), torch.float32, 1),
             ((50265, 768), torch.bfloat16, 0)]
    leaves = [adam_leaf(shape, 400 + k, dt, off)
              for k, (shape, dt, off) in enumerate(specs)]
    gs, mus, nus = (list(x) for x in zip(*leaves))
    seeds = [(5 << 20) + k for k in range(len(specs))]
    before = kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED
    fresh = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    torch.cuda.synchronize()
    counted = (kernels.LAUNCHES["adam_update"] - before[0],
               adam_update.LEAVES_FUSED - before[1])
    want = adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds, **kw)
    same, n_ulp = adam_same_bits(fresh, want)
    max_err = max(max_err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(fresh[0], want[0])))
    inplace = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, outs=gs,
                                 mu_outs=mus, nu_outs=nus, **kw)
    torch.cuda.synchronize()
    aliased = all(torch.equal(a, b) for xs, ys in zip(inplace, fresh)
                  for a, b in zip(xs, ys)) and all(
        x is y for xs, ys in zip(inplace, (gs, mus, nus))
        for x, y in zip(xs, ys))
    print(json.dumps({"adam_update_mixed": {
        "leaves": [[list(sh), str(dt), off] for sh, dt, off in specs],
        "launches": counted[0], "leaves_covered": counted[1],
        "moments_equal_plain": same, "out_ulps": n_ulp,
        "in_place_equals_fresh": aliased, "card": card}}), flush=True)
    if not (counted == (1, len(specs)) and same and n_ulp <= ADAM_OUT_ULPS
            and aliased):
        raise SystemExit("adam_update check failed on the mixed list")
    del leaves, gs, mus, nus, fresh, want, inplace
    torch.cuda.empty_cache()

    # one call over the step's trainable leaves (and its 235 big ones):
    # wrapper, kernel alone, host
    timed = time_adam.with_bounds(time_adam.time_tree())
    # the step's launch (past 32 leaves warp 0 searches in rounds) against
    # the plain version on the same inputs and words, which is timed too
    sizes = time_adam.step_leaf_sizes(spec)
    gs, mus, nus = time_adam.leaf_state(sizes, 1)
    seeds = [(9 << 20) + k for k in range(len(sizes))]
    got = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    want = []

    def plain():
        want[:] = [adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds,
                                            **kw)]

    timed["all"]["plain_ms"] = cuda_ms(plain, iters=1, warmup=1)
    same, n_ulp = adam_same_bits(got, want[0])
    max_err = max(max_err, max((a - b).abs().max().item()
                               for a, b in zip(got[0], want[0][0])))
    timed["all"].update(moments_equal_plain=same, out_ulps=n_ulp)
    del gs, mus, nus, got, want
    torch.cuda.empty_cache()
    print(json.dumps({"adam_update_step": timed, "card": card}), flush=True)
    if not (same and n_ulp <= ADAM_OUT_ULPS):
        raise SystemExit("adam_update check failed over the step's "
                         f"{len(sizes)} leaves")
    return max_err, timed


@contextlib.contextmanager
def environ(values: dict):
    """``values`` set in ``os.environ`` for the enclosed calls."""
    os.environ.update(values)
    try:
        yield
    finally:
        for k in values:
            del os.environ[k]


def knobs_on():
    """MME_FUSED_LN=1 and MME_FUSED_MLP=1 for the enclosed calls."""
    return environ(KNOBS)


def mlp_shapes(spec: TAVSpec, batch: int, text_len: int = 70,
               samples: int = 96000):
    """(name, rows, hidden, intermediate, layers) of the four towers' MLPs."""
    frames = samples
    for k, st in zip(spec.audio.conv_kernels, spec.audio.conv_strides):
        frames = (frames - k) // st + 1
    towers = (("text", spec.text.encoder, batch * text_len),
              ("audio", spec.audio.encoder, batch * frames),
              ("video", spec.video.encoder,
               batch * (spec.video.num_patches - spec.video_keep_k)),
              ("fusion", spec.fusion,
               batch * (text_len + frames + spec.video_keep_k)))
    return [(name, n, e.hidden, e.intermediate, e.layers)
            for name, e, n in towers]


def ln_case(n, h, xdtype, ydtype, seed, offset=0):
    """With ``offset`` rows, x is a row-offset view: its base pointer is not
    the allocation's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n + offset, h, generator=g, device="cuda") * 2
         + 0.5).to(xdtype)[offset:]
    w = 1 + 0.3 * torch.randn(h, generator=g, device="cuda")
    b = 0.2 * torch.randn(h, generator=g, device="cuda")
    gy = torch.randn(n, h, generator=g, device="cuda").to(ydtype)
    return x, w, b, gy


def ln_hold(n, h, xdt, ydt, seed, offset=0, eps=1e-5) -> Tuple[float,
                                                                 float]:
    """K4a and K4b against their plain versions on one case; raises if
    they disagree. Returns (max |dy|, max |d(dx)|)."""
    x, w, b, gy = ln_case(n, h, xdt, ydt, seed, offset)
    y = fused_layer_norm_fwd(x, w, b, eps, ydt)
    got = fused_layer_norm_bwd(gy, x, w, eps)
    again = fused_layer_norm_bwd(gy, x, w, eps)
    torch.cuda.synchronize()
    y0 = fused_layer_norm_fwd_plain(x, w, b, eps, ydt)
    want = fused_layer_norm_bwd_plain(gy, x, w, eps)

    def excess(a, ref, dt):
        atol, rtol = LN_TOL[dt]
        d = (a.float() - ref.float()).abs()
        return d.max().item(), (d - rtol * ref.float().abs()
                                ).max().item() - atol

    e_y, x_y = excess(y, y0, ydt)
    e_dx, x_dx = excess(got[0], want[0], xdt)
    sums = max(((a - r).abs().max() / r.abs().max().clamp(min=1e-12)
                ).item() for a, r in zip(got[1:], want[1:]))
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (y,) + tuple(got))
    print(f"layer_norm N={n} H={h} x {str(xdt)[6:]} y {str(ydt)[6:]}"
          f"{' (row-offset view)' if offset else ''}: "
          f"max|dy|={e_y:.3e}, max|d(dx)|={e_dx:.3e} (atol, rtol "
          f"{LN_TOL[ydt]}, {LN_TOL[xdt]}); dscale, dbias within "
          f"{sums:.3e} of their largest element (tol {LN_SUM_RTOL}); "
          f"two runs equal {same}", flush=True)
    if not (finite and same and x_y <= 0 and x_dx <= 0
            and sums <= LN_SUM_RTOL and y.dtype == ydt
            and got[0].dtype == xdt):
        raise SystemExit(f"fused layer norm disagrees with its plain "
                         f"version at N={n} H={h} {xdt}")
    return e_y, e_dx


def check_layer_norm(spec: TAVSpec, card: str):
    """Phase 3, K4a and K4b. Returns the forward's and the backward's entry
    for the kernels line, times and bounds summed over the launches of one
    training step of the bf16 bench configuration."""
    eps = 1e-5
    shapes = [(2392, 1024), (11712, 768), (3784, 768), (153592, 512),
              (2392, 768), (2392, 512),                      # wav2vec2-base
              (3992, 768), (3992, 512),           # at 160 000 samples
              (12544, 768),                                  # VideoMAE
              # the 1 024-row gate: rows the module leaves to F.layer_norm
              # (phase 11's 992-row audio sites) and just over
              (992, 1024), (1023, 1024), (1024, 1024), (1025, 1024),
              (1992, 1024), (992, 512),
              (3001, 768),                                   # one ragged N
              (1024, 8192)]                                  # the widest row
    cases = [(n, h, dt, dt, 0) for dt in (torch.bfloat16, torch.float32)
             for n, h in shapes]
    cases.append((2392, 1024, torch.float32, torch.bfloat16, 0))  # fp32 → bf16
    cases.append((2392, 1024, torch.bfloat16, torch.bfloat16, 8))  # row view
    errs = [ln_hold(n, h, xdt, ydt, 400 + i, offset)
            for i, (n, h, xdt, ydt, offset) in enumerate(cases)]
    err_fwd, err_bwd = (max(e) for e in zip(*errs))

    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0}
    bwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0}
    rows = []
    dt = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (n, h), count in sorted(fused_ln_shapes(spec, 8).items()):
        x, w, b, gy = ln_case(n, h, dt, dt, n % 1000)
        # the library's weight and bias in the input's type, cast once
        lx, lw, lb = (t.detach().to(dt).requires_grad_() for t in (x, w, b))
        ly = F.layer_norm(lx, (h,), lw, lb, eps)
        t = {"fwd": cuda_ms(lambda: fused_layer_norm_fwd(x, w, b, eps, dt)),
             "fwd_plain": cuda_ms(lambda: fused_layer_norm_fwd_plain(
                 x, w, b, eps, dt), iters=5, warmup=1),
             "fwd_library": cuda_ms(lambda: F.layer_norm(
                 x, (h,), lw, lb, eps)),
             "bwd": cuda_ms(lambda: fused_layer_norm_bwd(gy, x, w, eps)),
             "bwd_plain": cuda_ms(lambda: fused_layer_norm_bwd_plain(
                 gy, x, w, eps), iters=5, warmup=1),
             "bwd_library": cuda_ms(lambda: torch.autograd.grad(
                 ly, (lx, lw, lb), gy, retain_graph=True))}
        # x in, y out, scale and bias; g and x in, dx out, scale in and the
        # two [H] sums out: the same work whatever implements it
        (_, fwd_bytes, fwd_bound, _), (_, bwd_bytes, bwd_bound, _) = \
            ln_bounds(n, h, 2)
        geom = launch_geometry(n, h, sms)
        rows.append({"N": n, "H": h, "dtype": "bf16",
                     "launches_per_step": count, **t,
                     "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
                     "grid": geom.grid, "rows_per_team": geom.rows_per_team,
                     "smem_fwd": smem_bytes(geom, h, 2),
                     "smem_bwd": smem_bytes(geom, h, 2, 2)})
        for tot, key, nb in ((fwd, "fwd", fwd_bytes), (bwd, "bwd", bwd_bytes)):
            tot["ms"] += t[key] * count
            tot["plain_ms"] += t[key + "_plain"] * count
            tot["library_ms"] += t[key + "_library"] * count
            tot["nbytes"] += nb * count
        del ly, lx
    print(json.dumps({"layer_norm_shapes": rows, "card": card}), flush=True)
    out = []
    for tot, err in ((fwd, err_fwd), (bwd, err_bwd)):
        nbytes = tot.pop("nbytes")
        out.append({**tot, "max_abs_err": err, "bound_by": "bytes",
                    "bound_ms": nbytes / PEAK_BYTES * 1e3})
    return out


def mlp_case(n, h, f, dtype, seed):
    """x is a row-offset view, so its base pointer is not the allocation's."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = r(n + 8, h).to(dtype)[8:]
    w1 = (r(f, h) * h ** -0.5).to(dtype)
    w2 = (r(h, f) * f ** -0.5).to(dtype)
    return x, w1, r(f) * 0.1, w2, r(h) * 0.1, r(n, h).to(dtype)


def gemm_operand(rows, cols, mn, g):
    """A [rows, cols] bf16 operand contracted along `cols`, stored with
    `rows` contiguous when `mn`, else `cols`, in storage padded past the
    extent (the row stride is not the extent)."""
    inner, outer = (rows, cols) if mn else (cols, rows)
    store = torch.randn(outer, (inner + 7) // 8 * 8 + 8, generator=g,
                        device="cuda").to(torch.bfloat16)
    return store[:, :inner].t() if mn else store[:, :inner]


def check_gemm_core(card: str):
    """Phase 3, the wgmma/TMA product core of K5a and K5b alone: C = A B
    against an fp32 product of the same bf16 operands at the four operand
    orders, every extent ragged against the 128 x 128 x 64 tiles (the last
    extents on more tiles than the card has SMs), and at the orders and
    extents of the video tower's five products."""
    cases = [(m, n, k, a_mn, b_mn)
             for m, n, k in ((5, 3, 7), (200, 136, 328), (300, 520, 1000),
                             (4000, 1100, 136))
             for a_mn in (0, 1) for b_mn in (0, 1)]
    cases += [(11712, 3072, 768, 0, 0), (11712, 768, 3072, 0, 0),
              (3072, 768, 11712, 1, 1), (11712, 768, 3072, 0, 1)]
    worst = 0.0
    for i, (m, n, k, a_mn, b_mn) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(700 + i)
        a = gemm_operand(m, k, a_mn, g)
        b = gemm_operand(n, k, b_mn, g).t()
        assert (gemm_operand_major(a, 1), gemm_operand_major(b, 0)) \
            == (a_mn, b_mn)
        c = gemm_bf16(a, b)
        torch.cuda.synchronize()
        ref = torch.matmul(a.float(), b.float())
        share = ((c.float() - ref).abs().max().item()
                 / (MLP_TOL[torch.bfloat16] * ref.abs().max().item()))
        worst = max(worst, share)
        print(f"gemm core M={m} N={n} K={k} A {'MN' if a_mn else 'K'}-major"
              f" B {'MN' if b_mn else 'K'}-major: error {share:.3f} of "
              "tolerance", flush=True)
        if not (share <= 1.0 and bool(torch.isfinite(c.float()).all())):
            raise SystemExit(f"gemm core disagrees at M={m} N={n} K={k} "
                             f"orders ({a_mn}, {b_mn})")
    print(json.dumps({"gemm_core_cases": len(cases),
                      "worst_share_of_tolerance": worst, "card": card}),
          flush=True)


def mlp_hold(name, n, h, f, dt, act, seed) -> Tuple[float, float]:
    """K5a and K5b against their plain versions on one case; raises if
    they disagree. Returns (max |d out|, the largest |error| of the five
    gradients)."""
    x, w1, b1, w2, b2, do = mlp_case(n, h, f, dt, seed)
    out = fused_mlp_fwd(x, w1, b1, w2, b2, act)
    got = fused_mlp_bwd(x, w1, b1, w2, do, act)
    again = fused_mlp_bwd(x, w1, b1, w2, do, act)
    torch.cuda.synchronize()
    out0 = fused_mlp_fwd_plain(x, w1, b1, w2, b2, act)
    want = fused_mlp_bwd_plain(x, w1, b1, w2, do, act)
    shares, worst, err_fwd, err_bwd = {}, 0.0, 0.0, 0.0
    names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    for key, a, ref in zip(names, (out,) + got, (out0,) + want):
        tol = (MLP_BIAS_TOL if key.startswith("db") else MLP_TOL)[dt]
        d = (a.float() - ref.float()).abs().max().item()
        shares[key] = d / (tol * ref.float().abs().max().item())
        if key == "out":
            err_fwd = d
        else:
            err_bwd = max(err_bwd, d)
        worst = max(worst, shares[key])
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out,) + got)
    print(f"fused_mlp {name:9s} {str(dt)[6:]:8s} {act:8s} N={n} H={h} "
          f"F={f}: error as a share of tolerance "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
          + f" (tol {MLP_TOL[dt]} of max, biases {MLP_BIAS_TOL[dt]}); "
          f"two runs equal {same}", flush=True)
    if not (finite and same and worst <= 1.0):
        raise SystemExit(f"fused mlp disagrees with its plain version "
                         f"on case {name} {dt} {act}")
    return err_fwd, err_bwd


def mlp_times(name, n, h, f, layers, seed) -> dict:
    """K5a and K5b at one bf16 shape (gelu), each timed beside its plain
    version and the unfused PyTorch MLP's forward or backward, with its
    bound and TFLOP/s."""
    x, w1, b1, w2, b2, do = mlp_case(n, h, f, torch.bfloat16, seed)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, w1, b1.bfloat16(), w2, b2.bfloat16())]

    def unfused():
        lx, lw1, lb1, lw2, lb2 = leaves
        return F.linear(F.gelu(F.linear(lx, lw1, lb1)), lw2, lb2)

    lib_out = unfused()
    t = {"fwd": cuda_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2)),
         "fwd_plain": cuda_ms(lambda: fused_mlp_fwd_plain(
             x, w1, b1, w2, b2), iters=3, warmup=1),
         "fwd_library": cuda_ms(unfused),
         "bwd": cuda_ms(lambda: fused_mlp_bwd(x, w1, b1, w2, do), iters=10),
         "bwd_plain": cuda_ms(lambda: fused_mlp_bwd_plain(
             x, w1, b1, w2, do), iters=3, warmup=1),
         "bwd_library": cuda_ms(lambda: torch.autograd.grad(
             lib_out, leaves, do, retain_graph=True))}
    del lib_out, leaves
    bounds = mlp_bounds(n, h, f, 2)
    return {"shape": name, "N": n, "H": h, "F": f, "dtype": "bf16",
            "launches_per_step": layers, **t,
            "fwd_bound_ms": bounds[0][2], "fwd_bound_by": bounds[0][3],
            "bwd_bound_ms": bounds[1][2], "bwd_bound_by": bounds[1][3],
            "fwd_tflops": bounds[0][0] / t["fwd"] / 1e9,
            "bwd_tflops": bounds[1][0] / t["bwd"] / 1e9}


def check_fused_mlp(spec: TAVSpec, card: str):
    """Phase 3, K5a and K5b. Returns the forward's and the backward's entry
    for the kernels line, summed over the 54 launches of one step."""
    towers = mlp_shapes(spec, 8)
    if not all(kernel_supports(h, f, torch.bfloat16)
               for _, _, h, f, _ in towers):
        raise SystemExit("a full-width MLP is outside the kernels' shape rule")
    cases = [(name, n, h, f, torch.bfloat16, "gelu")
             for name, n, h, f, _ in towers]
    cases.append(("wav2vec2_base", 2392, 768, 3072, torch.bfloat16, "gelu"))
    # phase 10's: wav2vec2-base at 160 000 samples, VideoMAE, VisualBERT
    cases += [(name, n, 768, 3072, dt, "gelu")
              for dt in (torch.bfloat16, torch.float32)
              for name, n in (("w2v_base_160k", 3992), ("videomae", 12544),
                              ("visualbert", 568))]
    cases += [("small", 300, 256, 512, dt, act)
              for dt in (torch.float32, torch.bfloat16) for act in ACTS]
    cases += [("ragged", n, h, f, torch.bfloat16, act)
              for n, h, f, act in ((1, 256, 64, "gelu"),
                                   (17, 512, 192, "gelu_new"),
                                   (129, 768, 320, "relu"),
                                   (129, 1024, 256, "tanh"))]
    cases.append(("fp32_wide", 300, 768, 3072, torch.float32, "gelu"))
    errs = [mlp_hold(*case, seed=500 + i) for i, case in enumerate(cases)]
    err_fwd, err_bwd = (max(e) for e in zip(*errs))

    totals = [dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0, nbytes=0)
              for _ in range(2)]
    rows = []
    for i, (name, n, h, f, layers) in enumerate(towers):
        t = mlp_times(name, n, h, f, layers, 600 + i)
        rows.append(t)
        for tot, key, (flops, nbytes, _, _) in zip(
                totals, ("fwd", "bwd"), mlp_bounds(n, h, f, 2)):
            tot["ms"] += t[key] * layers
            tot["plain_ms"] += t[key + "_plain"] * layers
            tot["library_ms"] += t[key + "_library"] * layers
            tot["flops"] += flops * layers
            tot["nbytes"] += nbytes * layers
    print(json.dumps({"fused_mlp_shapes": rows, "card": card}), flush=True)
    out = []
    for tot, err in zip(totals, (err_fwd, err_bwd)):
        flops, nbytes = tot.pop("flops"), tot.pop("nbytes")
        by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out.append({**tot, "max_abs_err": err,
                    "bound_ms": max(by_ops, by_bytes) * 1e3,
                    "bound_by": "operations" if by_ops >= by_bytes
                    else "bytes"})
    return out



def requests(spec: TAVSpec):
    """Ragged requests of 8, 5 and 11 utterances with uint8 video; some
    rows carry shorter text and audio."""
    out = []
    for i, n in enumerate((8, 5, 11)):
        r = example_tav_batch(spec, n, 70, 96000, seed=SEED + 1 + i)
        r["video"] = np.clip(r["video"] * 64 + 128, 0, 255).astype(np.uint8)
        r["text_mask"][1::3, 40:] = 0
        r["audio_mask"][1::2, 60000:] = 0
        out.append(r)
    return out


def serve(pred: Predictor, reqs):
    probs = [pred(r)[1] for r in reqs]
    torch.cuda.synchronize()
    return probs


def main_path(card: str):
    """Phase 4. Returns the flash launches of the bf16 (served) run and the
    launches of the bf16 run with both knobs on."""
    spec = TAVSpec(output_dim=7)
    ln_per_chunk = sum(fused_ln_shapes(spec, 8).values())
    t0 = time.perf_counter()
    state = from_flax(init_params(spec, SEED))
    n_params = sum(v.numel() for v in state.values())
    print(f"weights: {n_params / 1e6:.1f} M parameters drawn and converted "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    reqs = requests(spec)
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    served_launches = served_fused = None
    for dtype in (torch.float32, torch.bfloat16):
        leg = "fp32" if dtype == torch.float32 else "bf16"
        model = TAVModel(spec.with_compute_dtype(dtype), device="cuda")
        model.load_state_dict(state, strict=True)
        pred = Predictor(model, batch_size=8, device="cuda")
        serve(pred, reqs[:1])                       # warm-up: cuDNN, build
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        got = serve(pred, reqs)
        launches = kernels.LAUNCHES["flash_fwd"]
        os.environ["MME_FLASH"] = "0"
        try:
            ref = serve(pred, reqs)
            plain_launches = kernels.LAUNCHES["flash_fwd"] - launches
        finally:
            del os.environ["MME_FLASH"]
        diff = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
        sums = max(float(np.abs(p.sum(-1) - 1).max()) for p in got)
        shapes_ok = all(p.shape == (len(r["input_ids"]), 7)
                        for p, r in zip(got, reqs))
        finite = all(np.isfinite(p).all() for p in got + ref)
        print(f"serve {leg}: {chunks} chunks, flash launches {launches} "
              f"(expected {LAUNCHES_PER_CHUNK * chunks}), with MME_FLASH=0 "
              f"{plain_launches}; max|probs - probs(MME_FLASH=0)| = "
              f"{diff:.3e} (tol {SERVE_TOL[dtype]}); max|sum-1| = "
              f"{sums:.2e}; finite {finite}", flush=True)
        if not (finite and shapes_ok and sums < 1e-5
                and launches == LAUNCHES_PER_CHUNK * chunks
                and plain_launches == 0 and diff <= SERVE_TOL[dtype]):
            raise SystemExit(f"serving check failed in the {leg} leg")

        # the same requests with MME_FUSED_LN=1 and MME_FUSED_MLP=1
        with knobs_on():
            serve(pred, reqs[:1])                   # warm-up
            kernels.reset_launches()
            fused = serve(pred, reqs)
            count = dict(kernels.LAUNCHES)
        diff_f = max(float(np.abs(a - b).max()) for a, b in zip(fused, got))
        finite_f = all(np.isfinite(p).all() for p in fused)
        print(f"serve {leg}, both knobs on: launches {count} (expected "
              f"{LAUNCHES_PER_CHUNK * chunks} flash_fwd and fused_mlp_fwd, "
              f"{ln_per_chunk * chunks} layer_norm_fwd, no backward); "
              f"max|probs - probs(knobs off)| = {diff_f:.3e} (tol "
              f"{SERVE_TOL[dtype]}); finite {finite_f}", flush=True)
        if not (finite_f and diff_f <= SERVE_TOL[dtype]
                and count["flash_fwd"] == count["fused_mlp_fwd"]
                == LAUNCHES_PER_CHUNK * chunks
                and count["layer_norm_fwd"] == ln_per_chunk * chunks
                and count["flash_bwd"] == count["fused_mlp_bwd"]
                == count["layer_norm_bwd"] == 0):
            raise SystemExit(f"serving with both knobs on failed in the "
                             f"{leg} leg")
        if dtype == torch.bfloat16:
            served_launches = launches
            served_fused = {k: v // chunks for k, v in count.items()}
            one = reqs[0]
            times = []
            for _ in range(5):
                t = time.perf_counter()
                pred(one)
                times.append(time.perf_counter() - t)
            ms = float(np.median(times)) * 1e3
            with knobs_on():
                times_f = []
                for _ in range(5):
                    t = time.perf_counter()
                    pred(one)
                    times_f.append(time.perf_counter() - t)
            print(json.dumps({"serve_bf16": {
                "ms_per_batch_of_8": ms, "utt_per_s": 8e3 / ms,
                "times_ms": [x * 1e3 for x in times],
                "ms_per_batch_of_8_knobs_on":
                    float(np.median(times_f)) * 1e3,
                "times_ms_knobs_on": [x * 1e3 for x in times_f],
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                "card": card}}), flush=True)
        del pred, model
        torch.cuda.empty_cache()
    return served_launches, served_fused


def train_inputs(spec: TAVSpec, batch_size: int, seed: int):
    batch = example_tav_batch(spec, batch_size, 70, 96000, seed=seed)
    batch["text_mask"][1::3, 40:] = 0
    batch["audio_mask"][1::2, 60000:] = 0
    labels = np.arange(batch_size) % 7
    return (batch, labels, np.ones(batch_size, np.int32),
            np.ones(7, np.float32))


def without_noise(spec: TAVSpec) -> TAVSpec:
    """Every dropout rate and SpecAugment probability 0."""
    def quiet(e):
        return dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        spec, dropout=0.0,
        text=dataclasses.replace(spec.text, encoder=quiet(spec.text.encoder)),
        audio=dataclasses.replace(spec.audio, mask_time_prob=0.0,
                                  mask_feature_prob=0.0,
                                  encoder=quiet(spec.audio.encoder)),
        video=dataclasses.replace(spec.video,
                                  encoder=quiet(spec.video.encoder)),
        fusion=quiet(spec.fusion))


def tower_norms(model, grads):
    """Global gradient norm per top-level tower."""
    groups = {}
    for (name, _), g in zip(model.named_parameters(), grads):
        parts = name.split(".")
        key = parts[0] if parts[0] != "model" else parts[1]
        groups.setdefault(key, []).append(g)
    return {k: global_norm_f32(v).item() for k, v in groups.items()}


def train_check_fp32(params, card: str):
    """Phase 5 (1): loss and gradients of one batch, kernels against
    MME_FLASH=0, fp32 compute, no dropout, full depth, batch 4."""
    spec = dataclasses.replace(without_noise(TAVSpec(output_dim=7)),
                               share_audio_frontend=True)
    cfg = ExperimentConfig(batch_size=4, learning_rate=5e-6, text_max_len=70,
                           audio_max_samples=96000)
    model, state, _, _ = build_tav(spec, cfg, 1000, params=params,
                                   remat=False, use_accum=False,
                                   device="cuda")
    batch, labels, mask, cw = train_inputs(spec, 4, SEED + 20)
    batch = to_device(batch, "cuda")
    labels, mask, cw = (torch.as_tensor(x, device="cuda")
                        for x in (labels, mask, cw))
    model.train()

    def loss_and_grads():
        kernels.reset_launches()
        loss = cross_entropy(model(batch), labels, cw, mask)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, state.params)]
        torch.cuda.synchronize()
        return (loss.item(), global_norm_f32(grads).item(),
                tower_norms(model, grads), dict(kernels.LAUNCHES))

    loss, norm, towers, count = loss_and_grads()
    os.environ["MME_FLASH"] = "0"
    try:
        loss0, norm0, towers0, count0 = loss_and_grads()
    finally:
        del os.environ["MME_FLASH"]
    with knobs_on():
        loss_f, norm_f, towers_f, count_f = loss_and_grads()
    rel = {k: abs(towers[k] - towers0[k]) / max(towers0[k], 1e-12)
           for k in towers0}
    rel_f = {k: abs(towers_f[k] - towers[k]) / max(towers[k], 1e-12)
             for k in towers}
    n_ln = sum(fused_ln_shapes(spec, 4).values())
    print(json.dumps({"train_check_fp32": {
        "batch": 4, "loss": loss, "loss_plain": loss0, "grad_norm": norm,
        "grad_norm_plain": norm0, "tower_norms": towers,
        "tower_norm_rel_diff": rel, "launches": count,
        "launches_plain": count0, "loss_knobs_on": loss_f,
        "grad_norm_knobs_on": norm_f,
        "tower_norm_rel_diff_knobs_on_vs_off": rel_f,
        "launches_knobs_on": count_f, "expected_layer_norm_launches": n_ln,
        "card": card}}), flush=True)
    ok_f = (np.isfinite(loss_f) and abs(loss_f - loss) <= TRAIN_LOSS_RTOL
            * abs(loss) and abs(norm_f - norm) <= TRAIN_NORM_RTOL * norm
            and max(rel_f.values()) <= TRAIN_NORM_RTOL
            and count_f["flash_fwd"] == count_f["flash_bwd"]
            == count_f["fused_mlp_fwd"] == count_f["fused_mlp_bwd"]
            == LAUNCHES_PER_CHUNK
            and count_f["layer_norm_fwd"] == count_f["layer_norm_bwd"] == n_ln
            and count["fused_mlp_fwd"] == count["layer_norm_fwd"] == 0)
    if not ok_f:
        raise SystemExit("training check with both knobs on against both "
                         "off failed")
    ok = (np.isfinite(loss) and abs(loss - loss0) <= TRAIN_LOSS_RTOL
          * abs(loss0) and abs(norm - norm0) <= TRAIN_NORM_RTOL * norm0
          and max(rel.values()) <= TRAIN_NORM_RTOL
          and count["flash_fwd"] == count["flash_bwd"] == LAUNCHES_PER_CHUNK
          and count0["flash_fwd"] == count0["flash_bwd"] == 0)
    if not ok:
        raise SystemExit("training check against MME_FLASH=0 failed")


def train_descends_bf16(params, card: str):
    """Phase 5 (2): a few steps on one fixed batch with dropout off. The
    model is deterministic, so the eval loss after the last update is the
    next point of the same series; it must lie below the first loss."""
    spec = dataclasses.replace(
        without_noise(TAVSpec(output_dim=7)).with_compute_dtype(
            torch.bfloat16), share_audio_frontend=True)
    lr = 5e-6
    cfg = ExperimentConfig(batch_size=8, learning_rate=lr, text_max_len=70,
                           audio_max_samples=96000)
    model, state, train_step, eval_step = build_tav(
        spec, cfg, 1000, params=params, remat=False, use_accum=False,
        device="cuda")
    batch, labels, mask, cw = train_inputs(spec, 8, SEED + 30)
    losses = []
    for _ in range(4):
        state, loss, cm, _ = train_step(state, batch, labels, mask, cw, 1.0,
                                        True, SEED)
        losses.append(loss.item())
    ev_loss, ev_cm, preds = eval_step(batch, labels, mask, cw)
    losses.append(ev_loss.item())
    print(json.dumps({"train_descends_bf16": {
        "lr": lr, "losses": losses, "cm_sum": int(cm.sum()),
        "card": card}}), flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and int(cm.sum()) == 8 and int(ev_cm.sum()) == 8
            and preds.shape == (8,)):
        raise SystemExit("the deterministic bf16 training leg did not "
                         "lower its loss")


def train_bench(params, card: str):
    """Phase 5 (3), (4) and (5): the benchmark configuration, the same
    state with MME_FUSED_ADAM=1, and the same state with MME_FUSED_LN=1 and
    MME_FUSED_MLP=1. Returns the launches of one timed step of each leg."""
    spec = dataclasses.replace(
        TAVSpec(output_dim=7).with_compute_dtype(torch.bfloat16),
        share_audio_frontend=True)
    cfg = ExperimentConfig(batch_size=8, learning_rate=5e-6, text_max_len=70,
                           audio_max_samples=96000)
    os.environ["MME_OPT_STATE"] = "bf16"
    try:
        model, state, train_step, _ = build_tav(
            spec, cfg, 1000, params=params, remat=False, use_accum=False,
            device="cuda")
    finally:
        del os.environ["MME_OPT_STATE"]
    batch, labels, mask, cw = train_inputs(spec, 8, SEED + 40)
    batch = to_device(batch, "cuda")
    before = [p.detach().clone() for p in state.params[:8]]
    n_trainable = sum(m is not None for m in state.opt_state.mu)
    n_ln = sum(fused_ln_shapes(spec, 8).values())
    fused_names = ("fused_mlp_fwd", "fused_mlp_bwd", "layer_norm_fwd",
                   "layer_norm_bwd")

    def run(steps):
        out, times, counts = [], [], []
        for _ in range(steps):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, loss, cm, gnorm = train_step(state, batch, labels, mask, cw,
                                            1.0, True, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            out.append((loss.item(), gnorm.item()))
            counts.append(dict(kernels.LAUNCHES))
        return out, times, counts

    # forward / backward / optimizer split of the same step, by hand with
    # the step's own pieces and CUDA events
    tx = make_optimizer(cosine_warm_restarts(5e-6, cfg.T_max, 1000),
                        cfg.weight_decay, cfg.clip, None, "bf16")
    labels_t, mask_t, cw_t = (torch.as_tensor(x, device="cuda")
                              for x in (labels, mask, cw))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def split_ms():
        split = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            model.train()
            ev[0].record()
            loss = cross_entropy(model(batch, rng=gen), labels_t, cw_t,
                                 mask_t)
            ev[1].record()
            grads = torch.autograd.grad(loss, state.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, state.params)]
            ev[2].record()
            tx.update(state.params, grads, state.opt_state, gen)
            ev[3].record()
            torch.cuda.synchronize()
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        return [float(x) for x in np.median(np.array(split), axis=0)]

    def device_kernels():
        """Device kernels (and copies) per step, from a profiler window of
        two steps after a one-step window that warms the profiler."""
        for steps in (1, 2):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                run(steps)
        return sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) // 2

    run(2)                                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    res, times, counts = run(4)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_kernels = device_kernels()
    moved = max((a - b.detach()).abs().max().item()
                for a, b in zip(before, state.params[:8]))
    moments_bf16 = all(m.dtype == torch.bfloat16
                       for m in state.opt_state.mu + state.opt_state.nu)
    ms = float(np.median(times))
    ok = (all(np.isfinite(x) for r in res for x in r) and moved > 0
          and moments_bf16 and all(
              c["flash_fwd"] == c["flash_bwd"] == LAUNCHES_PER_CHUNK
              and c["adam_update"] == 0
              and all(c[k] == 0 for k in fused_names) for c in counts))
    print(json.dumps({"train_bf16": {
        "ms_per_step": ms, "utt_per_s": 8e3 / ms, "times_ms": times,
        "losses": [r[0] for r in res], "grad_norms": [r[1] for r in res],
        "max_memory_allocated_gb": peak, "launches_per_step": counts[-1],
        "device_kernels_per_step": n_kernels, "params_moved": moved,
        "moments_bf16": moments_bf16, "card": card}}), flush=True)
    if not ok:
        raise SystemExit("the bf16 training leg failed its checks")
    (fwd, bwd, opt) = split_ms()
    print(json.dumps({"train_bf16_split_ms": {
        "forward": fwd, "backward": bwd, "optimizer_unfused": opt,
        "card": card}}), flush=True)

    # (4) one K3 launch per step over every trainable leaf, the moments
    # updated in place from the first fused step on
    os.environ["MME_FUSED_ADAM"] = "1"
    try:
        run(1)
        moments = [m for m in state.opt_state.mu + state.opt_state.nu
                   if m is not None]
        ptrs = [m.data_ptr() for m in moments]
        torch.cuda.reset_peak_memory_stats()
        leaves0 = adam_update.LEAVES_FUSED
        res_f, times_f, counts_f = run(3)
        covered = (adam_update.LEAVES_FUSED - leaves0) / 3
        peak_f = torch.cuda.max_memory_allocated() / 1e9
        kept = [m.data_ptr() for m in state.opt_state.mu
                + state.opt_state.nu if m is not None] == ptrs and all(
            m.dtype == torch.bfloat16 for m in moments)
        n_kernels_f = device_kernels()
        (fwd_f, bwd_f, opt_fused) = split_ms()
    finally:
        del os.environ["MME_FUSED_ADAM"]
    del moments
    ms_f = float(np.median(times_f))
    print(json.dumps({"train_bf16_fused_adam": {
        "ms_per_step": ms_f, "ms_per_step_unfused": ms, "times_ms": times_f,
        "losses": [r[0] for r in res_f], "trainable_leaves": n_trainable,
        "leaves_covered_per_step": covered,
        "moments_bf16_in_place": kept,
        "launches_per_step": counts_f[-1],
        "device_kernels_per_step": n_kernels_f,
        "device_kernels_per_step_unfused": n_kernels,
        "max_memory_allocated_gb": peak_f,
        "max_memory_allocated_gb_unfused": peak,
        "split_ms": {"forward": fwd_f, "backward": bwd_f,
                     "optimizer_fused": opt_fused},
        "optimizer_unfused_ms": opt, "card": card}}), flush=True)
    if not (all(np.isfinite(x) for r in res_f for x in r) and all(
            c["adam_update"] == 1
            and c["flash_fwd"] == c["flash_bwd"] == LAUNCHES_PER_CHUNK
            for c in counts_f) and covered == n_trainable and kept
            and abs(peak_f - peak) <= 0.2):
        raise SystemExit("the MME_FUSED_ADAM=1 training leg failed")

    # (5) the same state and batch with both knobs on
    torch.cuda.empty_cache()
    with knobs_on():
        run(2)                                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        res_k, times_k, counts_k = run(4)
        peak_k = torch.cuda.max_memory_allocated() / 1e9
        (fwd_k, bwd_k, opt_k) = split_ms()
    ms_k = float(np.median(times_k))
    print(json.dumps({"train_bf16_knobs_on": {
        "knobs": KNOBS, "ms_per_step": ms_k, "ms_per_step_knobs_off": ms,
        "utt_per_s": 8e3 / ms_k, "times_ms": times_k,
        "losses": [r[0] for r in res_k], "grad_norms": [r[1] for r in res_k],
        "max_memory_allocated_gb": peak_k,
        "max_memory_allocated_gb_knobs_off": peak,
        "split_ms": {"forward": fwd_k, "backward": bwd_k,
                     "optimizer_unfused": opt_k},
        "split_ms_knobs_off": {"forward": fwd, "backward": bwd,
                               "optimizer_unfused": opt},
        "launches_per_step": counts_k[-1],
        "expected_layer_norm_launches": n_ln, "card": card}}), flush=True)
    if not (all(np.isfinite(x) for r in res_k for x in r) and all(
            c["flash_fwd"] == c["flash_bwd"] == c["fused_mlp_fwd"]
            == c["fused_mlp_bwd"] == LAUNCHES_PER_CHUNK
            and c["layer_norm_fwd"] == c["layer_norm_bwd"] == n_ln
            and c["adam_update"] == 0 for c in counts_k)):
        raise SystemExit("the training leg with both knobs on failed")
    return counts[-1], counts_f[-1], counts_k[-1]


def train_path(card: str):
    """Phase 5. Returns the flax tree and the launches of one step of the
    bf16 leg, of the fused-Adam leg and of the leg with both knobs on."""
    t0 = time.perf_counter()
    params = init_params(dataclasses.replace(TAVSpec(output_dim=7),
                                             share_audio_frontend=True), SEED)
    print(f"train weights drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for leg in (train_check_fp32, train_descends_bf16):
        t0 = time.perf_counter()
        leg(params, card)
        torch.cuda.empty_cache()
        print(f"{leg.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return (params, *train_bench(params, card))


# phase 6: the loop at full width. Train, validation and test utterances
# with their seeds; the train split's dialogs hold 16 utterances, so epoch 1
# (dialog accumulation) applies one update per two batches of 8. Two
# batches an epoch: both epochs' paths at the least depth
LOOP_SIZES = ((16, 0), (8, 1), (8, 2))
# every tower's and the trunk's first layers the loop trains (full width):
# its checkpoints and phase 7's bundle hold half the weights
LOOP_DEPTH = 6
LOOP_DIALOG = 16
LOOP_CFG = dict(batch_size=8, epoch=2, log_val=2, patience=10,
                learning_rate=5e-6, mask=True, output_dim=7,
                dataset="synthetic", seed=SEED)
LOOP_ENV = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1"}
# 4 train steps, 3 applied updates (2 in epoch 0, 1 in epoch 1), 2
# validations of one batch and one test batch
LOOP_STEPS, LOOP_UPDATES, LOOP_EVAL_BATCHES = 4, 3, 3
LOOP_VALIDATIONS = 2
# eval-only against the trained run's test pass: the same weights, masks
# and kernels (no atomics); the loss is a mean of fp32 values
EVAL_ONLY_RTOL = 1e-6


class TimedCheckpoints(CheckpointManager):
    """The loop's checkpoint manager with host times: the blocking part of
    each ``save_best`` and each ``restore_best`` (the ``wait()`` they start
    with counted apart) and each ``wait()``; whether every saved state was
    stripped of its accumulation buffer; the target of the last restore,
    which is the state the loop returns."""

    def __init__(self, directory: str):
        super().__init__(directory)
        self.ms = {"save_best": [], "wait": [], "restore_best": []}
        self.stripped = []
        self.returned = None

    def _timed(self, key, fn, *args):
        n = len(self.ms["wait"])
        t = time.perf_counter()
        out = fn(*args)
        self.ms[key].append((time.perf_counter() - t) * 1e3
                            - sum(self.ms["wait"][n:]))
        return out

    def wait(self):
        t = time.perf_counter()
        super().wait()
        self.ms["wait"].append((time.perf_counter() - t) * 1e3)

    def save_best(self, state, meta):
        self.stripped.append(state.accum_grads is None)
        self._timed("save_best", super().save_best, state, meta)

    def restore_best(self, target_state):
        self.returned = target_state
        return self._timed("restore_best", super().restore_best,
                           target_state)


def empty_state_like(state: TrainState) -> TrainState:
    """A state of the same structure in new, uninitialised tensors."""
    def like(xs):
        return None if xs is None else [
            None if x is None else torch.empty_like(x) for x in xs]
    o = state.opt_state
    return TrainState(
        step=-1, params=like(state.params), accum_grads=None,
        opt_state=AdamWState(count=-1, mu=like(o.mu), nu=like(o.nu),
                             seed=-1, nu_row=like(o.nu_row),
                             nu_col=like(o.nu_col)),
        names=state.names)


def state_diff(a: TrainState, b: TrainState) -> list:
    """What differs between two states, bit for bit: counters by name,
    tensor groups by how many tensors differ."""
    out = [k for k, x, y in (("step", a.step, b.step),
                             ("count", a.opt_state.count, b.opt_state.count),
                             ("seed", a.opt_state.seed, b.opt_state.seed))
           if x != y]
    groups = (("params", a.params, b.params),
              *((k, getattr(a.opt_state, k), getattr(b.opt_state, k))
                for k in ("mu", "nu", "nu_row", "nu_col")))
    for key, xs, ys in groups:
        if xs is None or ys is None:
            if xs is not ys:
                out.append(key)
            continue
        bad = sum((x is None) != (y is None) or (
            x is not None and not torch.equal(x, y)) for x, y in zip(xs, ys))
        if bad or len(xs) != len(ys):
            out.append(f"{key}: {bad} of {len(xs)}")
    return out


def loop_inputs(params, spec: TAVSpec, device: str, text_len: int,
                audio_len: int):
    """A model with ``params`` and the synthetic train, validation and test
    splits of phase 6."""
    (n_train, s_train), *evals = LOOP_SIZES
    train_ds = synthetic_tav_dataset(spec, n_train, text_len, audio_len,
                                     seed=s_train, dialog_size=LOOP_DIALOG)
    val_ds, test_ds = (synthetic_tav_dataset(spec, n, text_len, audio_len,
                                             seed=s) for n, s in evals)
    model = TAVModel(spec, device=device)
    model.load_state_dict(from_flax(params), strict=True)
    return model, train_ds, val_ds, test_ds


def busy_share(prof, wall_s: float) -> float:
    """The share of ``wall_s`` in which the device ran anything: the union
    of the device events' spans in a profiler window."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6 / wall_s


def loop_run(params, spec: TAVSpec, device: str, directory: str,
             text_len: int = 70, audio_len: int = 96000,
             front_ends: Optional[str] = None,
             profile: bool = False) -> dict:
    """Phase 6's runs on ``device`` (the CPU runs them at a tiny size):
    ``run_classifier`` trains and tests; the best checkpoint is restored
    into fresh tensors; a save is followed by a train step before its
    ``wait()``; ``MME_EVAL_ONLY=1`` tests the checkpoint again, and with
    ``front_ends`` (a directory) writes the serving exports there too:
    ``MME_PREDICT_OUT`` rows and an ``MME_EXPORT_BUNDLE`` bundle (phase 7's
    first leg). ``profile``: the training run under ``torch.profiler``
    (device activity only), for the device's busy share of its two
    epochs. Checks all but the kernel launches and returns what it
    measured."""
    cfg = ExperimentConfig(**LOOP_CFG, checkpoint_dir=directory,
                           text_max_len=text_len, audio_max_samples=audio_len)
    model, train_ds, val_ds, test_ds = loop_inputs(
        params, spec, device, text_len, audio_len)
    n_train = len(train_ds)
    transform = make_video_keep_transform(spec, random_mask=True)
    ckpts = TimedCheckpoints(directory)

    kernels.reset_launches()
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profile
        else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        summary = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                                 batch_transform=transform,
                                 checkpoints=ckpts, device=device)
        if profile:
            torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    busy = busy_share(prof, loop_s) if profile else None
    launches = dict(kernels.LAUNCHES)
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    train_logs = [d for d in logs if "train/loss" in d]
    losses = [d[k] for d in logs for k in ("train/loss", "val/loss",
                                           "test/loss") if k in d]
    state = ckpts.returned

    # the best checkpoint into fresh tensors
    fresh = empty_state_like(state)
    t = time.perf_counter()
    ckpts.restore_best(fresh)
    round_trip = state_diff(fresh, state)

    # the in-place trap: one more step rewrites parameters and moments
    # while the save is in flight
    ckpts.save_best(state, {"epoch": cfg.epoch, "step": state.step,
                            "val_loss": 0.0})
    tx = make_optimizer(cosine_warm_restarts(cfg.learning_rate, cfg.T_max,
                                             n_train // cfg.batch_size),
                        cfg.weight_decay, cfg.clip)
    batch, labels, mask, _ = next(batches(train_ds, np.arange(n_train),
                                          cfg.batch_size))
    batch = transform(torch.Generator(device=device).manual_seed(SEED),
                      to_device(batch, device))
    make_train_step(model, tx, num_classes=cfg.output_dim)(
        state, batch, labels, mask, np.ones(cfg.output_dim, np.float32),
        1.0, True, SEED)
    stepped = [k for k in state_diff(state, fresh)
               if k.startswith(("params", "mu", "nu"))]
    ckpts.wait()
    ckpts.restore_best(state)
    trap = state_diff(state, fresh)
    del fresh

    eval_env = {"MME_EVAL_ONLY": "1",
                "MME_RUN_DIR": os.path.join(directory, "eval_only")}
    if front_ends is not None:
        eval_env.update(MME_PREDICT_OUT=os.path.join(front_ends, ROWS_FILE),
                        MME_EXPORT_BUNDLE=os.path.join(front_ends, "bundle"))
    os.environ.update(eval_env)
    try:
        again = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                               batch_transform=transform, device=device)
    finally:
        for k in eval_env:
            del os.environ[k]
    exports = {}
    with open(os.path.join(eval_env["MME_RUN_DIR"], "metrics.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if "export_bundle" in d or "predict_out" in d:
                exports.update(d)
    eval_rel = (abs(again["test/loss"] - summary["test/loss"])
                / abs(summary["test/loss"]))
    out = {
        "loop_s": loop_s, "device_busy_share": busy, "launches": launches,
        "utt_per_s_loop": [d["train/steps_per_sec"] * cfg.batch_size
                           for d in train_logs],
        "epochs": [d["epoch"] for d in train_logs],
        "losses": losses, "test_loss": summary["test/loss"],
        "saved_states_stripped": ckpts.stripped,
        "round_trip_diff": round_trip, "in_place_step_changed": stepped,
        "in_place_trap_diff": trap, "eval_only_loss_rel_diff": eval_rel,
        "eval_only_same_matrix": (again["test/confusion_matrix"]
                                  == summary["test/confusion_matrix"]),
        "checkpoint_gb": os.path.getsize(os.path.join(
            ckpts.best_path, STATE_FILE)) / 1e9,
        "save_best_ms": ckpts.ms["save_best"], "wait_ms": ckpts.ms["wait"],
        "restore_best_ms": ckpts.ms["restore_best"],
        "serving_exports": exports, "test_rows": len(test_ds)}
    ok = (all(np.isfinite(losses)) and sorted(set(out["epochs"])) == [0, 1]
          and len([d for d in logs if "val/loss" in d]) == LOOP_VALIDATIONS
          and len(ckpts.stripped) >= 2 and all(ckpts.stripped)
          and not round_trip and stepped and not trap
          and out["eval_only_same_matrix"] and eval_rel <= EVAL_ONLY_RTOL)
    if not ok:
        print(json.dumps({"train_loop_failed": out}), flush=True)
        raise SystemExit("the training loop phase failed its checks")
    return out


def tav_layers(spec: TAVSpec) -> int:
    """Attention layers of a ``TAVModel``: K1 launches per served chunk."""
    return (spec.text.encoder.layers + spec.audio.encoder.layers
            + spec.video.encoder.layers + spec.fusion.layers)


def cut_tree(tree: dict, shapes: dict) -> dict:
    """``tree``'s leaves at the paths of ``shapes`` (a flax tree of a
    model cut by :func:`depth_cut`)."""
    return {k: cut_tree(tree[k], v) if isinstance(v, dict) else tree[k]
            for k, v in shapes.items()}


def train_loop(params, card: str, front_dir: str
               ) -> Tuple[dict, dict, TAVSpec]:
    """Phase 6 on the card; its eval-only run writes phase 7's prediction
    log and bundle into ``front_dir``. Returns the kernel launches of the
    loop's run, what the eval-only run's exports logged and the spec."""
    t0 = time.perf_counter()
    spec = depth_cut(dataclasses.replace(
        TAVSpec(output_dim=7, dropout=0.1).with_compute_dtype(torch.bfloat16),
        share_audio_frontend=True), LOOP_DEPTH)
    params = cut_tree(params, flax_shapes(TAVModel(spec, device="meta")))
    directory = tempfile.mkdtemp(prefix="mme_loop_")
    free_gb = shutil.disk_usage(directory).free / 1e9
    os.environ.update(LOOP_ENV)
    try:
        torch.cuda.reset_peak_memory_stats()
        out = loop_run(params, spec, "cuda", directory,
                       front_ends=front_dir, profile=True)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for k in LOOP_ENV:
            del os.environ[k]
        shutil.rmtree(directory, ignore_errors=True)
    n = out["launches"]
    layers = tav_layers(spec)
    want = {"flash_fwd": layers * (LOOP_STEPS + LOOP_EVAL_BATCHES),
            "flash_bwd": layers * LOOP_STEPS,
            "adam_update": LOOP_UPDATES}
    print(json.dumps({"train_loop": {
        **out, "depth": LOOP_DEPTH, "expected_launches": want,
        "max_memory_allocated_gb": peak, "free_disk_gb_before": free_gb,
        "phase_s": time.perf_counter() - t0, "card": card}}), flush=True)
    if any(n.get(k, 0) != v for k, v in want.items()):
        raise SystemExit("the training loop did not launch K1, K2 and K3 "
                         "as its steps and updates need")
    return n, {**out["serving_exports"], "test_rows": out["test_rows"]}, spec


# phase 7: the serving front ends at full width, on phase 6's trained
# model. The prediction log's file name in the exports directory; the
# requests of phase 4 (8, 5 and 11 utterances) with their video normalised
# on the host and their own fixed keep-masks, the features a bundle of the
# TAV model takes
ROWS_FILE = "predictions.jsonl"
# (3)'s knobs-on bundle: the served model cut to its first layers in every
# tower and the trunk (full width), enough to show K1, K4a and K5a served
# through the operators; (4)'s timed HTTP requests after one warm-up
P7_KNOBS_DEPTH = 2
P7_HTTP_REQUESTS = 1
HTTP_TIMEOUT_S = 300


def bundle_requests(spec: TAVSpec) -> list:
    out = []
    for r in requests(spec):
        r = dict(r)
        r["video"] = normalize_uint8_video(torch.from_numpy(r["video"])).numpy()
        out.append(r)
    return out


def median_ms(fn, batch, n: int = 5) -> Tuple[float, list]:
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn(batch)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), times


def served_diff(got, want, tol: float) -> Tuple[float, bool]:
    """max |Δprobs| over the requests, and whether the predictions agree
    wherever the reference's top-2 margin exceeds ``tol``."""
    diff, same = 0.0, True
    for (p, pr), (q, qr) in zip(got, want):
        diff = max(diff, float(np.abs(pr - qr).max()))
        top = np.sort(qr, -1)
        sure = top[:, -1] - top[:, -2] > tol
        same = same and bool((p[sure] == q[sure]).all())
    return diff, same


def http_json(url: str, payload: Optional[bytes] = None):
    req = urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
        return json.loads(r.read())


def instances(batch: dict, rows) -> bytes:
    return json.dumps({"instances": [{k: v[i].tolist()
                                      for k, v in batch.items()}
                                     for i in rows]}).encode()


def start_daemon(bundle: str) -> Tuple[subprocess.Popen, str]:
    """``python -m mme_tpu_torch.cli.serve`` on a free port, as a user
    starts it; returns the process and its URL once it listens."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mme_tpu_torch.cli.serve", "--bundle",
         bundle, "--host", "127.0.0.1", "--port", "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + HTTP_TIMEOUT_S
    lines = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            continue
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(r"on (http://[\d.]+:\d+)", line)
        if m:
            return proc, m.group(1)
    stop_daemon(proc)
    raise SystemExit("the serving daemon did not start:\n" + "".join(lines))


def stop_daemon(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def depth_cut(spec: TAVSpec, layers: int) -> TAVSpec:
    """``spec`` with every tower's encoder and the fusion trunk cut to
    ``layers`` layers (their first ones; the widths stay)."""
    def cut(e):
        return dataclasses.replace(e, layers=min(layers, e.layers))
    return dataclasses.replace(
        spec, fusion=cut(spec.fusion),
        **{t: dataclasses.replace(getattr(spec, t),
                                  encoder=cut(getattr(spec, t).encoder))
           for t in ("text", "audio", "video")})


def front_ends(card: str, spec: TAVSpec, front_dir: str,
               exports: dict) -> dict:
    """Phase 7. ``front_dir`` holds phase 6's prediction log and bundle,
    ``exports`` what their run logged. Returns K1's launches per chunk
    through that bundle and the knobs-on bundle's launches per chunk."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tol = SERVE_TOL[torch.bfloat16]
    bundle = os.path.join(front_dir, "bundle")
    out = {"export_s": exports["export_s"], "save_s": exports["save_s"],
           "bundle_gb": exports["bytes"] / 1e9}

    # (1) the run's exports: one row per test utterance
    with open(os.path.join(front_dir, ROWS_FILE)) as f:
        rows = [json.loads(line) for line in f]
    sums = max(abs(sum(r["probs"]) - 1) for r in rows)
    out["rows"] = len(rows)
    out["rows_max_sum_err"] = sums
    served = load_bundle(bundle, device="cuda")
    out["load_s"] = served.load_s
    ok1 = (len(rows) == exports["test_rows"] == exports["rows"]
           and sums <= 1e-5 and served.ops == ("flash_fwd",)
           and served.platforms == ("cuda",))
    print(f"front ends (1): {len(rows)} rows (test split "
          f"{exports['test_rows']}), max|sum-1| {sums:.1e}; bundle "
          f"{out['bundle_gb']:.3f} GB, ops {served.ops}, export "
          f"{out['export_s']:.1f} s, save {out['save_s']:.1f} s, load "
          f"{out['load_s']:.1f} s", flush=True)
    if not ok1:
        raise SystemExit("the run's serving exports failed their checks")

    # (2) the bundle in this process against a live Predictor on its
    # weights
    model = TAVModel(spec, device="cuda")
    model.load_state_dict({k[len("model."):]: v for k, v in
                           served.module.state_dict().items()}, strict=True)
    live = Predictor(model, batch_size=8, device="cuda")
    reqs = bundle_requests(spec)
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    served(reqs[0])
    live(reqs[0])                                   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = [served(r) for r in reqs]
    torch.cuda.synchronize()
    count = dict(kernels.LAUNCHES)
    want = [live(r) for r in reqs]
    diff, same = served_diff(got, want, tol)
    out["bundle_ms_per_batch_of_8"], out["bundle_times_ms"] = median_ms(
        served, reqs[0])
    out["live_ms_per_batch_of_8"], out["live_times_ms"] = median_ms(
        live, reqs[0])
    out["bundle_vs_live_max_abs"] = diff
    per_chunk = {k: v // chunks for k, v in count.items() if v}
    out["bundle_launches_per_chunk"] = per_chunk
    print(f"front ends (2): {chunks} chunks through the bundle, launches "
          f"{count} (expected {tav_layers(spec) * chunks} flash_fwd); "
          f"max|probs - probs(live)| = {diff:.3e} (tol {tol}), predictions "
          f"agree {same}; ms per batch of 8: bundle "
          f"{out['bundle_ms_per_batch_of_8']:.1f}, live "
          f"{out['live_ms_per_batch_of_8']:.1f}", flush=True)
    if not (same and diff <= tol
            and count["flash_fwd"] == tav_layers(spec) * chunks
            and sum(count.values()) == count["flash_fwd"]):
        raise SystemExit("the bundle did not serve as the live model")

    # (3) a second bundle exported with both knobs on: K1, K4a and K5a
    # through the operators, from the served model cut to its first
    # P7_KNOBS_DEPTH layers of every tower and the trunk, against that
    # cut model served live with the knobs off
    cut_spec = depth_cut(spec, P7_KNOBS_DEPTH)
    cut = TAVModel(cut_spec, device="cuda")
    whole = model.state_dict()
    cut.load_state_dict({k: whole[k] for k in cut.state_dict()}, strict=True)
    del whole
    want_cut = [Predictor(cut, batch_size=8, device="cuda")(r) for r in reqs]
    knobs_bundle = os.path.join(front_dir, "bundle_knobs_on")
    with knobs_on():
        info = export_bundle(cut, reqs[0], knobs_bundle, batch_size=8,
                             device="cuda")
    del cut
    out["knobs_on"] = {"depth": P7_KNOBS_DEPTH,
                       "export_s": info["export_s"], "save_s": info["save_s"],
                       "bundle_gb": info["bytes"] / 1e9}
    served_on = load_bundle(knobs_bundle, device="cuda")
    out["knobs_on"]["load_s"] = served_on.load_s
    served_on(reqs[0])
    torch.cuda.synchronize()
    kernels.reset_launches()
    got_on = [served_on(r) for r in reqs]
    torch.cuda.synchronize()
    count_on = dict(kernels.LAUNCHES)
    diff_on, same_on = served_diff(got_on, want_cut, tol)
    ln_per_chunk = sum(fused_ln_shapes(cut_spec, 8).values())
    expect_on = {"flash_fwd": tav_layers(cut_spec) * chunks,
                 "fused_mlp_fwd": tav_layers(cut_spec) * chunks,
                 "layer_norm_fwd": ln_per_chunk * chunks}
    knobs_per_chunk = {k: v // chunks for k, v in count_on.items() if v}
    out["knobs_on"].update(launches_per_chunk=knobs_per_chunk,
                           max_abs_vs_live=diff_on, ops=list(served_on.ops))
    (out["knobs_on"]["ms_per_batch_of_8"],
     out["knobs_on"]["times_ms"]) = median_ms(served_on, reqs[0])
    print(f"front ends (3): knobs-on bundle of depth {P7_KNOBS_DEPTH}, "
          f"launches {count_on} (expected "
          f"{expect_on}); max|probs - probs(live, knobs off)| = "
          f"{diff_on:.3e} (tol {tol}), predictions agree {same_on}",
          flush=True)
    del served_on
    if not (same_on and diff_on <= tol
            and {k: v for k, v in count_on.items() if v} == expect_on
            and out["knobs_on"]["ops"] == ["flash_fwd", "fused_mlp_fwd",
                                           "layer_norm_fwd"]):
        raise SystemExit("the knobs-on bundle did not serve through K1, K4a "
                         "and K5a")

    # (4) over HTTP: the bundle through the real entry point in a process
    # of its own, then a live Predictor behind the same service here
    one = {k: v[:1] for k, v in reqs[0].items()}
    body = instances(one, [0])
    proc, url = start_daemon(bundle)
    try:
        health = http_json(f"{url}/healthz")
        http_json(f"{url}/predict", body)               # warm-up
        times, answer = [], None
        for _ in range(P7_HTTP_REQUESTS):
            t = time.perf_counter()
            answer = http_json(f"{url}/predict", body)["predictions"]
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        stop_daemon(proc)
    http_diff = float(np.abs(np.asarray(answer[0]["probs"])
                             - got[0][1][0]).max())
    http_ok = (health["status"] == "ok" and health["batch_size"] == 8
               and answer[0]["pred"] == int(got[0][0][0])
               and http_diff <= tol)
    out["http_bundle"] = {"ms_per_request": float(np.median(times)),
                          "times_ms": times, "request_bytes": len(body),
                          "utterances": 1, "max_abs_vs_bundle": http_diff}
    u8 = requests(spec)[0]
    rows3 = {k: v[:3] for k, v in u8.items()}
    body3 = instances(rows3, range(3))
    server = make_server(PredictionService(live, id2label=None))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url3 = "http://%s:%d" % server.server_address[:2]
        http_json(f"{url3}/predict", body3)             # warm-up
        times3, answer3 = [], None
        for _ in range(P7_HTTP_REQUESTS):
            t = time.perf_counter()
            answer3 = http_json(f"{url3}/predict", body3)["predictions"]
            times3.append((time.perf_counter() - t) * 1e3)
    finally:
        server.shutdown()
        server.server_close()
    direct = live(rows3)
    live_diff, live_same = served_diff(
        [(np.array([r["pred"] for r in answer3]),
          np.array([r["probs"] for r in answer3]))], [direct], tol)
    out["http_live_uint8"] = {"ms_per_request": float(np.median(times3)),
                              "times_ms": times3,
                              "request_bytes": len(body3), "utterances": 3,
                              "max_abs_vs_predictor": live_diff}
    print(f"front ends (4): daemon {url} healthz {health['status']}; one "
          f"float-video utterance ({len(body) / 1e6:.1f} MB) "
          f"{out['http_bundle']['ms_per_request']:.0f} ms, max|probs - "
          f"bundle| {http_diff:.1e}; live service, 3 uint8 utterances "
          f"({len(body3) / 1e6:.1f} MB) "
          f"{out['http_live_uint8']['ms_per_request']:.0f} ms, max|probs - "
          f"Predictor| {live_diff:.1e}", flush=True)
    del served, live, model
    torch.cuda.empty_cache()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"front_ends": {**out, "card": card}}), flush=True)
    if not (http_ok and live_same and live_diff <= tol):
        raise SystemExit("serving over HTTP failed its checks")
    return {"flash_fwd": per_chunk["flash_fwd"], "knobs_on": knobs_per_chunk}


# phase 8: the fusion family at full width. K1 launches per served chunk
# and per train step (one per attention layer: the 12-layer trunk, and for
# the two-tower model the 6-layer text tower), and K5a/K5b per chunk or
# step with MME_FUSED_MLP=1 (the dense blocks only: TAVMoE's MoE blocks
# run their experts as einsums, as in JAX)
FAMILY = ("TAVFormer", "TAVForMAE2Tower", "TAVForW2V2", "TAVMoE")
FAMILY_FLASH = {"TAVFormer": 12, "TAVForMAE2Tower": 18, "TAVForW2V2": 12,
                "TAVMoE": 12}
FAMILY_MLP = {"TAVFormer": 12, "TAVForMAE2Tower": 18, "TAVForW2V2": 12,
              "TAVMoE": 6}
# TAVMoE's loop: 4 train steps, one validation batch at the epoch's end and
# one test batch
FAMILY_LOOP_SIZES = ((32, 0), (8, 1), (8, 2))
FAMILY_LOOP_STEPS, FAMILY_LOOP_EVAL_BATCHES = 4, 2
# a token's expert set may flip between two numerically valid fp32 runs
# only where the reference's k-th and (k+1)-th router probabilities lie
# closer than this (the runs' router logits differ by ~1e-6); a run with
# such a flip is not held to the fp32 tolerances, and says so
ROUTE_TIE = 1e-4
# the bf16 legs' learning rate, the benchmark configuration's (phase 5):
# at 1e-4 the post-LN trunks overshoot from their random initialisation
FAMILY_LR = 5e-6


class RouteLog:
    """The expert set and the top-k margin (k-th minus (k+1)-th router
    probability) of every token in every MoE router call of ``model``,
    in call order, while ``on``."""

    def __init__(self, model):
        self.calls, self.on = [], False
        self.top_k = {}
        self.handles = []
        for m in model.modules():
            if isinstance(m, MoEMlp):
                self.top_k[id(m.router)] = m.moe.top_k
                self.handles.append(m.router.register_forward_hook(self._hook))

    def _hook(self, mod, args, out):
        if not self.on:
            return
        k = self.top_k[id(mod)]
        gates, _ = router_gates(out.detach(), k)
        top = torch.softmax(out.detach().float(), -1).topk(k + 1, -1).values
        self.calls.append((gates > 0, top[..., k - 1] - top[..., k]))

    @contextlib.contextmanager
    def record(self):
        self.calls, self.on = [], True
        try:
            yield self
        finally:
            self.on = False

    def close(self):
        for h in self.handles:
            h.remove()


def route_diff(got: list, ref: list) -> Tuple[int, int, int]:
    """(tokens routed, tokens routed differently, of those the ones whose
    reference margin is at least ROUTE_TIE) over two RouteLogs' calls."""
    n = flips = firm = 0
    for (a, _), (b, margin) in zip(got, ref):
        moved = (a != b).any(-1)
        n += moved.numel()
        flips += int(moved.sum())
        firm += int((moved & (margin >= ROUTE_TIE)).sum())
    return n, flips, firm


def family_serve(name: str, state, reqs, card: str) -> dict:
    """Serving: bf16 compute over fp32 weights, batch 8, against
    MME_FLASH=0 and with both knobs on against both off; TAVMoE holds its
    kernels against MME_FLASH=0 in an fp32 leg too, with its routes."""
    base = TAVSpec(output_dim=7)
    cls = FUSION_MODELS[name]
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    n_ln = sum(fused_ln_shapes(base, 8, model=name).values())
    is_moe = name == "TAVMoE"
    out = {}
    for dtype in ((torch.float32, torch.bfloat16) if is_moe
                  else (torch.bfloat16,)):
        leg = "fp32" if dtype == torch.float32 else "bf16"
        tol = SERVE_TOL[dtype]
        model = cls(base.with_compute_dtype(dtype), device="cuda")
        model.load_state_dict(state, strict=True)
        routes = RouteLog(model)
        pred = Predictor(model, batch_size=8, device="cuda")
        pred(reqs[0])                                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with routes.record():
            got = [pred(r) for r in reqs]
        torch.cuda.synchronize()
        count = dict(kernels.LAUNCHES)
        got_routes = routes.calls
        os.environ["MME_FLASH"] = "0"
        try:
            kernels.reset_launches()
            with routes.record():
                ref = [pred(r) for r in reqs]
            plain_count = dict(kernels.LAUNCHES)
        finally:
            del os.environ["MME_FLASH"]
        ref_routes = routes.calls
        diff, same = served_diff(got, ref, tol)
        n_tok, flips, firm = route_diff(got_routes, ref_routes)
        finite = all(np.isfinite(p).all() for _, p in got + ref)
        shapes_ok = all(p.shape == (len(r["input_ids"]), 7)
                        for (_, p), r in zip(got, reqs))
        # a zero-padded partial chunk: the same rows as in a full chunk
        part = {k: v[:3] for k, v in reqs[0].items()}
        pad_diff = float(np.abs(pred(part)[1] - got[0][1][:3]).max())
        res = {"flash_launches_per_chunk": count["flash_fwd"] / chunks,
               "max_abs_vs_plain": diff, "predictions_agree": same,
               "padded_chunk_max_abs": pad_diff, "finite": finite,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if is_moe:
            res.update(router_tokens=n_tok, routed_differently=flips,
                       routed_differently_past_tie=firm)
        # fp32 legs (TAVMoE) hold probabilities to SERVE_TOL unless a token
        # flipped at a near-tie; bf16 legs of TAVMoE report their flips
        held = not (is_moe and (dtype == torch.bfloat16 or flips))
        ok = (finite and shapes_ok and pad_diff <= SERVE_TOL[torch.float32]
              and count["flash_fwd"] == FAMILY_FLASH[name] * chunks
              and plain_count["flash_fwd"] == 0
              and (not held or (diff <= tol and same))
              and not (is_moe and dtype == torch.float32 and firm))
        print(f"family {name} serve {leg}: {chunks} chunks, launches "
              f"{count['flash_fwd']} K1 (expected "
              f"{FAMILY_FLASH[name] * chunks}), {plain_count['flash_fwd']} "
              f"with MME_FLASH=0; max|probs - probs(MME_FLASH=0)| = "
              f"{diff:.3e} (tol {tol}{'' if held else ', reported only'}), "
              f"predictions agree {same}; padded chunk {pad_diff:.1e}"
              + (f"; tokens routed differently {flips} of {n_tok} "
                 f"({firm} past a near-tie)" if is_moe else ""), flush=True)
        if not ok:
            raise SystemExit(f"phase 8: serving {name} ({leg}) failed")

        # the same requests with MME_FUSED_LN=1 and MME_FUSED_MLP=1
        with knobs_on():
            pred(reqs[0])                                   # warm-up
            kernels.reset_launches()
            with routes.record():
                fused = [pred(r) for r in reqs]
            count_f = dict(kernels.LAUNCHES)
        diff_f, same_f = served_diff(fused, got, tol)
        _, flips_f, firm_f = route_diff(routes.calls, got_routes)
        expect = {"flash_fwd": FAMILY_FLASH[name] * chunks,
                  "fused_mlp_fwd": FAMILY_MLP[name] * chunks,
                  "layer_norm_fwd": n_ln * chunks}
        held_f = not (is_moe and (dtype == torch.bfloat16 or flips_f))
        finite_f = all(np.isfinite(p).all() for _, p in fused)
        print(f"family {name} serve {leg}, both knobs on: launches "
              f"{ {k: v for k, v in count_f.items() if v} } (expected "
              f"{expect}); max|probs - probs(knobs off)| = {diff_f:.3e}"
              + (f"; tokens routed differently {flips_f} ({firm_f} past a "
                 "near-tie)" if is_moe else ""), flush=True)
        if not (finite_f and {k: v for k, v in count_f.items() if v}
                == expect and (not held_f or (diff_f <= tol and same_f))
                and not (is_moe and dtype == torch.float32 and firm_f)):
            raise SystemExit(f"phase 8: serving {name} ({leg}) with both "
                             "knobs on failed")
        res.update(max_abs_knobs_on_vs_off=diff_f,
                   launches_per_chunk_knobs_on={
                       k: v // chunks for k, v in count_f.items() if v})
        if is_moe:
            res.update(routed_differently_knobs_on=flips_f)
        if dtype == torch.bfloat16:
            res["ms_per_batch_of_8"], res["times_ms"] = median_ms(
                pred, reqs[0])
            with knobs_on():
                (res["ms_per_batch_of_8_knobs_on"],
                 res["times_ms_knobs_on"]) = median_ms(pred, reqs[0])
        out[leg] = res
        routes.close()
        del pred, model, routes
        torch.cuda.empty_cache()
    return out


def family_train(name: str, params, card: str) -> dict:
    """Training: (1) fp32, no dropout, batch 4: loss and gradients with the
    kernels against MME_FLASH=0; (2) bf16, no dropout, four steps on one
    batch of 8 with MME_OPT_STATE=bf16 and every knob on: the eval loss
    after them below the one before, one K3 launch per step."""
    is_moe = name == "TAVMoE"
    cls = FUSION_MODELS[name]
    state = from_flax(params)
    out = {}

    # (1) fp32
    spec = without_noise(TAVSpec(output_dim=7))
    model = cls(spec, device="cuda")
    model.load_state_dict(state, strict=True)
    routes = RouteLog(model)
    batch, labels, mask, cw = train_inputs(spec, 4, SEED + 50)
    batch = to_device(batch, "cuda")
    labels, mask, cw = (torch.as_tensor(x, device="cuda")
                        for x in (labels, mask, cw))
    params_t = list(model.parameters())
    model.train()

    def loss_and_grads():
        kernels.reset_launches()
        with routes.record():
            logits = model(batch)
        aux = None
        if is_moe:
            logits, aux = logits
        ce = cross_entropy(logits, labels, cw, mask)
        loss = ce if aux is None else ce + aux
        grads = torch.autograd.grad(loss, params_t, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params_t)]
        torch.cuda.synchronize()
        extra = {}
        if is_moe:
            router = [g for (n, _), g in zip(model.named_parameters(), grads)
                      if n.endswith("moe_mlp.router.weight")]
            extra = {"aux": aux.item(), "ce": ce.item(),
                     "router_grad_norm": global_norm_f32(router).item()}
        return (loss.item(), global_norm_f32(grads).item(),
                tower_norms(model, grads), dict(kernels.LAUNCHES),
                routes.calls, extra)

    loss, norm, towers, count, r_got, extra = loss_and_grads()
    os.environ["MME_FLASH"] = "0"
    try:
        loss0, norm0, towers0, count0, r_ref, _ = loss_and_grads()
    finally:
        del os.environ["MME_FLASH"]
    routes.close()
    rel = {k: abs(towers[k] - towers0[k]) / max(towers0[k], 1e-12)
           for k in towers0}
    _, flips, firm = route_diff(r_got, r_ref)
    held = not flips
    ok = (np.isfinite(loss) and np.isfinite(norm)
          and count["flash_fwd"] == count["flash_bwd"] == FAMILY_FLASH[name]
          and count0["flash_fwd"] == count0["flash_bwd"] == 0 and not firm
          and (not held or (abs(loss - loss0) <= TRAIN_LOSS_RTOL * abs(loss0)
                            and abs(norm - norm0) <= TRAIN_NORM_RTOL * norm0
                            and max(rel.values()) <= TRAIN_NORM_RTOL)))
    if is_moe:
        ok = ok and (np.isfinite(extra["aux"]) and extra["aux"] > 0
                     and abs(loss - extra["ce"] - extra["aux"])
                     <= 1e-6 * abs(loss) and extra["router_grad_norm"] > 0)
    out["fp32"] = {"batch": 4, "loss": loss, "loss_plain": loss0,
                   "grad_norm": norm, "grad_norm_plain": norm0,
                   "tower_norm_rel_diff": rel, "launches": count,
                   "routed_differently": flips, **extra}
    print(f"family {name} train fp32: {json.dumps(out['fp32'])}", flush=True)
    if not ok:
        raise SystemExit(f"phase 8: the fp32 training check of {name} "
                         "failed")
    del model, params_t
    torch.cuda.empty_cache()

    # (2) bf16, four steps, every knob on
    spec = without_noise(TAVSpec(output_dim=7)).with_compute_dtype(
        torch.bfloat16)
    model = cls(spec, device="cuda")
    model.load_state_dict(state, strict=True)
    n_ln = sum(fused_ln_shapes(spec, 8, model=name).values())
    env = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1", **KNOBS}
    os.environ.update(env)
    try:
        tx = make_optimizer(cosine_warm_restarts(FAMILY_LR, 10, 1000), 0.01,
                            1.0)
        st = TrainState.create(model.parameters(), tx, use_accum=False,
                               generator=torch.Generator(
                                   device="cuda").manual_seed(SEED))
        step = make_train_step(model, tx, num_classes=7,
                               has_aux_loss=is_moe)
        ev = make_eval_step(model, num_classes=7, has_aux_loss=is_moe)
        batch, labels, mask, cw = train_inputs(spec, 8, SEED + 60)
        batch = to_device(batch, "cuda")
        before = ev(batch, labels, mask, cw)[0].item()
        torch.cuda.reset_peak_memory_stats()
        losses, times, counts = [], [], []
        for _ in range(4):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(l.item())
            counts.append(dict(kernels.LAUNCHES))
        after = ev(batch, labels, mask, cw)[0].item()
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for k in env:
            del os.environ[k]
    expect = {"flash_fwd": FAMILY_FLASH[name], "flash_bwd": FAMILY_FLASH[name],
              "fused_mlp_fwd": FAMILY_MLP[name],
              "fused_mlp_bwd": FAMILY_MLP[name], "layer_norm_fwd": n_ln,
              "layer_norm_bwd": n_ln, "adam_update": 1}
    per_step = [{k: v for k, v in c.items() if v} for c in counts]
    out["bf16"] = {"eval_loss_before": before, "eval_loss_after": after,
                   "losses": losses, "times_ms": times,
                   "ms_per_step": float(np.median(times[1:])),
                   "peak_gb": peak, "launches_per_step": per_step[-1],
                   "expected_launches_per_step": expect}
    print(f"family {name} train bf16: {json.dumps(out['bf16'])}",
          flush=True)
    if not (all(np.isfinite(losses)) and np.isfinite(after)
            and after < before and all(c == expect for c in per_step)):
        raise SystemExit(f"phase 8: the bf16 training leg of {name} failed")
    del model, st, step, ev
    torch.cuda.empty_cache()
    return out


def family_moe_loop(params, card: str) -> dict:
    """TAVMoE through ``run_classifier(has_aux_loss=True)`` (bf16 compute,
    MME_OPT_STATE=bf16 MME_FUSED_ADAM=1, one epoch of 4 steps, one
    validation) with MME_EXPORT_BUNDLE set; the bundle loaded with
    ``load_bundle(device="cuda")`` against a live Predictor on its
    weights."""
    spec = TAVSpec(output_dim=7, dropout=0.1).with_compute_dtype(
        torch.bfloat16)
    directory = tempfile.mkdtemp(prefix="mme_moe_loop_")
    bundle = os.path.join(directory, "bundle")
    env = dict(LOOP_ENV, MME_EXPORT_BUNDLE=bundle,
               MME_RUN_DIR=os.path.join(directory, "run"))
    try:
        (n_train, s_train), *evals = FAMILY_LOOP_SIZES
        train_ds = synthetic_tav_dataset(spec, n_train, 70, 96000,
                                         seed=s_train)
        val_ds, test_ds = (synthetic_tav_dataset(spec, n, 70, 96000, seed=s)
                           for n, s in evals)
        model = TAVMoEFormer(spec, device="cuda")
        model.load_state_dict(from_flax(params), strict=True)
        cfg = ExperimentConfig(**dict(LOOP_CFG, epoch=1, log_val=4),
                               checkpoint_dir=os.path.join(directory, "ck"),
                               text_max_len=70, audio_max_samples=96000)
        os.environ.update(env)
        try:
            kernels.reset_launches()
            t = time.perf_counter()
            summary = run_classifier(
                cfg, model, train_ds, val_ds, test_ds,
                batch_transform=make_video_keep_transform(spec),
                has_aux_loss=True, device="cuda")
            loop_s = time.perf_counter() - t
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        finally:
            for k in env:
                del os.environ[k]
        with open(os.path.join(env["MME_RUN_DIR"], "metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f]
        losses = [d[k] for d in logs for k in ("train/loss", "val/loss",
                                               "test/loss") if k in d]
        exported = next(d for d in logs if "export_bundle" in d)
        del model
        torch.cuda.empty_cache()

        served = load_bundle(bundle, device="cuda")
        live_model = TAVMoEFormer(spec, device="cuda")
        live_model.load_state_dict(
            {k[len("model."):]: v for k, v in
             served.module.state_dict().items()}, strict=True)
        live = Predictor(live_model, batch_size=8, device="cuda")
        reqs = bundle_requests(spec)
        chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
        served(reqs[0])
        live(reqs[0])                                   # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = [served(r) for r in reqs]
        torch.cuda.synchronize()
        count = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = [live(r) for r in reqs]
        tol = SERVE_TOL[torch.bfloat16]
        diff, same = served_diff(got, want, tol)
        with open(os.path.join(bundle, "meta.json")) as f:
            meta_model = json.load(f)["model"]
        out = {"loop_s": loop_s, "launches": launches, "losses": losses,
               "test_loss": summary["test/loss"],
               "export_s": exported["export_s"], "save_s": exported["save_s"],
               "bundle_gb": exported["bytes"] / 1e9, "load_s": served.load_s,
               "bundle_ops": list(served.ops), "bundle_model": meta_model,
               "bundle_launches_per_chunk": {
                   k: v // chunks for k, v in count.items()},
               "bundle_vs_live_max_abs": diff, "predictions_agree": same}
        (out["bundle_ms_per_batch_of_8"],
         out["bundle_times_ms"]) = median_ms(served, reqs[0])
        del served, live, live_model
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
    want_loop = {"flash_fwd": 12 * (FAMILY_LOOP_STEPS
                                    + FAMILY_LOOP_EVAL_BATCHES),
                 "flash_bwd": 12 * FAMILY_LOOP_STEPS,
                 "adam_update": FAMILY_LOOP_STEPS}
    out["expected_launches"] = want_loop
    print(f"family TAVMoE loop and bundle: {json.dumps(out)}", flush=True)
    if not (all(np.isfinite(losses)) and launches == want_loop
            and count == {"flash_fwd": 12 * chunks}
            and out["bundle_ops"] == ["flash_fwd"]
            and meta_model == "TAVMoEFormer" and same and diff <= tol):
        raise SystemExit("phase 8: TAVMoE through run_classifier and its "
                         "bundle failed")
    return out


def fusion_family(card: str) -> dict:
    """Phase 8. Returns per model the launches of one served chunk with
    both knobs on and of one bf16 train step with every knob on."""
    t0 = time.perf_counter()
    reqs = requests(TAVSpec(output_dim=7))
    launches = {}
    for name in FAMILY:
        t = time.perf_counter()
        params = init_params(TAVSpec(output_dim=7), SEED, model=name)
        state = from_flax(params)
        n_params = sum(v.numel() for v in state.values())
        res = {"parameters": n_params,
               "weights_s": time.perf_counter() - t}
        res["serve"] = family_serve(name, state, reqs, card)
        res["train"] = family_train(name, params, card)
        if name == "TAVMoE":
            res["loop"] = family_moe_loop(params, card)
        del params, state
        torch.cuda.empty_cache()
        res["phase_s"] = time.perf_counter() - t
        bf16 = res["serve"]["bf16"]
        print(json.dumps({"fusion_family": {
            "model": name, "parameters": n_params,
            "serve_ms_per_batch_of_8": bf16["ms_per_batch_of_8"],
            "serve_ms_per_batch_of_8_knobs_on":
                bf16["ms_per_batch_of_8_knobs_on"],
            "train_bf16_ms_per_step": res["train"]["bf16"]["ms_per_step"],
            "peak_gb": max(bf16["peak_gb"],
                           res["train"]["bf16"]["peak_gb"]),
            "launches_serve_chunk_knobs_on":
                bf16["launches_per_chunk_knobs_on"],
            "launches_train_step": res["train"]["bf16"]["launches_per_step"],
            "model_s": res["phase_s"], "detail": res, "card": card}}),
            flush=True)
        launches[name] = {"serve": bf16["launches_per_chunk_knobs_on"],
                          "step": res["train"]["bf16"]["launches_per_step"]}
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 9: the audio classifier and the BatchNorm vision models at full
# width. wav2vec2-base's Wav2Vec2Classifier goes through phase 10's legs
# (`zoo_model_legs`) at batch 8 over 96 000-sample waveforms: 299 frames,
# 2 392 rows; per served chunk or train step K1 and K5a (K2 and K5b) once
# per encoder layer, K4a (K4b) on the feature projection's LayerNorm, the
# post-LN encoder's `ln` and two per layer
W2V_LEN = 96000
# SlowR50 at visual_nn's full size: stages (3, 4, 6, 3), 16x224x224 clips,
# batch 8, fp32; Adam's learning rate for its steps
SLOW_BATCH, SLOW_FRAMES, SLOW_SIZE, SLOW_LR = 8, 16, 224, 1e-4
# the first BatchNorm's running statistics after one step against their
# recomputation from the stem's output: both fp32 means over 1.6 M values
# per channel, summed in other orders (the module takes E[x²] - E[x]², the
# recomputation the two-pass variance)
BN_STAT_TOL = dict(rtol=1e-4, atol=1e-6)
# images_nn's ResnetClassifier at 224x224 through run_classifier: one epoch
# of 4 steps of 8 images, one validation and one test batch
RESNET_SIZES = ((32, 90), (8, 91), (8, 92))


def load_drawn(net):
    """``net`` with weights and statistics from ``init_variables`` (drawn
    on the host), and its parameter count."""
    net.load_state_dict(from_flax(**init_variables(net, SEED)), strict=True)
    return net, sum(p.numel() for p in net.parameters())


def steps_of(model, tx, batch, labels, mask, cw, n: int):
    """n train steps on one batch: losses and ms per step."""
    st = TrainState.create(model.parameters(), tx, use_accum=False,
                           buffers=model_buffers(model))
    step = make_train_step(model, tx, num_classes=cw.shape[0])
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(l.item())
    return st, step, losses, times


def slow_r50(card: str) -> dict:
    """SlowR50(output_dim=7) at visual_nn's full size in fp32: one train
    step whose stem statistics are held against a biased-variance
    recomputation, three more with a falling eval loss, a checkpoint round
    trip of parameters and statistics, a bundle against the live model."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    net, n_params = load_drawn(SlowR50(7, device="cuda"))
    model = BatchModel(net, ("video",))
    ds = visual_nn.synthetic_video(SLOW_BATCH, SLOW_FRAMES, SLOW_SIZE, 7,
                                   SEED + 100)
    batch = to_device(ds.features, "cuda")
    labels = torch.as_tensor(ds.labels, device="cuda")
    mask = torch.ones(SLOW_BATCH, dtype=torch.int32, device="cuda")
    cw = torch.ones(7, device="cuda")
    ev = make_eval_step(model, num_classes=7)
    before = ev(batch, labels, mask, cw)[0].item()

    stem = []
    hook = net.stem_conv.register_forward_hook(
        lambda m, a, out: stem.append(out.detach()))
    tx = make_optimizer(lambda s: SLOW_LR, 0.01, 1.0)
    mean0, var0 = net.stem_bn.mean.clone(), net.stem_bn.var.clone()
    st, step, losses, times = steps_of(model, tx, batch, labels, mask, cw, 1)
    hook.remove()
    y = stem[0]
    dims = (0, 2, 3, 4)
    want_mean = 0.9 * mean0 + 0.1 * y.mean(dims)
    want_var = 0.9 * var0 + 0.1 * y.var(dims, unbiased=False)
    unbiased = 0.9 * var0 + 0.1 * y.var(dims, unbiased=True)
    err_mean = (net.stem_bn.mean - want_mean).abs().max().item()
    err_var = (net.stem_bn.var - want_var).abs().max().item()
    stats_ok = (torch.allclose(net.stem_bn.mean, want_mean, **BN_STAT_TOL)
                and torch.allclose(net.stem_bn.var, want_var, **BN_STAT_TOL))
    unbiased_gap = (unbiased - want_var).abs().max().item()
    del stem, y

    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(l.item())
    after = ev(batch, labels, mask, cw)[0].item()

    directory = tempfile.mkdtemp(prefix="mme_slow_r50_")
    try:
        ck = CheckpointManager(os.path.join(directory, "ck"), use_async=False)
        ck.save_best(st, {"val_loss": after})
        saved_p = [p.detach().clone() for p in st.params]
        saved_b = {k: b.clone() for k, b in st.buffers.items()}
        step(st, batch, labels, mask, cw, 1.0, True, SEED)   # moves both
        moved = not all(torch.equal(a, b) for a, b in zip(st.params, saved_p))
        t = time.perf_counter()
        ck.restore_best(st)
        restore_s = time.perf_counter() - t
        restored = (all(torch.equal(a, b) for a, b in zip(st.params, saved_p))
                    and all(torch.equal(st.buffers[k], b)
                            for k, b in saved_b.items()))

        bundle = os.path.join(directory, "bundle")
        info = export_bundle(model, ds.features, bundle, batch_size=8,
                             device="cuda")
        served = load_bundle(bundle, device="cuda")
        live = Predictor(model, batch_size=8, device="cuda")
        reqs = [ds.features, {k: v[:5] for k, v in ds.features.items()}]
        want = [live(r) for r in reqs]
        got = [served(r) for r in reqs]
        diff, same = served_diff(got, want, SERVE_TOL[torch.float32])
        live_ms, _ = median_ms(live, reqs[0], n=3)
        bundle_ms, _ = median_ms(served, reqs[0], n=3)
        del served, live
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    res = {"parameters": n_params, "batch": SLOW_BATCH,
           "clip": [SLOW_FRAMES, SLOW_SIZE, SLOW_SIZE],
           "stem_stats_max_abs": [err_mean, err_var],
           "stem_var_unbiased_gap": unbiased_gap,
           "losses": losses, "eval_loss_before": before,
           "eval_loss_after": after, "times_ms": times,
           "ms_per_step": float(np.median(times[1:])),
           "checkpoint_moved_then_restored": [moved, restored],
           "restore_s": restore_s, "bundle_export_s": info["export_s"],
           "bundle_gb": info["bytes"] / 1e9, "bundle_vs_live_max_abs": diff,
           "predictions_agree": same, "live_ms_per_batch_of_8": live_ms,
           "bundle_ms_per_batch_of_8": bundle_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"slice_model": {"model": "SlowR50", **res}}),
          flush=True)
    if not (stats_ok and all(np.isfinite(losses)) and after < before
            and moved and restored and same
            and diff <= SERVE_TOL[torch.float32]):
        raise SystemExit("phase 9: SlowR50 failed")
    del model, net, st, step, ev
    torch.cuda.empty_cache()
    return res


def resnet_frozen(card: str) -> dict:
    """ResnetClassifier(output_dim=2) at 224x224 through run_classifier for
    one epoch with images_nn's frozen-backbone mask: every backbone
    parameter but ``backbone.fc`` unchanged bit for bit, the running
    statistics moved, the head moved, ``backbone.fc``'s kernel moved by
    AdamW's weight decay."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    net, n_params = load_drawn(ResnetClassifier(2, device="cuda"))
    model = BatchModel(net, ("image",))
    mask = images_nn.fc_trainable_mask(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {k: b.clone() for k, b in model_buffers(model).items()}
    train_ds, val_ds, test_ds = (synthetic_image_dataset(n, 224, 2, s)
                                 for n, s in RESNET_SIZES)
    directory = tempfile.mkdtemp(prefix="mme_resnet_")
    env = {"MME_RUN_DIR": os.path.join(directory, "run")}
    os.environ.update(env)
    try:
        cfg = ExperimentConfig(batch_size=8, epoch=1, log_val=4,
                               patience=10, learning_rate=1e-3, output_dim=2,
                               dataset="synthetic", seed=SEED,
                               checkpoint_dir=os.path.join(directory, "ck"))
        t = time.perf_counter()
        summary = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                                 trainable_mask=mask, device="cuda")
        loop_s = time.perf_counter() - t
    finally:
        del os.environ["MME_RUN_DIR"]
        shutil.rmtree(directory, ignore_errors=True)
    moved = {n: not torch.equal(p, before[n])
             for n, p in model.named_parameters()}
    frozen_still = all(not moved[n] for (n, _), m in
                       zip(model.named_parameters(), mask) if not m)
    trainable = [n for (n, _), m in zip(model.named_parameters(), mask) if m]
    stats_moved = any(not torch.equal(b, stats[k])
                      for k, b in model_buffers(model).items())
    # the head trains; the backbone's unused fc moves by weight decay alone
    # (its zero bias stays zero)
    head_moved = all(moved[n] for n in trainable if n.startswith("net.fc."))
    res = {"parameters": n_params, "trainable": trainable,
           "trainable_moved": {n: moved[n] for n in trainable},
           "frozen_unchanged": frozen_still, "statistics_moved": stats_moved,
           "test_loss": summary["test/loss"], "loop_s": loop_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"slice_model": {"model": "ResnetClassifier", **res}}),
          flush=True)
    if not (frozen_still and stats_moved and head_moved
            and moved["net.backbone.fc.weight"]
            and np.isfinite(summary["test/loss"])
            and len(trainable) == 4):
        raise SystemExit("phase 9: ResnetClassifier with the frozen "
                         "backbone failed")
    del model, net
    torch.cuda.empty_cache()
    return res


def conv_nets(card: str) -> list:
    """Conv3DClassifier at visual_nn's full size (16x224x224 clips) and
    ConvNetClassifier at images_nn's (224x224, hidden (32, 32), the binary
    sigmoid head): a forward and two train steps each, batch 8, fp32."""
    out = []
    for name, net, key, shape, classes in (
            ("Conv3DClassifier", Conv3DClassifier(7, device="cuda"), "video",
             (8, 16, 224, 224, 3), 7),
            ("ConvNetClassifier", ConvNetClassifier((32, 32), 1, 224,
                                                    device="cuda"),
             "image", (8, 224, 224, 3), 2)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        net, n_params = load_drawn(net)
        model = BatchModel(net, (key,))
        g = torch.Generator(device="cuda").manual_seed(SEED)
        batch = {key: torch.rand(shape, generator=g, device="cuda")}
        labels = torch.arange(8, device="cuda") % classes
        mask = torch.ones(8, dtype=torch.int32, device="cuda")
        cw = torch.ones(classes, device="cuda")
        model.eval()
        with torch.no_grad():
            logits = model(batch)
        tx = make_optimizer(lambda s: 1e-4, 0.01, 1.0)
        _, _, losses, times = steps_of(model, tx, batch, labels, mask, cw, 2)
        res = {"model": name, "parameters": n_params,
               "logits_shape": list(logits.shape), "losses": losses,
               "ms_per_step": times[-1], "times_ms": times,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "model_s": time.perf_counter() - t0, "card": card}
        print(json.dumps({"slice_model": res}), flush=True)
        if not (tuple(logits.shape) == (8, classes)
                and bool(torch.isfinite(logits).all())
                and all(np.isfinite(losses))):
            raise SystemExit(f"phase 9: {name} failed")
        out.append(res)
        del model, net
        torch.cuda.empty_cache()
    return out


def slice_models(card: str) -> dict:
    """Phase 9. Returns wav2vec2-base's launches of one served chunk with
    both knobs on and of one bf16 train step with every knob on."""
    t0 = time.perf_counter()
    launches = zoo_model_legs("Wav2Vec2Classifier", card)
    torch.cuda.empty_cache()
    slow_r50(card)
    resnet_frozen(card)
    conv_nets(card)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 10: the text and two-modality classifiers at full width, batch 8,
# 70 tokens, 160 000-sample waveforms (499 frames) and 16x224x224 clips
# (1 568 tokens), weights from init_variables, one model at a time. K1 per
# served chunk or train step once per attention layer (DistilRoBERTa 6,
# wav2vec2-base 12, VideoMAE 12, VisualBERT 12), K5a/K5b as many with
# MME_FUSED_MLP=1, K4a/K4b from `classifier_ln_sites` (the 1 024-row gate
# keeps the 560 text rows and VisualBERT's 568 off the kernels). Phase 9's
# Wav2Vec2Classifier takes the same legs at W2V_LEN samples.
ZOO_TEXT_LEN, ZOO_SAMPLES = 70, 160000
# text_nn's LSTM: vocabulary 5 000, 300-wide embedding and state, one layer
LSTM_VOCAB, LSTM_DIM = 5000, 300


def quiet_encoder(e):
    return dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)


def with_encoder(spec, enc):
    return dataclasses.replace(spec, encoder=enc(spec.encoder))


def w2v_base(enc, quiet: bool) -> Wav2Vec2Spec:
    spec = with_encoder(Wav2Vec2Spec.base(), enc)
    if quiet:
        spec = dataclasses.replace(spec, mask_time_prob=0.0,
                                   mask_feature_prob=0.0)
    return spec


def text_audio_base(enc, quiet: bool) -> TextAudioSpec:
    return TextAudioSpec(text=with_encoder(TextEncoderSpec.distilroberta(),
                                           enc),
                         audio=w2v_base(enc, quiet), output_dim=7,
                         dropout=0.0 if quiet else 0.5)


def text_video_base(enc, quiet: bool) -> TextVideoSpec:
    return TextVideoSpec(text=with_encoder(TextEncoderSpec.distilroberta(),
                                           enc),
                         video=with_encoder(VideoMAESpec.base(), enc),
                         output_dim=7, dropout=0.0 if quiet else 0.5)


def text_video_data(n: int, seed: int, video_only: bool = False,
                    tasks: bool = False):
    """``synthetic_tv`` at full size; ``tasks``: a per-row ``task_id``
    alternating text and video."""
    ds = text_video_nn.synthetic_tv(text_video_base(lambda e: e, False), n,
                                    ZOO_TEXT_LEN, 7, seed)
    if video_only:
        ds.features = {"video": ds.features["video"]}
    if tasks:
        ds.features["task_id"] = (np.arange(n) % 2).astype(np.int32)
    return ds


@dataclasses.dataclass(frozen=True)
class ZooModel:
    """One classifier of phases 9 and 10. ``spec(enc, quiet)``: its
    full-width spec with ``enc`` applied to every encoder spec (``quiet``:
    SpecAugment and the head's dropout off); ``build(spec, rate, device)``
    the module, ``rate`` the head's dropout where the spec has none;
    ``data(n, seed)`` n records drawn as its CLI draws them; ``flash`` its
    K1 launches per forward. Legs: ``train_fp32`` the fp32 gradients
    against MME_FLASH=0, ``train_bf16`` four bf16 steps, ``looped``
    ``run_classifier`` and a bundle. Seeds: the served requests
    ((rows, seed)), the fp32 and the bf16 batch, the loop's splits."""
    spec: Callable
    build: Callable
    inputs: tuple
    data: Callable
    flash: int
    classes: int = 7
    samples: int = ZOO_SAMPLES
    train_fp32: bool = True
    train_bf16: bool = True
    looped: bool = False
    requests: tuple = ((8, 110), (5, 111), (11, 112))
    train_seeds: tuple = (130, 131)
    loop_sizes: tuple = ((32, 120), (8, 121), (8, 122))


# phase 10's models, then phase 9's wav2vec2-base with its own seeds
ZOO_MODELS = {
    "BertClassifier": ZooModel(
        spec=lambda enc, quiet: with_encoder(TextEncoderSpec.distilroberta(),
                                             enc),
        build=lambda s, rate, device: BertClassifier(s, 7, rate,
                                                     device=device),
        inputs=("input_ids", "text_mask"),
        data=lambda n, seed: synthetic_text_dataset(50265, n, ZOO_TEXT_LEN,
                                                    7, seed),
        flash=6),
    "BertAudioClassifier": ZooModel(
        spec=text_audio_base,
        build=lambda s, rate, device: BertAudioClassifier(s, device=device),
        inputs=text_audio_nn.INPUTS,
        data=lambda n, seed: text_audio_nn.synthetic_ta(
            text_audio_base(lambda e: e, False), n, ZOO_TEXT_LEN,
            ZOO_SAMPLES, 7, seed),
        flash=18, looped=True),
    "BertVideoMAELateFusion": ZooModel(
        spec=text_video_base,
        build=lambda s, rate, device: BertVideoMAELateFusion(s,
                                                             device=device),
        inputs=text_video_nn.INPUTS, data=text_video_data, flash=18),
    "BertVideoMAEMTLShared": ZooModel(
        spec=text_video_base,
        build=lambda s, rate, device: BertVideoMAEMTLShared(s, device=device),
        inputs=text_video_nn.INPUTS + ("task_id",),
        data=lambda n, seed: text_video_data(n, seed, tasks=True),
        flash=18, train_bf16=False),
    "VBertClassifier": ZooModel(
        spec=lambda enc, quiet: with_encoder(VisualBertSpec(), enc),
        build=lambda s, rate, device: VBertClassifier(s, 2, rate,
                                                      device=device),
        inputs=visual_bert_nn.INPUTS,
        data=lambda n, seed: visual_bert_nn.synthetic_vbert(
            n, ZOO_TEXT_LEN, 1024, 30522, 2, seed),
        flash=12, classes=2),
    "VideoMAEClassifier": ZooModel(
        spec=lambda enc, quiet: with_encoder(VideoMAESpec.base(), enc),
        build=lambda s, rate, device: VideoMAEClassifier(s, 7, rate,
                                                         device=device),
        inputs=("video",),
        data=lambda n, seed: text_video_data(n, seed, video_only=True),
        flash=12, train_fp32=False, train_bf16=False),
    "Wav2Vec2Classifier": ZooModel(
        spec=w2v_base,
        build=lambda s, rate, device: Wav2Vec2Classifier(s, 7, rate,
                                                         device=device),
        inputs=("waveform", "audio_mask"),
        data=lambda n, seed: synthetic_audio_dataset(n, W2V_LEN, 7, seed),
        flash=12, samples=W2V_LEN, looped=True,
        requests=((8, 70), (5, 71), (11, 72)), train_seeds=(73, 74),
        loop_sizes=((32, 80), (8, 81), (8, 82))),
}
ZOO = tuple(name for name in ZOO_MODELS if name != "Wav2Vec2Classifier")


def zoo_spec(name: str, dtype: torch.dtype, quiet: bool = False):
    """The full-width spec of ``name`` computing in ``dtype``; ``quiet``:
    every dropout rate and SpecAugment probability 0 (the classifier's
    own dropout is ``zoo_net``'s)."""
    def enc(e):
        e = dataclasses.replace(e, dtype=dtype)
        return quiet_encoder(e) if quiet else e
    return ZOO_MODELS[name].spec(enc, quiet)


def zoo_net(name: str, dtype: torch.dtype, quiet: bool = False,
            device: str = "cuda"):
    """(the classifier, the batch keys it takes)."""
    m = ZOO_MODELS[name]
    return (m.build(zoo_spec(name, dtype, quiet), 0.0 if quiet else 0.5,
                    device), m.inputs)


def zoo_model(name: str, params, dtype: torch.dtype,
              quiet: bool = False) -> BatchModel:
    net, inputs = zoo_net(name, dtype, quiet)
    net.load_state_dict(from_flax(params), strict=True)
    return BatchModel(net, inputs)


def zoo_requests(name: str) -> Tuple[list, int]:
    """The served requests' features and their chunks of 8."""
    reqs = ZOO_MODELS[name].requests
    return ([ZOO_MODELS[name].data(n, seed).features for n, seed in reqs],
            sum(-(-n // 8) for n, _ in reqs))


def zoo_ln(name: str, batch: int = 8) -> int:
    """K4a (K4b) launches per chunk (step) of ``batch`` from the spec."""
    return sum(fused_ln_sites(classifier_ln_sites(
        zoo_spec(name, torch.bfloat16), batch, ZOO_TEXT_LEN,
        ZOO_MODELS[name].samples)).values())


def zoo_batch(name: str, n: int, seed: int, task=None):
    """n records on the card with their labels, an all-ones sample mask
    and unit class weights; ``task`` sets the MTL's 0-d task."""
    ds = ZOO_MODELS[name].data(n, seed)
    feats = dict(ds.features)
    if task is not None:
        feats["task_id"] = np.asarray(task, np.int32)
    return (to_device(feats, "cuda"), torch.as_tensor(ds.labels,
                                                      device="cuda"),
            torch.ones(n, dtype=torch.int32, device="cuda"),
            torch.ones(ZOO_MODELS[name].classes, device="cuda"))


def zoo_serve(name: str, params, card: str) -> dict:
    """bf16 compute over fp32 weights, batch 8, ragged requests of 8, 5
    and 11 rows: K1 against MME_FLASH=0, then both knobs on against both
    off."""
    m = ZOO_MODELS[name]
    reqs, chunks = zoo_requests(name)
    flash, n_ln = m.flash, zoo_ln(name)
    tol = SERVE_TOL[torch.bfloat16]
    model = zoo_model(name, params, torch.bfloat16)
    pred = Predictor(model, batch_size=8, device="cuda")
    pred(reqs[0])                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = [pred(r) for r in reqs]
    torch.cuda.synchronize()
    count = {k: v for k, v in kernels.LAUNCHES.items() if v}
    os.environ["MME_FLASH"] = "0"
    try:
        kernels.reset_launches()
        ref = [pred(r) for r in reqs]
        plain = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        del os.environ["MME_FLASH"]
    diff, same = served_diff(got, ref, tol)
    part = {k: v[:3] for k, v in reqs[0].items()}
    pad_diff = float(np.abs(pred(part)[1] - got[0][1][:3]).max())
    finite = all(np.isfinite(p).all() for _, p in got + ref)
    shapes_ok = all(p.shape == (n, m.classes)
                    for (_, p), (n, _) in zip(got, m.requests))
    peak = torch.cuda.max_memory_allocated() / 1e9
    with knobs_on():
        pred(reqs[0])                                   # warm-up
        kernels.reset_launches()
        fused = [pred(r) for r in reqs]
        count_f = {k: v for k, v in kernels.LAUNCHES.items() if v}
    diff_f, same_f = served_diff(fused, got, tol)
    expect = {"flash_fwd": flash * chunks}
    expect_f = {"flash_fwd": flash * chunks,
                "fused_mlp_fwd": flash * chunks}
    if n_ln:
        expect_f["layer_norm_fwd"] = n_ln * chunks
    res = {"chunks": chunks, "launches": count, "launches_plain": plain,
           "max_abs_vs_plain": diff, "predictions_agree": same,
           "padded_chunk_max_abs": pad_diff, "peak_gb": peak,
           "launches_knobs_on": count_f, "expected_knobs_on": expect_f,
           "max_abs_knobs_on_vs_off": diff_f,
           "predictions_agree_knobs_on": same_f,
           "launches_per_chunk_knobs_on": {k: v // chunks
                                           for k, v in count_f.items()}}
    if name == "VBertClassifier":
        vbert = model.net.vbert
        word = vbert.visual_bert.embeddings.word.weight
        res["tied_decoder"] = (
            vbert.decoder_weight.data_ptr() == word.data_ptr()
            and sum(p.data_ptr() == word.data_ptr()
                    for p in model.parameters()) == 1)
    res["ms_per_batch_of_8"], res["times_ms"] = median_ms(pred, reqs[0])
    with knobs_on():
        (res["ms_per_batch_of_8_knobs_on"],
         res["times_ms_knobs_on"]) = median_ms(pred, reqs[0])
    print(f"zoo {name} serve bf16: {json.dumps(res)}", flush=True)
    if not (finite and shapes_ok and count == expect and not plain
            and diff <= tol and same and pad_diff <= SERVE_TOL[torch.float32]
            and count_f == expect_f and diff_f <= tol and same_f
            and res.get("tied_decoder", True)):
        raise SystemExit(f"serving {name} failed")
    del pred, model
    torch.cuda.empty_cache()
    return res


def zoo_grads(model, batch, labels, mask, cw):
    """fp32 loss, gradient norm and launches of one training-mode pass;
    the named gradients (zero where the forward did not reach a
    parameter)."""
    params = list(model.parameters())
    kernels.reset_launches()
    loss = cross_entropy(model(batch), labels, cw, mask)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    torch.cuda.synchronize()
    return (loss.item(), global_norm_f32(grads).item(),
            {k: v for k, v in kernels.LAUNCHES.items() if v},
            dict(zip([n for n, _ in model.named_parameters()], grads)))


def zoo_train_fp32(name: str, params, card: str) -> dict:
    """fp32, no dropout or SpecAugment, batch 8: loss and gradient norm
    with K1/K2 against MME_FLASH=0. The MTL runs one step with task 0 and
    one with task 1: the other tower's gradients exactly zero, the chosen
    tower's, ``shared_layer``'s and the head's not."""
    m = ZOO_MODELS[name]
    model = zoo_model(name, params, torch.float32, quiet=True)
    model.train()
    flash = m.flash
    tasks = (0, 1) if name == "BertVideoMAEMTLShared" else (None,)
    out = {}
    for task in tasks:
        batch, labels, mask, cw = zoo_batch(name, 8, SEED + m.train_seeds[0],
                                            task)
        loss, norm, count, grads = zoo_grads(model, batch, labels, mask, cw)
        os.environ["MME_FLASH"] = "0"
        try:
            loss0, norm0, count0, _ = zoo_grads(model, batch, labels, mask,
                                                cw)
        finally:
            del os.environ["MME_FLASH"]
        res = {"batch": 8, "loss": loss, "loss_plain": loss0,
               "grad_norm": norm, "grad_norm_plain": norm0,
               "launches": count, "launches_plain": count0}
        ok = (np.isfinite(loss) and np.isfinite(norm)
              and count == {"flash_fwd": flash, "flash_bwd": flash}
              and not count0
              and abs(loss - loss0) <= TRAIN_LOSS_RTOL * abs(loss0)
              and abs(norm - norm0) <= TRAIN_NORM_RTOL * norm0)
        if task is not None:
            idle = ("net.videomae.", "net.fc_norm.") if task == 0 else \
                ("net.bert.",)
            busy = ("net.bert.",) if task == 0 else ("net.videomae.",
                                                     "net.fc_norm.")
            zero = [n for n, g in grads.items()
                    if n.startswith(idle) and g.any()]
            dead = [n for n, g in grads.items()
                    if n.startswith(busy) and "pooler" not in n
                    and not g.any()]
            shared = float(grads["net.shared_layer.weight"].norm())
            head = float(grads["net.classifier.weight"].norm())
            res.update(task=task, idle_nonzero=zero, busy_zero=dead,
                       shared_layer_grad_norm=shared,
                       classifier_grad_norm=head)
            ok = ok and not zero and not dead and shared > 0 and head > 0
        leg = "fp32" if task is None else f"fp32_task{task}"
        out[leg] = res
        print(f"zoo {name} train {leg}: {json.dumps(res)}", flush=True)
        if not ok:
            raise SystemExit(f"the fp32 training check of {name} "
                             f"({leg}) failed")
        del grads
    del model
    torch.cuda.empty_cache()
    return out


def zoo_train_bf16(name: str, params, card: str) -> dict:
    """bf16, no dropout, four steps on one batch of 8 with
    MME_OPT_STATE=bf16 MME_FUSED_ADAM=1 and both knobs on: the eval loss
    after them below the one before, every step's launches."""
    m = ZOO_MODELS[name]
    model = zoo_model(name, params, torch.bfloat16, quiet=True)
    flash, n_ln = m.flash, zoo_ln(name)
    env = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1", **KNOBS}
    os.environ.update(env)
    try:
        tx = make_optimizer(cosine_warm_restarts(FAMILY_LR, 10, 1000), 0.01,
                            1.0)
        st = TrainState.create(model.parameters(), tx, use_accum=False,
                               generator=torch.Generator(
                                   device="cuda").manual_seed(SEED))
        step = make_train_step(model, tx, num_classes=m.classes)
        ev = make_eval_step(model, num_classes=m.classes)
        batch, labels, mask, cw = zoo_batch(name, 8,
                                            SEED + m.train_seeds[1])
        before = ev(batch, labels, mask, cw)[0].item()
        torch.cuda.reset_peak_memory_stats()
        losses, times, counts = [], [], []
        for _ in range(4):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(l.item())
            counts.append({k: v for k, v in kernels.LAUNCHES.items() if v})
        after = ev(batch, labels, mask, cw)[0].item()
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for key in env:
            del os.environ[key]
    expect = {"flash_fwd": flash, "flash_bwd": flash,
              "fused_mlp_fwd": flash, "fused_mlp_bwd": flash,
              "adam_update": 1}
    if n_ln:
        expect.update(layer_norm_fwd=n_ln, layer_norm_bwd=n_ln)
    res = {"eval_loss_before": before, "eval_loss_after": after,
           "losses": losses, "times_ms": times,
           "ms_per_step": float(np.median(times[1:])), "peak_gb": peak,
           "launches_per_step": counts[-1],
           "expected_launches_per_step": expect}
    print(f"zoo {name} train bf16: {json.dumps(res)}", flush=True)
    if not (all(np.isfinite(losses)) and np.isfinite(after)
            and after < before and all(c == expect for c in counts)):
        raise SystemExit(f"the bf16 training leg of {name} failed")
    del model, st, step, ev
    torch.cuda.empty_cache()
    return res


def zoo_loop(name: str, params, card: str) -> dict:
    """``run_classifier`` for one epoch of 4 steps (bf16 compute,
    MME_OPT_STATE=bf16 MME_FUSED_ADAM=1, dropout and SpecAugment on) with
    MME_EXPORT_BUNDLE set; the bundle loaded with ``load_bundle`` against a
    live Predictor on its weights."""
    directory = tempfile.mkdtemp(prefix="mme_zoo_loop_")
    bundle = os.path.join(directory, "bundle")
    env = dict(LOOP_ENV, MME_EXPORT_BUNDLE=bundle,
               MME_RUN_DIR=os.path.join(directory, "run"))
    m = ZOO_MODELS[name]
    try:
        train_ds, val_ds, test_ds = (m.data(n, s) for n, s in m.loop_sizes)
        model = zoo_model(name, params, torch.bfloat16)
        cfg = ExperimentConfig(**dict(LOOP_CFG, epoch=1, log_val=4),
                               checkpoint_dir=os.path.join(directory, "ck"),
                               audio_max_samples=m.samples)
        os.environ.update(env)
        try:
            kernels.reset_launches()
            t = time.perf_counter()
            summary = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                                     device="cuda")
            loop_s = time.perf_counter() - t
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        finally:
            for k in env:
                del os.environ[k]
        with open(os.path.join(env["MME_RUN_DIR"], "metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f]
        losses = [d[k] for d in logs for k in ("train/loss", "val/loss",
                                               "test/loss") if k in d]
        exported = next(d for d in logs if "export_bundle" in d)
        del model
        torch.cuda.empty_cache()

        served = load_bundle(bundle, device="cuda")
        live_model = zoo_model(name, params, torch.bfloat16)
        live_model.load_state_dict(
            {k[len("model."):]: v for k, v in
             served.module.state_dict().items()}, strict=True)
        live = Predictor(live_model, batch_size=8, device="cuda")
        reqs, chunks = zoo_requests(name)
        served(reqs[0])
        live(reqs[0])                                   # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = [served(r) for r in reqs]
        torch.cuda.synchronize()
        count = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = [live(r) for r in reqs]
        tol = SERVE_TOL[torch.bfloat16]
        diff, same = served_diff(got, want, tol)
        with open(os.path.join(bundle, "meta.json")) as f:
            meta_model = json.load(f)["model"]
        out = {"loop_s": loop_s, "launches": launches, "losses": losses,
               "test_loss": summary["test/loss"],
               "export_s": exported["export_s"], "save_s": exported["save_s"],
               "bundle_gb": exported["bytes"] / 1e9, "load_s": served.load_s,
               "bundle_ops": list(served.ops), "bundle_model": meta_model,
               "bundle_launches_per_chunk": {
                   k: v // chunks for k, v in count.items()},
               "bundle_vs_live_max_abs": diff, "predictions_agree": same}
        (out["bundle_ms_per_batch_of_8"],
         out["bundle_times_ms"]) = median_ms(served, reqs[0])
        del served, live, live_model
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
    steps = -(-m.loop_sizes[0][0] // 8)
    evals = sum(-(-n // 8) for n, _ in m.loop_sizes[1:])
    want_loop = {"flash_fwd": m.flash * (steps + evals),
                 "flash_bwd": m.flash * steps, "adam_update": steps}
    out["expected_launches"] = want_loop
    print(f"zoo {name} loop and bundle: {json.dumps(out)}", flush=True)
    if not (all(np.isfinite(losses)) and launches == want_loop
            and count == {"flash_fwd": m.flash * chunks}
            and out["bundle_ops"] == ["flash_fwd"]
            and meta_model == "BatchModel" and same and diff <= tol):
        raise SystemExit(f"{name} through run_classifier and its "
                         "bundle failed")
    return out


def zoo_model_legs(name: str, card: str) -> dict:
    """Every leg of one classifier; its JSON line; its launches of one
    served chunk with both knobs on and of one train step (the bf16 leg's
    with every knob on, or the MTL's fp32 step). Starts from what the
    earlier phases left on the card once cyclic garbage is collected
    (``baseline_gb``), so its peaks are its own."""
    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    meta, _ = zoo_net(name, torch.float32, device="meta")
    params = init_variables(meta, SEED)["params"]
    n_params = sum(p.numel() for p in meta.parameters())
    res = {"parameters": n_params, "weights_s": time.perf_counter() - t,
           "baseline_gb": torch.cuda.memory_allocated() / 1e9}
    m = ZOO_MODELS[name]
    res["serve"] = zoo_serve(name, params, card)
    res["train"] = {}
    if m.train_fp32:
        res["train"] = zoo_train_fp32(name, params, card)
    if m.train_bf16:
        res["train"]["bf16"] = zoo_train_bf16(name, params, card)
    if m.looped:
        res["loop"] = zoo_loop(name, params, card)
    del params
    torch.cuda.empty_cache()
    res["model_s"] = time.perf_counter() - t
    serve = res["serve"]
    train = res.get("train", {})
    bf16 = train.get("bf16", {})
    step = bf16.get("launches_per_step") or next(
        (leg["launches"] for leg in train.values()), {})
    print(json.dumps({"slice_model": {
        "model": name, "parameters": n_params,
        "serve_ms_per_batch_of_8": serve["ms_per_batch_of_8"],
        "serve_ms_per_batch_of_8_knobs_on":
            serve["ms_per_batch_of_8_knobs_on"],
        "train_bf16_ms_per_step": bf16.get("ms_per_step"),
        "peak_gb_serve": serve["peak_gb"],
        "peak_gb_train": bf16.get("peak_gb"),
        "launches_serve_chunk_knobs_on":
            serve["launches_per_chunk_knobs_on"],
        "launches_train_step": step,
        "max_abs_vs_plain": serve["max_abs_vs_plain"],
        "baseline_gb": res["baseline_gb"],
        "model_s": res["model_s"], "detail": res, "card": card}}),
        flush=True)
    return {"serve": serve["launches_per_chunk_knobs_on"], "step": step}


def zoo_lstm(card: str) -> dict:
    """``LSTMClassifier`` at text_nn's size (vocabulary 5 000, 300-wide
    embedding and state, one layer) over 8 x 70 tokens in fp32: a forward
    and two train steps, no kernel of the port launched."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    net, n_params = load_drawn(LSTMClassifier(LSTM_VOCAB, LSTM_DIM, LSTM_DIM,
                                              device="cuda"))
    model = BatchModel(net, ("input_ids",))
    ds = synthetic_text_dataset(LSTM_VOCAB, 8, ZOO_TEXT_LEN, 7, SEED + 140)
    batch = to_device(ds.features, "cuda")
    labels = torch.as_tensor(ds.labels, device="cuda")
    mask = torch.ones(8, dtype=torch.int32, device="cuda")
    cw = torch.ones(7, device="cuda")
    kernels.reset_launches()
    model.eval()
    with torch.no_grad():
        logits = model(batch)
    tx = make_optimizer(lambda s: 1e-3, 0.01, 1.0)
    _, _, losses, times = steps_of(model, tx, batch, labels, mask, cw, 2)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    res = {"model": "LSTMClassifier", "parameters": n_params,
           "logits_shape": list(logits.shape), "losses": losses,
           "times_ms": times, "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"slice_model": res}), flush=True)
    if not (tuple(logits.shape) == (8, 7) and not launches
            and bool(torch.isfinite(logits).all())
            and bool((logits <= 0).all()) and all(np.isfinite(losses))):
        raise SystemExit("phase 10: LSTMClassifier failed")
    del model, net
    torch.cuda.empty_cache()
    return res


def zoo_clis(card: str) -> dict:
    """text_nn (both models), text_audio_nn, text_video_nn -m 1MTL and
    visual_bert_nn on synthetic data, one epoch at batch 8 on the card, in
    a temporary directory."""
    out = {}
    cwd = os.getcwd()
    directory = tempfile.mkdtemp(prefix="mme_zoo_cli_")
    try:
        os.chdir(directory)
        for label, main_fn, extra in (
                ("text_nn", text_nn.main, []),
                ("text_nn_LSTM", text_nn.main, ["-m", "LSTM"]),
                ("text_audio_nn", text_audio_nn.main, []),
                ("text_video_nn_1MTL", text_video_nn.main, ["-m", "1MTL"]),
                ("visual_bert_nn", visual_bert_nn.main, [])):
            t = time.perf_counter()
            summary = main_fn(["--dataset", "synthetic", "-e", "1", "-b",
                               "8"] + extra)
            out[label] = {"test_loss": summary["test/loss"],
                          "s": time.perf_counter() - t}
            shutil.rmtree(os.path.join(directory, "checkpoints"),
                          ignore_errors=True)
            if not np.isfinite(summary["test/loss"]):
                raise SystemExit(f"phase 10: {label} on the card failed")
    finally:
        os.chdir(cwd)
        shutil.rmtree(directory, ignore_errors=True)
    print(json.dumps({"zoo_clis": out, "card": card}), flush=True)
    return out


def zoo(card: str) -> dict:
    """Phase 10. Returns per model the launches of one served chunk with
    both knobs on and of one train step."""
    t0 = time.perf_counter()
    launches = {}
    for name in ZOO:
        launches[name] = zoo_model_legs(name, card)
        torch.cuda.empty_cache()
    zoo_lstm(card)
    zoo_clis(card)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 11: the data path at full width. The CLI's audio cap; utterances
# per split (the train split: 32 in each of the cap's four buckets, so that
# epoch 0's draw with replacement, weighted by class, still gives every
# bucket at least two full batches of 8); the
# share of the cap each train bucket's lengths span (the last runs past the
# cap); MELD's emotions; the knobs of the run; the decoded waves against
# the numpy path (-ffast-math reorders the sums: a few fp32 ulps of waves
# in [-1, 1])
DATA_CAP = 160000
DATA_SPLITS = (("train", 128), ("val", 8), ("test", 8))
DATA_SPANS = ((0.15, 0.235), (0.265, 0.485), (0.515, 0.735), (0.765, 1.1))
MELD = ("neutral", "joy", "sadness", "anger", "surprise", "fear", "disgust")
DATA_ENV = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1",
            "MME_FUSED_LN": "1", "MME_FUSED_MLP": "1", "MME_DTYPE": "bf16"}
WAVE_ATOL = 1e-5
DATA_WORKERS = 8


def audio_frames(spec: TAVSpec, samples: int) -> int:
    """Frames of the audio tower's conv stack over ``samples``."""
    frames = samples
    for k, st in zip(spec.audio.conv_kernels, spec.audio.conv_strides):
        frames = (frames - k) // st + 1
    return frames


def bucket_attention(spec: TAVSpec, samples: int) -> tuple:
    """(name, seq, heads) of the audio tower's and the fusion trunk's
    attention at ``samples`` of audio (70 text tokens, the video tokens
    kept)."""
    frames = audio_frames(spec, samples)
    return ((f"audio_{frames}", frames, spec.audio.encoder.heads),
            (f"fusion_{70 + frames + spec.video_keep_k}",
             70 + frames + spec.video_keep_k, spec.fusion.heads))


def write_wav(path: str, samples: np.ndarray, rate: int, fmt) -> np.ndarray:
    """samples [frames, channels] in [-1, 1] → a WAV file: 16-bit PCM
    through stdlib ``wave``, 24-bit PCM and IEEE float32 (``"f32"``) with
    a header written here. Returns the samples as the file holds them."""
    ch = samples.shape[1]
    if fmt == "f32":
        held = samples.astype(np.float32)
        data, code, bits = held.astype("<f4").tobytes(), 3, 32
    else:
        bits, code = fmt, 1
        scale = 2.0 ** (bits - 1)
        q = np.clip(np.round(samples * scale), -scale, scale - 1).astype(
            np.int64)
        held = (q / scale).astype(np.float32)
        if bits == 16:
            with wave.open(path, "wb") as w:
                w.setnchannels(ch)
                w.setsampwidth(2)
                w.setframerate(rate)
                w.writeframes(q.astype("<i2").tobytes())
            return held
        data = (q & 0xFFFFFF).astype("<u4").view(np.uint8).reshape(
            -1, 4)[:, :3].tobytes()
    block = ch * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 16, code, ch, rate,
                                        rate * block, block, bits)
                + b"data" + struct.pack("<I", len(data)) + data)
    return held


def write_utterances(directory: str, cap: int, seed: int) -> list:
    """The phase's utterances, MELD's extraction format for most (48 kHz
    stereo 16-bit) and a few 44.1 kHz mono, 24-bit and float32 files:
    one dict per file with its split, path, seconds, format and the numpy
    path's wave at 16 kHz (the samples as written, their channel mean,
    ``resample_numpy``)."""
    rng = np.random.default_rng(seed)
    plan = []
    for split, n in DATA_SPLITS:
        for i in range(n):
            lo, hi = (DATA_SPANS[i % 4] if split == "train"
                      else (DATA_SPANS[0][0], DATA_SPANS[-1][1]))
            plan.append((split, rng.uniform(lo, hi) * cap / 16000))
    files = []
    for i, (split, seconds) in enumerate(plan):
        rate, ch, fmt = ((44100, 1, 16) if i % 9 == 4 else
                         (48000, 2, 24) if i % 11 == 5 else
                         (48000, 1, "f32") if i % 13 == 6 else
                         (48000, 2, 16))
        n = int(seconds * rate)
        t = np.arange(n) / rate
        x = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)[:, None]
             + 0.1 * rng.standard_normal((n, ch)))
        path = os.path.join(directory, f"utt{i:03d}.wav")
        held = write_wav(path, np.clip(x, -1, 1), rate, fmt)
        files.append({"split": split, "path": path, "seconds": n / rate,
                      "rate": rate, "channels": ch, "format": fmt,
                      "want": resample_numpy(held.mean(axis=1), rate,
                                             16000)})
    return files


def decode_check(files: list, card: str) -> dict:
    """Phase 11 (3): every file through ``load_waveforms_parallel`` on the
    native library, against the numpy path."""
    paths = [f["path"] for f in files]
    before = wavio.FALLBACKS
    t = time.perf_counter()
    native = load_waveforms_parallel(paths, 16000, workers=DATA_WORKERS)
    wall = time.perf_counter() - t
    fallbacks = wavio.FALLBACKS - before
    if any(g.shape != f["want"].shape for g, f in zip(native, files)):
        raise SystemExit("phase 11: a decoded wave has the wrong length")
    audio_s = sum(f["seconds"] for f in files)
    out = {"files": len(files), "audio_seconds": audio_s,
           "formats": sorted({f"{f['rate']} Hz x{f['channels']} "
                              f"{f['format']}" for f in files}),
           "max_abs_err": max(float(np.abs(g - f["want"]).max())
                              for g, f in zip(native, files)),
           "tol": WAVE_ATOL, "fallbacks": fallbacks,
           "workers": DATA_WORKERS, "native_s": wall,
           "utt_per_s": len(files) / wall, "audio_s_per_s": audio_s / wall,
           "rates_on": f"the host CPU of the card's machine "
                       f"({os.cpu_count()} cores)", "card": card}
    print(json.dumps({"data_decode": out}), flush=True)
    if not (fallbacks == 0 and out["max_abs_err"] <= WAVE_ATOL):
        raise SystemExit("phase 11: WAV decode failed its checks")
    return out


def resample_check(card: str) -> dict:
    """Phase 11 (4): ``resample_waveform`` on the card, 48 kHz → 16 kHz over
    [8, 288 000], against ``resample_numpy`` row by row."""
    g = np.random.default_rng(SEED + 110)
    x = np.clip(0.4 * g.standard_normal((8, 288000)), -1, 1).astype(
        np.float32)
    xt = torch.from_numpy(x).cuda()
    y = resample_waveform(xt, 48000, 16000)
    want = np.stack([resample_numpy(r, 48000, 16000) for r in x])
    e = float(np.abs(y.cpu().numpy() - want).max())
    out = {"shape": list(x.shape), "out_shape": list(y.shape),
           "max_abs_err": e, "tol": WAVE_ATOL,
           "ms": cuda_ms(lambda: resample_waveform(xt, 48000, 16000)),
           "card": card}
    print(json.dumps({"data_resample": out}), flush=True)
    if not (tuple(y.shape) == want.shape and e <= WAVE_ATOL):
        raise SystemExit("phase 11: resample_waveform on the card disagrees "
                         "with resample_numpy")
    return out


def data_records(files: list, spec: TAVSpec, cap: int, text_len: int,
                 seed: int):
    """Phase 11 (5): TAV records per split through
    ``records.build_tav_dataset`` as ``cli/tav_nn``'s pickle branch builds
    them, on a mapping of columns in place of the frame (the card's machine
    has no pandas): text hash-tokenized (``get_tokenizer(None, ...)`` on
    purpose), audio through ``load_audio_bucket`` at the cap, MELD emotion
    strings with the label map ``build_label_map`` makes over every row,
    dialogs of 8; then uint8 video drawn from ``seed`` in place of the zero
    clips the builder gives rows without a video column. Returns (train,
    val, test, id→name map)."""
    rng = np.random.default_rng(seed)
    vocab = ("i you we it that what no yes oh okay really so just know "
             "think right well hey wait come on".split())
    split = np.array([f["split"] for f in files])
    frame = {"text": np.array([" ".join(rng.choice(vocab,
                                                   rng.integers(3, 30)))
                               for _ in files]),
             "audio_path": np.array([f["path"] for f in files]),
             "emotion": np.array([MELD[i % 7] if i < 7 else
                                  MELD[rng.integers(7)]
                                  for i in range(len(files))])}
    rcfg = PickleDatasetConfig(text_max_len=text_len, audio_max_samples=cap,
                               video_uint8=True,
                               label_map=build_label_map(frame, "emotion"))
    tok = get_tokenizer(None, spec.text.vocab_size)
    out = []
    for name, _ in DATA_SPLITS:
        rows = split == name
        part = {k: col[rows] for k, col in frame.items()}
        part["dialog"] = np.arange(rows.sum()) // 8
        ds = build_tav_dataset(part, rcfg, spec.video.num_frames,
                               spec.video.image_size, tokenizer=tok)
        video = ds.features["video"]
        video[:] = rng.integers(0, 256, video.shape, dtype=np.uint8)
        out.append(ds)
    return (*out, invert_label_map(rcfg.label_map))


@contextlib.contextmanager
def recorded_calls(model, cuda: bool):
    """Hooks on ``model``'s forward for the enclosed run. Yields (calls,
    finite): per train step or eval batch its mode, rows and audio
    samples, the kernel launches so far and, on the card, the time after a
    synchronize; whether its logits were finite. On leaving, each call
    gains ``ms`` and ``delta`` (its launches by kernel, up to the next
    call or the end), and ``calls`` ends with one more entry, the end's
    time and launches."""
    calls, finite = [], []

    def mark(entry):
        if cuda:
            torch.cuda.synchronize()
        calls.append({**entry, "t": time.perf_counter(),
                      "launches": dict(kernels.LAUNCHES)})

    def pre(module, args):
        wave_ = args[0]["waveform"]
        mark({"train": module.training, "rows": int(wave_.shape[0]),
              "samples": int(wave_.shape[1])})

    def post(module, args, out):
        finite.append(bool(torch.isfinite(out).all()))

    hooks = (model.register_forward_pre_hook(pre),
             model.register_forward_hook(post))
    try:
        yield calls, finite
        mark({"end": True})
    finally:
        for h in hooks:
            h.remove()
    for a, b in zip(calls, calls[1:]):
        a["ms"] = (b["t"] - a["t"]) * 1e3
        a["delta"] = {k: v - a["launches"].get(k, 0)
                      for k, v in b["launches"].items()}


def data_path_run(files: list, device: str, directory: str) -> dict:
    """Phase 11 (5)-(6) on ``device`` (the CPU runs it at the tiny size,
    with ``MME_TINY`` set): the records, then ``cli/tav_nn``'s model and
    ``train`` as its pickle branch runs them (length buckets on, one epoch
    and the test pass, ``MME_PREDICT_OUT``) on a config whose checkpoints
    go to ``directory``. A hook on the model's forward records, for every
    train step and eval batch, its mode, rows, audio samples, the kernel
    launches so far and, on the card, the time after a synchronize.
    Checks all but the launch counts and returns what it recorded."""
    cfg = ExperimentConfig(batch_size=8, epoch=1, output_dim=7, seed=SEED,
                           dataset="meld.pkl", checkpoint_dir=directory)
    spec, cap, text_len = tav_nn.tav_spec(cfg)
    t = time.perf_counter()
    train_ds, val_ds, test_ds, id2label = data_records(files, spec, cap,
                                                       text_len, SEED + 111)
    records_s = time.perf_counter() - t
    model = tav_nn.build_model(cfg, spec, device)
    cuda = torch.device(device).type == "cuda"
    predict_out = os.path.join(directory, "predictions.jsonl")
    os.environ["MME_PREDICT_OUT"] = predict_out
    try:
        with recorded_calls(model, cuda) as (calls, finite):
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t = time.perf_counter()
            summary = tav_nn.train(cfg, model, spec, cap, train_ds, val_ds,
                                   test_ds, id2label, bucketed=True,
                                   device=device)
    finally:
        del os.environ["MME_PREDICT_OUT"]
    end = calls.pop()
    run_s = end["t"] - t
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    with open(predict_out) as f:
        rows = [json.loads(line) for line in f]
    losses = {k: d[k] for d in logs for k in ("train/loss", "val/loss",
                                              "test/loss") if k in d}
    bounds = make_bucket_iter(cap).bucket_bounds
    steps = [c for c in calls if c["train"]]
    out = {"cap": cap, "text_len": text_len, "bounds": list(bounds),
           "records_s": records_s,
           "run_s": run_s, "losses": losses,
           "splits": [len(train_ds), len(val_ds), len(test_ds)],
           "steps": len(steps), "eval_batches": len(calls) - len(steps),
           "step_samples": [c["samples"] for c in steps],
           "bounds_fed": sorted({c["samples"] for c in calls}),
           "prediction_rows": len(rows), "id2label": id2label,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9 if cuda
                       else None)}
    # train/loss is the mean over every step of the epoch (log_val is past
    # the epoch's end): cross-entropy is never negative, so the mean is
    # finite only if every step's loss is
    ok = (all(np.isfinite(v) for v in losses.values()) and len(losses) == 3
          and all(finite) and len(finite) == len(calls)
          and all(c["samples"] in bounds for c in calls)
          and all(sum(c["samples"] == b for c in steps) >= 2
                  for b in bounds)
          and len(rows) == len(test_ds)
          and all(r["label"] == id2label[r["pred"]] for r in rows))
    if not ok:
        print(json.dumps({"data_path_failed": out}), flush=True)
        raise SystemExit("phase 11: the bucketed training run failed its "
                         "checks")
    return {**out, "calls": calls, "launches": end["launches"]}


def expected_launches(spec: TAVSpec, call: dict) -> dict:
    """The kernel launches of one forward (eval) or one train step (forward,
    backward and the fused Adam update) at the batch actually fed, with
    every knob on."""
    n_ln = sum(fused_ln_sites(ln_sites(spec, call["rows"],
                                       samples=call["samples"])).values())
    fwd = {"flash_fwd": LAUNCHES_PER_CHUNK,
           "fused_mlp_fwd": LAUNCHES_PER_CHUNK, "layer_norm_fwd": n_ln}
    if not call["train"]:
        return {**fwd, "flash_bwd": 0, "fused_mlp_bwd": 0,
                "layer_norm_bwd": 0, "adam_update": 0}
    return {**fwd, "flash_bwd": LAUNCHES_PER_CHUNK,
            "fused_mlp_bwd": LAUNCHES_PER_CHUNK, "layer_norm_bwd": n_ln,
            "adam_update": 1}


def bucket_holds(spec: TAVSpec, fed, text_len: int, card: str) -> None:
    """Phase 11 (8): every kernel of the run against its plain version at
    the shapes the run fed it. For each (rows, audio samples) of a train
    step or eval batch: K1/K2 at the four towers' attention in bf16, the
    run's type (phase 3 holds both types at batch 8 below the cap); K4a/
    K4b at every LayerNorm shape the spec sends to the kernel and K5a/K5b
    at the four towers' MLPs, each in bf16 and fp32; phase 3's
    tolerances. Raises on the first disagreement."""
    v = spec.video
    attention, ln, mlp = set(), set(), set()
    for rows, samples in sorted(fed):
        frames = audio_frames(spec, samples)
        attention |= {
            (rows, text_len, spec.text.encoder.heads, True),
            (rows, frames, spec.audio.encoder.heads, True),
            (rows, v.num_patches - spec.video_keep_k, v.encoder.heads, False),
            (rows, text_len + frames + spec.video_keep_k, spec.fusion.heads,
             True)}
        ln |= set(fused_ln_sites(ln_sites(spec, rows, text_len, samples)))
        mlp |= {(n, h, f) for _, n, h, f, _ in
                mlp_shapes(spec, rows, text_len, samples)}
    t = time.perf_counter()
    errs = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for i, (b, s, h, masked) in enumerate(sorted(attention)):
        case = ("data_path", b, s, s, h, 64, torch.bfloat16, int(masked),
                masked)
        errs["flash_fwd"] = max(errs["flash_fwd"],
                                flash_fwd_hold(*case, seed=3000 + i))
        errs["flash_bwd"] = max(errs["flash_bwd"],
                                flash_bwd_hold(*case, False, seed=3000 + i))
    dtypes = (torch.bfloat16, torch.float32)
    ln_errs = [ln_hold(n, h, dt, dt, 3100 + i)
               for i, (n, h) in enumerate(sorted(ln)) for dt in dtypes]
    mlp_errs = [mlp_hold("data_path", n, h, f, dt, "gelu", 3200 + i)
                for i, (n, h, f) in enumerate(sorted(mlp)) for dt in dtypes]
    for key, e in (("layer_norm", ln_errs), ("fused_mlp", mlp_errs)):
        errs[f"{key}_fwd"], errs[f"{key}_bwd"] = (max(x) for x in zip(*e))
    print(json.dumps({"data_path_holds": {
        "fed": sorted(fed), "attention_shapes": len(attention),
        "layer_norm_shapes": sorted(ln), "mlp_shapes": sorted(mlp),
        "max_abs_err": errs, "s": time.perf_counter() - t, "card": card}}),
        flush=True)


def flash_times(B: int, s: int, h: int, masked: bool) -> dict:
    """K1 and K2 at one bf16 self-attention shape (head_dim 64), each
    timed beside its plain version and SDPA's forward or backward, with its
    bound."""
    q, k_, v_, bias = attention_inputs(B, s, s, h, 64, torch.bfloat16, 0,
                                       s + h)
    bias = bias if masked else None
    mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k_, v_))
    do = torch.randn(B, s, h, 64, device="cuda").to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k_, v_, bias)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    (_, _, fbound, fby), (_, _, bbound, bby) = flash_bounds(
        B, s, s, h, 64, 2, masked)
    row = {
        "B": B, "S": s, "H": h, "key_mask": masked,
        "fwd_ms": cuda_ms(lambda: flash_attention_fwd(q, k_, v_, bias)),
        "fwd_plain_ms": cuda_ms(lambda: flash_attention_fwd_plain(
            q, k_, v_, bias), iters=5),
        "fwd_library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        "fwd_bound_ms": fbound, "fwd_bound_by": fby,
        "bwd_ms": cuda_ms(lambda: flash_attention_bwd(
            q, k_, v_, bias, out, lse, do)),
        "bwd_plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(
            q, k_, v_, bias, out, lse, do), iters=3, warmup=1),
        "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
            o_lib, leaves, do.transpose(1, 2), retain_graph=True)),
        "bwd_bound_ms": bbound, "bwd_bound_by": bby}
    del o_lib, leaves
    return row


def bucket_kernel_shapes(spec: TAVSpec, bounds, card: str) -> dict:
    """Phase 11 (8): K1/K2 at each bucket's attention shapes and K4a/K4b at
    each LayerNorm shape of its train step that reaches the kernel (batch
    8, bf16), each timed once beside its plain version and the library
    call, with its bound; then per bucket the sums over one step's
    launches (6 text, 24 audio, 12 video and 12 fusion attention layers;
    the spec's LayerNorm sites)."""
    v = spec.video
    attention = {("text", 70, spec.text.encoder.heads, True): 6,
                 ("video", v.num_patches - spec.video_keep_k,
                  v.encoder.heads, False): 12}
    ln = {b: fused_ln_sites(ln_sites(spec, 8, samples=b)) for b in bounds}
    rows = {"flash": {}, "layer_norm": {}}
    for bound in bounds:
        (_, s_a, h_a), (_, s_f, h_f) = bucket_attention(spec, bound)
        for key in (("audio", s_a, h_a, True), ("fusion", s_f, h_f, True),
                    *attention):
            if key in rows["flash"]:
                continue
            name, s, h, masked = key
            rows["flash"][key] = {"tower": name,
                                  **flash_times(8, s, h, masked)}
    for n, h in sorted(set().union(*ln.values())):
        x, w, b, gy = ln_case(n, h, torch.bfloat16, torch.bfloat16, n % 997)
        lx, lw, lb = (t.detach().to(torch.bfloat16).requires_grad_()
                      for t in (x, w, b))
        ly = F.layer_norm(lx, (h,), lw, lb, 1e-5)
        (_, _, fbound, _), (_, _, bbound, _) = ln_bounds(n, h, 2)
        rows["layer_norm"][(n, h)] = {
            "N": n, "H": h,
            "launches_per_step": {str(bnd): ln[bnd].get((n, h), 0)
                                  for bnd in bounds},
            "fwd_ms": cuda_ms(lambda: fused_layer_norm_fwd(
                x, w, b, 1e-5, torch.bfloat16)),
            "fwd_plain_ms": cuda_ms(lambda: fused_layer_norm_fwd_plain(
                x, w, b, 1e-5, torch.bfloat16), iters=5),
            "fwd_library_ms": cuda_ms(lambda: F.layer_norm(
                x, (h,), lw, lb, 1e-5)),
            "fwd_bound_ms": fbound,
            "bwd_ms": cuda_ms(lambda: fused_layer_norm_bwd(gy, x, w, 1e-5)),
            "bwd_plain_ms": cuda_ms(lambda: fused_layer_norm_bwd_plain(
                gy, x, w, 1e-5), iters=5),
            "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
                ly, (lx, lw, lb), gy, retain_graph=True)),
            "bwd_bound_ms": bbound, "bound_by": "bytes"}
        del ly, lx

    times = ("ms", "plain_ms", "library_ms", "bound_ms")
    per_step = {}
    for bound in bounds:
        (_, s_a, h_a), (_, s_f, h_f) = bucket_attention(spec, bound)
        layers = {("audio", s_a, h_a, True): 24, ("fusion", s_f, h_f, True):
                  12, **attention}
        step = {}
        for kernel, table, counts in (
                ("flash", rows["flash"], layers),
                ("layer_norm", rows["layer_norm"], ln[bound])):
            for d in ("fwd", "bwd"):
                step[f"{kernel}_{d}"] = {
                    t: sum(table[k][f"{d}_{t}"] * c
                           for k, c in counts.items()) for t in times}
        per_step[str(bound)] = step
    out = {"flash": list(rows["flash"].values()),
           "layer_norm": list(rows["layer_norm"].values()),
           "per_step": per_step}
    print(json.dumps({"data_path_kernel_shapes": out, "card": card}),
          flush=True)
    return out


def data_path(card: str) -> dict:
    """Phase 11. Returns the run's launches by kernel and one train step's
    by bucket."""
    t0 = time.perf_counter()
    lib, cmd = wavio.build_library()
    print(f"phase 11: WAV decoder {lib}: "
          + (f"built in {time.perf_counter() - t0:.2f} s by {' '.join(cmd)}"
             if cmd else "built before this run"), flush=True)
    directory = tempfile.mkdtemp(prefix="mme_data_")
    try:
        t = time.perf_counter()
        files = write_utterances(directory, DATA_CAP, SEED + 112)
        print(f"phase 11: wrote {len(files)} WAV files in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        decode = decode_check(files, card)
        resample_check(card)
        for f in files:
            del f["want"]
        os.environ.update(DATA_ENV)
        try:
            run = data_path_run(files, "cuda", directory)
        finally:
            for k in DATA_ENV:
                del os.environ[k]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    spec = TAVSpec(output_dim=7)
    per_bucket, bad = {}, []
    for c in run["calls"]:
        want = expected_launches(spec, c)
        got = {k: c["delta"].get(k, 0) for k in want}
        if got != want:
            bad.append({"call": {k: c[k] for k in ("train", "rows",
                                                   "samples")},
                        "launches": got, "expected": want})
        if c["train"]:
            b = per_bucket.setdefault(c["samples"], {"ms": [],
                                                     "launches": got})
            b["ms"].append(c["ms"])
    for b in per_bucket.values():
        # a bucket's first step also pays cuDNN's choice of conv algorithm
        # for its shape; the steady figure is the median of the others
        b["first_ms"] = b["ms"][0]
        b["steady_ms"] = float(np.median(b["ms"][1:]))
    print(json.dumps({"data_path": {
        **{k: v for k, v in run.items() if k != "calls"},
        "decode_utt_per_s": decode["utt_per_s"],
        "per_bucket": {str(k): v for k, v in sorted(per_bucket.items())},
        "launch_mismatches": bad, "phase_s": time.perf_counter() - t0,
        "card": card}}), flush=True)
    if bad:
        raise SystemExit("phase 11: a step launched other kernels than its "
                         "shape asks for")
    bucket_holds(spec, {(c["rows"], c["samples"]) for c in run["calls"]},
                 run["text_len"], card)
    bucket_kernel_shapes(spec, run["bounds"], card)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": run["launches"],
            "per_step": {b: v["launches"] for b, v in per_bucket.items()}}


# phase 12: the pretrained import at full width. Five checkpoints in the
# layouts of the reference's (HF's RobertaForSequenceClassification,
# Wav2Vec2ForSequenceClassification twice, VideoMAEForVideoClassification,
# pytorchvideo's slow_r50), their values drawn from a seed, loaded through
# the CLIs' own branches
PRETRAINED_SIZES = ((24, 150), (8, 151), (8, 152))
PRETRAINED_AUDIO = 96000
PRETRAINED_TRAIN_ENV = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1",
                        "MME_FUSED_LN": "1", "MME_FUSED_MLP": "1"}
SLOW_STAGES = (3, 4, 6, 3)
# the folded positional conv against a float64 fold of the file, relative
# to its largest element: the converter folds in fp32, and numpy sums each
# kernel tap's 1 024 · 64 squares over the leading axes one row at a time,
# whose rounding grows like sqrt(n) · 2^-24 ≈ 1.5e-5 of the norm
POS_FOLD_RTOL = 1e-4
# numpy dtype name → safetensors dtype
SAFETENSORS_CODES = {
    "bool": "BOOL", "uint8": "U8", "int8": "I8", "uint16": "U16",
    "int16": "I16", "float16": "F16", "uint32": "U32", "int32": "I32",
    "float32": "F32", "uint64": "U64", "int64": "I64", "float64": "F64",
    "complex64": "C64"}


def _linear_layout(name: str, n_in: int, n_out: int) -> dict:
    return {f"{name}.weight": (n_out, n_in), f"{name}.bias": (n_out,)}


def _norm_layout(name: str, n: int) -> dict:
    return {f"{name}.weight": (n,), f"{name}.bias": (n,)}


def roberta_layout(spec: TextEncoderSpec, labels: int) -> dict:
    """``RobertaForSequenceClassification``'s state-dict names and shapes
    at ``spec``: the ``roberta.`` tower without a pooler, the two-layer
    classification head."""
    h, f, p = spec.encoder.hidden, spec.encoder.intermediate, "roberta."
    out = {f"{p}embeddings.word_embeddings.weight": (spec.vocab_size, h),
           f"{p}embeddings.position_embeddings.weight":
               (spec.max_positions, h),
           f"{p}embeddings.token_type_embeddings.weight":
               (spec.type_vocab_size, h),
           **_norm_layout(f"{p}embeddings.LayerNorm", h)}
    for i in range(spec.encoder.layers):
        q = f"{p}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            out.update(_linear_layout(f"{q}attention.self.{name}", h, h))
        out.update(_linear_layout(f"{q}attention.output.dense", h, h))
        out.update(_norm_layout(f"{q}attention.output.LayerNorm", h))
        out.update(_linear_layout(f"{q}intermediate.dense", h, f))
        out.update(_linear_layout(f"{q}output.dense", f, h))
        out.update(_norm_layout(f"{q}output.LayerNorm", h))
    out.update(_linear_layout("classifier.dense", h, h))
    out.update(_linear_layout("classifier.out_proj", h, labels))
    return out


def wav2vec2_layout(spec: Wav2Vec2Spec, labels: int, weight_norm: str,
                    projector: int = 256) -> dict:
    """``Wav2Vec2ForSequenceClassification``'s names and shapes at
    ``spec``: the ``wav2vec2.`` tower, then ``projector`` and
    ``classifier``. ``weight_norm`` names the positional conv's weight-norm
    keys: ``"weight_g"`` (``weight_g`` / ``weight_v``, as older files have
    them) or ``"parametrizations"`` (``parametrizations.weight.original0`` /
    ``original1``, as torch's parametrization names them)."""
    h, f, p = spec.encoder.hidden, spec.encoder.intermediate, "wav2vec2."
    out = {f"{p}masked_spec_embed": (h,)}
    c_in = 1
    for i, (c, k) in enumerate(zip(spec.conv_dims, spec.conv_kernels)):
        q = f"{p}feature_extractor.conv_layers.{i}."
        out[f"{q}conv.weight"] = (c, c_in, k)
        if spec.conv_bias:
            out[f"{q}conv.bias"] = (c,)
        if spec.feat_extract_norm == "layer" or i == 0:
            out.update(_norm_layout(f"{q}layer_norm", c))
        c_in = c
    out.update(_norm_layout(f"{p}feature_projection.layer_norm", c_in))
    out.update(_linear_layout(f"{p}feature_projection.projection", c_in, h))
    conv = f"{p}encoder.pos_conv_embed.conv."
    g, v = (("weight_g", "weight_v") if weight_norm == "weight_g" else
            ("parametrizations.weight.original0",
             "parametrizations.weight.original1"))
    k = spec.num_conv_pos_embeddings
    out[conv + "bias"] = (h,)
    out[conv + g] = (1, 1, k)
    out[conv + v] = (h, h // spec.num_conv_pos_embedding_groups, k)
    out.update(_norm_layout(f"{p}encoder.layer_norm", h))
    for i in range(spec.encoder.layers):
        q = f"{p}encoder.layers.{i}."
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out.update(_linear_layout(f"{q}attention.{name}", h, h))
        out.update(_norm_layout(f"{q}layer_norm", h))
        out.update(_linear_layout(f"{q}feed_forward.intermediate_dense", h,
                                  f))
        out.update(_linear_layout(f"{q}feed_forward.output_dense", f, h))
        out.update(_norm_layout(f"{q}final_layer_norm", h))
    out.update(_linear_layout("projector", h, projector))
    out.update(_linear_layout("classifier", projector, labels))
    return out


def videomae_layout(spec: VideoMAESpec, labels: int) -> dict:
    """``VideoMAEForVideoClassification``'s names and shapes at ``spec``
    (mean pooling): the ``videomae.`` tower with q and v biases, then
    ``fc_norm`` and ``classifier``."""
    h, f, p = spec.encoder.hidden, spec.encoder.intermediate, "videomae."
    proj = f"{p}embeddings.patch_embeddings.projection"
    out = {f"{proj}.weight": (h, spec.channels, spec.tubelet_size,
                              spec.patch_size, spec.patch_size),
           f"{proj}.bias": (h,)}
    for i in range(spec.encoder.layers):
        q = f"{p}encoder.layer.{i}."
        a = f"{q}attention.attention."
        out[f"{a}q_bias"] = (h,)
        out[f"{a}v_bias"] = (h,)
        for name in ("query", "key", "value"):
            out[f"{a}{name}.weight"] = (h, h)
        out.update(_linear_layout(f"{q}attention.output.dense", h, h))
        out.update(_linear_layout(f"{q}intermediate.dense", h, f))
        out.update(_linear_layout(f"{q}output.dense", f, h))
        out.update(_norm_layout(f"{q}layernorm_before", h))
        out.update(_norm_layout(f"{q}layernorm_after", h))
    out.update(_norm_layout("fc_norm", h))
    out.update(_linear_layout("classifier", h, labels))
    return out


def slow_r50_layout(stages=SLOW_STAGES) -> dict:
    """pytorchvideo's slow_r50 backbone names and shapes (stem, then per
    stage the bottlenecks' ``branch2`` convs and norms and the first
    block's ``branch1`` shortcut), as ``tests/test_slow_r50_import.py``
    lays them out."""
    def bn(name, c):
        return {**_norm_layout(name, c), f"{name}.running_mean": (c,),
                f"{name}.running_var": (c,)}
    out = {"blocks.0.conv.weight": (64, 3, 1, 7, 7),
           **bn("blocks.0.norm", 64)}
    c_in = 64
    for s, (blocks, w, tk) in enumerate(zip(stages, (64, 128, 256, 512),
                                            (1, 1, 3, 3))):
        for b in range(blocks):
            pre = f"blocks.{s + 1}.res_blocks.{b}"
            cin = c_in if b == 0 else w * 4
            out[f"{pre}.branch2.conv_a.weight"] = (w, cin, tk, 1, 1)
            out.update(bn(f"{pre}.branch2.norm_a", w))
            out[f"{pre}.branch2.conv_b.weight"] = (w, w, 1, 3, 3)
            out.update(bn(f"{pre}.branch2.norm_b", w))
            out[f"{pre}.branch2.conv_c.weight"] = (w * 4, w, 1, 1, 1)
            out.update(bn(f"{pre}.branch2.norm_c", w * 4))
            if b == 0:
                out[f"{pre}.branch1_conv.weight"] = (w * 4, cin, 1, 1, 1)
                out.update(bn(f"{pre}.branch1_norm", w * 4))
        c_in = w * 4
    return out


def pretrained_checkpoints(spec: TAVSpec, base: Wav2Vec2Spec,
                           stages=SLOW_STAGES) -> list:
    """Phase 12's checkpoints: (repo id, directory under the root, file,
    layout). The text one sits under its full repo id, the others under
    their basenames; slow_r50 is a file at the root."""
    return [
        (TEXT_EMOTION, TEXT_EMOTION, "model.safetensors",
         roberta_layout(spec.text, 7)),
        (AUDIO_XLSR, AUDIO_XLSR.split("/")[-1], "pytorch_model.bin",
         wav2vec2_layout(spec.audio, 8, "weight_g")),
        (VIDEO_MAE, VIDEO_MAE.split("/")[-1], "model.safetensors",
         videomae_layout(spec.video, 400)),
        (AUDIO_SUPERB, AUDIO_SUPERB.split("/")[-1], "pytorch_model.bin",
         wav2vec2_layout(base, 4, "parametrizations")),
        (SLOW_R50, "", "slow_r50.pyth", slow_r50_layout(stages))]


def draw_layout(layout: dict, rng: np.random.Generator) -> dict:
    """float32 values for ``layout``: norm scales 1 + 0.02 N(0, 1), running
    variances and weight-norm magnitudes uniform in [0.5, 1.5), everything
    else 0.02 N(0, 1)."""
    out = {}
    for name, shape in layout.items():
        if name.endswith(("running_var", "weight_g", "original0")):
            a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(0.02)
            if (len(shape) == 1 and name.endswith(".weight")
                    and "norm" in name.lower()):
                a += np.float32(1.0)
        out[name] = a
    return out


def write_safetensors(path: str, tensors: dict,
                      metadata: Optional[dict] = None) -> None:
    """``{name: array}`` → a ``.safetensors`` file laid out as the
    safetensors package writes one: an 8-byte little-endian header length,
    the JSON header (``__metadata__`` first, then per tensor its dtype,
    shape and data offsets) padded with spaces to a multiple of 8 bytes,
    then the data, packed in the header's order (the widest dtypes first,
    then by name), little-endian."""
    names = sorted(tensors, key=lambda k: (-tensors[k].dtype.itemsize, k))
    header = {"__metadata__": metadata} if metadata else {}
    offset = 0
    for k in names:
        a = tensors[k]
        header[k] = {"dtype": SAFETENSORS_CODES[a.dtype.name],
                     "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in names:
            a = tensors[k]
            np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tofile(f)


def write_checkpoint(root: str, entry, rng: np.random.Generator) -> dict:
    """One checkpoint of :func:`pretrained_checkpoints` under ``root``: a
    ``.safetensors`` file by :func:`write_safetensors`, a ``.bin`` by
    ``torch.save`` of the state dict, slow_r50 nested under
    ``model_state``. Returns its path, bytes and seconds."""
    repo, sub, name, layout = entry
    directory = os.path.join(root, sub)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    t = time.perf_counter()
    tensors = draw_layout(layout, rng)
    draw_s = time.perf_counter() - t
    t = time.perf_counter()
    if name.endswith(".safetensors"):
        write_safetensors(path, tensors, {"format": "pt"})
    else:
        sd = {k: torch.from_numpy(v) for k, v in tensors.items()}
        torch.save({"model_state": sd} if repo == SLOW_R50 else sd, path)
    return {"path": path, "bytes": os.path.getsize(path),
            "parameters": int(sum(a.size for a in tensors.values())),
            "draw_s": draw_s, "write_s": time.perf_counter() - t}


def pos_conv_fold(sd: dict, prefix: str) -> np.ndarray:
    """The positional conv's dense weight [out, in/g, k] folded from the
    file's weight norm in float64."""
    for g, v in (("weight_g", "weight_v"),
                 ("parametrizations.weight.original0",
                  "parametrizations.weight.original1")):
        if f"{prefix}.{g}" in sd:
            g = sd[f"{prefix}.{g}"].astype(np.float64)
            v = sd[f"{prefix}.{v}"].astype(np.float64)
            return g * v / np.maximum(
                np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True)), 1e-12)
    raise KeyError(f"{prefix}: no weight-norm keys")


def fold_rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got - want| / max |want|."""
    got = got.detach().double().cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape and the same bits (b moved to a's device)."""
    return (tuple(a.shape) == tuple(b.shape)
            and bool(torch.equal(a, b.to(a.device))))


def tav_leaf_checks(model: TAVModel, files: dict, init: dict,
                    spec: TAVSpec) -> dict:
    """Phase 12 (2): the loaded ``TAVModel``'s leaves, where they live,
    against the files (``files``: repo id → the file's state dict) and the
    drawn tree ``init`` (``init_params`` at the model's seed). Bit for bit:
    the word table, text layer 0's fused qkv weight and bias, the VideoMAE
    tubelet kernel and layer 0's q / zero k / v bias, the PreFormer's
    copies of the towers' leaves and everything the files do not hold.
    The folded positional conv to ``POS_FOLD_RTOL`` of a float64 fold."""
    state = model.state_dict()
    text = strip_model_prefix(files[TEXT_EMOTION])
    audio = strip_model_prefix(files[AUDIO_XLSR])
    video = strip_model_prefix(files[VIDEO_MAE])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    e = spec.text.encoder
    q = "encoder.layer.0.attention.self."
    at = "model.text_encoder.encoder.layer_0.attention."
    w = video["embeddings.patch_embeddings.projection.weight"]
    v = spec.video.encoder
    a = "encoder.layer.0.attention.attention."
    zeros = np.zeros(v.hidden, np.float32)
    out = {
        "word_table": same(state["model.text_encoder.embeddings.word.weight"],
                           t(text["embeddings.word_embeddings.weight"])),
        "text_qkv": same(state[at + "qkv.weight"], torch.cat(
            [t(text[f"{q}{n}.weight"]) for n in ("query", "key", "value")])),
        "text_qkv_bias": same(state[at + "qkv_bias"], torch.stack(
            [t(text[f"{q}{n}.bias"]) for n in ("query", "key", "value")]
        ).reshape(3, e.heads, e.hidden // e.heads)),
        "tubelet_kernel": same(
            state["model.videomae.patch_embed.proj.weight"],
            t(w.transpose(0, 2, 3, 4, 1).reshape(w.shape[0], -1))),
        "video_qkv_bias_zero_k": same(
            state["model.videomae.encoder.layer_0.attention.qkv_bias"],
            t(np.stack([video[a + "q_bias"], zeros, video[a + "v_bias"]])
              .reshape(3, v.heads, v.hidden // v.heads)))}
    out["pos_conv_rel_err"] = fold_rel_err(
        state["model.wav2vec2.encoder.pos_conv.conv.weight"],
        pos_conv_fold(audio, "encoder.pos_conv_embed.conv"))
    copies = (("preformer.text_embeddings.", "model.text_encoder.embeddings."),
              ("preformer.feature_extractor.",
               "model.wav2vec2.feature_extractor."),
              ("preformer.feature_projection.",
               "model.wav2vec2.feature_projection."),
              ("preformer.pos_conv.", "model.wav2vec2.encoder.pos_conv."),
              ("preformer.audio_ln.",
               "model.wav2vec2.encoder.layers.final_ln."),
              ("preformer.masked_spec_embed",
               "model.wav2vec2.masked_spec_embed"),
              ("preformer.video.patch_embed.",
               "model.videomae.patch_embed."))
    out["preformer_copies"] = {}
    for mine, tower in copies:
        keys = [k for k in state if k.startswith(mine)]
        out["preformer_copies"][mine.rstrip(".")] = len(keys) > 0 and all(
            same(state[k], state[tower + k[len(mine):]]) for k in keys)
    m = init["model"]
    drawn = {"model": {k: m[k] for k in (
        "modality_embedding", "wav_to_hidden", "fusion_encoder",
        "text_norm", "fusion_norm", "audio_norm", "video_norm",
        "classifier")}, "preformer": {
        "wav_to_hidden": init["preformer"]["wav_to_hidden"]}}
    # the classifier checkpoint has no pooler: the text tower keeps its draw
    drawn["model"]["text_encoder"] = {"pooler": m["text_encoder"]["pooler"]}
    want = from_flax(drawn)
    out["drawn_leaves"] = len(want)
    out["drawn_as_seeded"] = all(same(state[k], v) for k, v in want.items())
    out["ok"] = (all(v for k, v in out.items() if isinstance(v, bool))
                 and all(out["preformer_copies"].values())
                 and out["pos_conv_rel_err"] <= POS_FOLD_RTOL)
    return out


def loaded_leaves(tree: dict) -> dict:
    """``tree`` without its shape-only leaves."""
    return {k: loaded_leaves(v) if isinstance(v, dict) else v
            for k, v in tree.items() if not isinstance(v, ShapeDtype)}


def checkpoint_times(root: str, entries: list, spec: TAVSpec,
                     base: Wav2Vec2Spec, stages=SLOW_STAGES,
                     device: str = "cuda") -> Tuple[dict, dict]:
    """Phase 12 (5): per checkpoint the seconds to read it (this package's
    safetensors reader or ``torch.load``), to convert it and merge it into
    its model's flax tree (shapes only: ``convert.flax_shapes``) and to
    load the leaves it filled onto the card. Returns (the files' state
    dicts, the times)."""
    tav = flax_shapes(TAVModel(spec, device="meta"))["model"]
    targets = {
        TEXT_EMOTION: (lambda sd: convert_text_encoder(sd, spec.text),
                       tav["text_encoder"]),
        AUDIO_XLSR: (lambda sd: convert_wav2vec2(sd, spec.audio),
                     tav["wav2vec2"]),
        VIDEO_MAE: (lambda sd: convert_videomae(sd, spec.video),
                    tav["videomae"]),
        AUDIO_SUPERB: (lambda sd: convert_wav2vec2(sd, base), flax_shapes(
            Wav2Vec2Classifier(base, 7, device="meta"))["wav2vec2"]),
        SLOW_R50: (lambda sd: convert_slow_r50(sd, stages)["params"],
                   flax_shapes(SlowR50(7, stage_sizes=stages,
                                       device="meta")))}
    files, times = {}, {}
    for repo, sub, name, _ in entries:
        path = os.path.join(root, sub, name)
        t = time.perf_counter()
        if repo == SLOW_R50:
            sd = state_dict_np(torch.load(path, map_location="cpu",
                                          weights_only=True)["model_state"])
        else:
            sd = load_local_state_dict(find_checkpoint_dir(root, repo))
        read_s = time.perf_counter() - t
        convert, target = targets[repo]
        t = time.perf_counter()
        merged, missing, _ = merge_params(
            target, convert(strip_model_prefix(sd)))
        convert_s = time.perf_counter() - t
        t = time.perf_counter()
        on_card = {k: v.to(device)
                   for k, v in from_flax(loaded_leaves(merged)).items()}
        if device == "cuda":
            torch.cuda.synchronize()
        times[repo] = {"read_s": read_s, "convert_merge_s": convert_s,
                       "to_card_s": time.perf_counter() - t,
                       "filled": len(on_card), "unfilled": len(missing)}
        files[repo] = sd
        del on_card, merged
    return files, times


def captured(fn, *args):
    """(fn(*args), the lines it printed), the lines also echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue().splitlines()


def pretrained_tav(files: dict, directory: str, card: str) -> dict:
    """Phase 12 (2)-(3) with ``MME_PRETRAINED`` set: ``tav_nn.build_model``
    at full width in bf16, its leaves, then phase 4's batch of 8 served
    with the knobs off and on, then ``tav_nn.train`` for a few bf16 steps
    with every knob, each call's launches against the spec, and K1/K2/K4/
    K5 held at the shapes fed."""
    cfg = ExperimentConfig(batch_size=8, epoch=1, output_dim=7, seed=SEED,
                           dataset="pretrained",
                           audio_max_samples=PRETRAINED_AUDIO,
                           checkpoint_dir=directory)
    with environ({"MME_DTYPE": "bf16"}):
        spec, audio_len, text_len = tav_nn.tav_spec(cfg)
    t = time.perf_counter()
    init = init_params(spec, cfg.seed)
    init_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, lines = captured(tav_nn.build_model, cfg, spec, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    loaded = [x.split(": ", 1)[1] for x in lines
              if x.startswith("loaded pretrained tower: ")]
    checks = tav_leaf_checks(model, files, init, spec)
    del init
    out = {"build_model_s": build_s, "init_params_s": init_s,
           "loaded": loaded, "leaves": checks,
           "build_peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    reqs = requests(spec)[:1]                 # phase 4's batch of 8
    ln_per_chunk = sum(fused_ln_shapes(spec, 8).values())
    pred = Predictor(model, batch_size=8, device="cuda")
    serve(pred, reqs)                         # warm-up: cuDNN's choices
    kernels.reset_launches()
    t = time.perf_counter()
    off = serve(pred, reqs)
    off_ms = (time.perf_counter() - t) * 1e3
    off_launches = dict(kernels.LAUNCHES)
    with knobs_on():
        serve(pred, reqs)
        kernels.reset_launches()
        t = time.perf_counter()
        on = serve(pred, reqs)
        on_ms = (time.perf_counter() - t) * 1e3
        on_launches = dict(kernels.LAUNCHES)
    diff = float(np.abs(on[0] - off[0]).max())
    served_ok = (all(np.isfinite(p).all() and p.shape == (8, 7)
                     for p in off + on)
                 and diff <= SERVE_TOL[torch.bfloat16]
                 and off_launches["flash_fwd"] == LAUNCHES_PER_CHUNK
                 and off_launches["fused_mlp_fwd"] == 0
                 and on_launches["flash_fwd"] == on_launches[
                     "fused_mlp_fwd"] == LAUNCHES_PER_CHUNK
                 and on_launches["layer_norm_fwd"] == ln_per_chunk)
    out["serve"] = {"ms_knobs_off": off_ms, "ms_knobs_on": on_ms,
                    "max_abs_probs_on_vs_off": diff,
                    "launches_knobs_off": off_launches,
                    "launches_knobs_on": on_launches, "ok": served_ok}
    del pred

    (n_train, s_train), *evals = PRETRAINED_SIZES
    train_ds = synthetic_tav_dataset(spec, n_train, text_len, audio_len,
                                     seed=s_train)
    val_ds, test_ds = (synthetic_tav_dataset(spec, n, text_len, audio_len,
                                             seed=s) for n, s in evals)
    torch.cuda.reset_peak_memory_stats()
    with environ(PRETRAINED_TRAIN_ENV):
        with recorded_calls(model, True) as (calls, finite):
            kernels.reset_launches()
            tav_nn.train(cfg, model, spec, audio_len, train_ds, val_ds,
                         test_ds, None, bucketed=False, device="cuda")
    end = calls.pop()
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    losses = {k: d[k] for d in logs for k in ("train/loss", "val/loss",
                                              "test/loss") if k in d}
    bad = []
    for c in calls:
        want = expected_launches(spec, c)
        got = {k: c["delta"].get(k, 0) for k in want}
        if got != want:
            bad.append({"train": c["train"], "rows": c["rows"],
                        "launches": got, "expected": want})
    steps = [c for c in calls if c["train"]]
    out["train"] = {
        "steps": len(steps), "eval_batches": len(calls) - len(steps),
        "losses": losses, "step_ms": [c["ms"] for c in steps],
        "launches": end["launches"], "launch_mismatches": bad,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ok": (not bad and len(steps) == n_train // 8 and len(losses) == 3
               and all(np.isfinite(v) for v in losses.values())
               and all(finite) and len(finite) == len(calls))}
    del model
    torch.cuda.empty_cache()
    print(json.dumps({"pretrained_tav": {**out, "card": card}}),
          flush=True)
    if not (checks["ok"] and served_ok and out["train"]["ok"]
            and loaded == [TEXT_EMOTION, AUDIO_XLSR, VIDEO_MAE]):
        raise SystemExit("phase 12: the pretrained TAVModel failed its "
                         "checks")
    bucket_holds(spec, {(c["rows"], c["samples"]) for c in calls}, text_len,
                 card)
    return end["launches"]


def pretrained_classifiers(files: dict, card: str) -> dict:
    """Phase 12 (4): ``BertClassifier`` (distilroberta),
    ``Wav2Vec2Classifier`` (wav2vec2-base) and ``SlowR50`` at full width,
    loaded by ``text_nn``'s, ``audio_nn_wav2vec``'s and ``visual_nn``'s
    ``load_weights`` with ``MME_PRETRAINED`` set; a leaf of each against
    its file, SlowR50's BatchNorm buffers against the file's running
    statistics; one served batch of 8 each (fp32)."""
    text = strip_model_prefix(files[TEXT_EMOTION])
    base = strip_model_prefix(files[AUDIO_SUPERB])
    slow = files[SLOW_R50]
    tspec, bspec = TextEncoderSpec.distilroberta(), Wav2Vec2Spec.base()
    cases = (
        ("BertClassifier", lambda: BertClassifier(tspec, 7, 0.5,
                                                  device="cuda"),
         lambda net: text_nn.load_weights(net, tspec, SEED),
         "loaded pretrained text tower", ("input_ids", "text_mask"),
         ZOO_MODELS["BertClassifier"].data(8, 160).features, 6,
         lambda net: {"word_table": same(
             net.bert.embeddings.word.weight,
             torch.from_numpy(text["embeddings.word_embeddings.weight"]))}),
        ("Wav2Vec2Classifier", lambda: Wav2Vec2Classifier(bspec, 7, 0.5,
                                                          device="cuda"),
         lambda net: audio_nn_wav2vec.load_weights(net, bspec, SEED),
         "loaded pretrained audio tower", ("waveform", "audio_mask"),
         ZOO_MODELS["Wav2Vec2Classifier"].data(8, 161).features, 12,
         lambda net: {
             "projection": same(
                 net.wav2vec2.feature_projection.projection.weight,
                 torch.from_numpy(
                     base["feature_projection.projection.weight"])),
             "pos_conv_rel_err": fold_rel_err(
                 net.wav2vec2.encoder.pos_conv.conv.weight,
                 pos_conv_fold(base, "encoder.pos_conv_embed.conv"))}),
        ("SlowR50", lambda: SlowR50(7, stage_sizes=SLOW_STAGES,
                                    device="cuda"),
         lambda net: visual_nn.load_weights(net, SLOW_STAGES, SEED),
         "loaded pretrained slow_r50 backbone", ("video",),
         visual_nn.synthetic_video(8, 16, 224, 7, 162).features, 0,
         lambda net: slow_r50_checks(net, slow)))
    out = {}
    for name, build, load, line, inputs, feats, flash, check in cases:
        torch.cuda.reset_peak_memory_stats()
        net = build()
        t = time.perf_counter()
        _, lines = captured(load, net)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        leaves = check(net)
        pred = Predictor(BatchModel(net, inputs), batch_size=8,
                         device="cuda")
        pred(feats)                                     # warm-up
        kernels.reset_launches()
        t = time.perf_counter()
        probs = pred(feats)[1]
        ms = (time.perf_counter() - t) * 1e3
        launches = kernels.LAUNCHES["flash_fwd"]
        ok = (any(x.startswith(line) for x in lines)
              and all(v for v in leaves.values() if isinstance(v, bool))
              and leaves.get("pos_conv_rel_err", 0.0) <= POS_FOLD_RTOL
              and probs.shape == (8, 7) and np.isfinite(probs).all()
              and launches == flash)
        out[name] = {"load_weights_s": load_s, "leaves": leaves,
                     "serve_ms": ms, "flash_fwd": launches,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "ok": bool(ok)}
        del pred, net
        torch.cuda.empty_cache()
    print(json.dumps({"pretrained_classifiers": {**out, "card": card}}),
          flush=True)
    if not all(v["ok"] for v in out.values()):
        raise SystemExit("phase 12: a pretrained classifier failed its "
                         "checks")
    return out


def slow_r50_checks(net: SlowR50, sd: dict, stages=SLOW_STAGES) -> dict:
    """The stem conv against the file, and every BatchNorm's running mean
    and variance (the module's buffers) against the file's
    ``running_mean`` / ``running_var``, bit for bit."""
    stats = from_flax({}, convert_slow_r50(sd, stages)["batch_stats"])
    state = net.state_dict()
    return {"stem_conv": same(state["stem_conv.weight"],
                              torch.from_numpy(sd["blocks.0.conv.weight"])),
            "bn_buffers": len(stats),
            "bn_buffers_equal": all(same(state[k], v)
                                    for k, v in stats.items())}


def pretrained(card: str) -> dict:
    """Phase 12. Returns the TAV train run's launches by kernel."""
    t0 = time.perf_counter()
    spec = TAVSpec(output_dim=7)
    entries = pretrained_checkpoints(spec, Wav2Vec2Spec.base())
    root = tempfile.mkdtemp(prefix="mme_pretrained_")
    try:
        rng = np.random.default_rng(SEED + 140)
        written = {e[0]: write_checkpoint(root, e, rng) for e in entries}
        files, times = checkpoint_times(root, entries, spec,
                                        Wav2Vec2Spec.base())
        print(json.dumps({"pretrained_checkpoints": {
            repo: {**written[repo], **times[repo]} for repo in written},
            "card": card}), flush=True)
        directory = os.path.join(root, "run")
        os.makedirs(directory)
        with environ({"MME_PRETRAINED": root}):
            launches = pretrained_tav(files, directory, card)
            pretrained_classifiers(files, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches



# phase 13: the parallel axes, part one, as two ranks on the one card. NCCL
# refuses two ranks on one GPU, so the ranks join a gloo group
# (MME_DIST_BACKEND=gloo): every collective and every ring hop of a CUDA
# tensor is staged through pinned host memory (parallel/mesh.py's
# ``_gloo_host`` branch). Each rank sits on cuda:0 in a process of its own
# (parallel/launch.py::RankPool through the env contract).
P13_SEED = SEED + 130
P13_WORLD = 2
P13_ENV = {"MME_DIST_BACKEND": "gloo"}
P13_RANK_TIMEOUT_S = 300
P13_FP32_BATCH = 4          # the global batch of the fp32 dp step
P13_BF16_BATCH = 8          # the global batch of the timed bf16 dp steps
P13_SP_BATCH = 2
P13_LR = 1e-4
P13_BF16_ENV = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1",
                "MME_FUSED_LN": "1", "MME_FUSED_MLP": "1"}
P13_TOWERS = ("fusion", "video")
# phases 13-15 run every tower and the trunk at their first 6 layers (full
# width): their checks hold the same functions at half the parameters and
# half gloo's host traffic, and the script's time pays for phase 16
P13_DEPTH = 6
# fp32 dp=2 step against the single-rank step from the same state: the
# loss and grad norm as phase 5 holds kernels against MME_FLASH=0, and each
# gradient leaf within P13_GRAD_RTOL of its largest element (the ranks'
# partial sums add in another order). sp=2 against the unsharded model in
# fp32: the logits as served fp32 probabilities are held (SERVE_TOL), each
# gradient leaf within the same share (the ring merges hops in fp32 in
# another order)
P13_GRAD_RTOL = 1e-3
# the bf16 dp=2 all-reduce: a leaf's projection after it against the sum of
# the ranks' projections before it, within this many of its dtype's eps
# times the projection of the leaves' magnitudes (one rounding of a+b)
P13_REDUCE_EPS = 4.0


def _rank_setup() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _save_tree(tree: dict, path: str) -> None:
    """A flax-layout tree of numpy leaves as one torch file of tensors
    keyed by their '/'-joined paths."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = torch.from_numpy(
                    np.ascontiguousarray(v))

    walk(tree, ())
    torch.save(flat, path)


def _p13_params(path: str) -> dict:
    """The phase's weights (drawn once by the parent: phase 5's draw, or
    from P13_SEED when phase 5 did not run), read
    back from ``path`` as a flax-layout tree of numpy leaves."""
    tree: dict = {}
    for key, t in torch.load(path, weights_only=True, mmap=True).items():
        *parents, leaf = key.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t.numpy()
    return tree


def _p13_spec(dtype=torch.float32, quiet: bool = True) -> TAVSpec:
    spec = TAVSpec(output_dim=7)
    if quiet:
        spec = without_noise(spec)
    return depth_cut(dataclasses.replace(spec.with_compute_dtype(dtype),
                                         share_audio_frontend=True),
                     P13_DEPTH)


def _free() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _handed_grads(model: torch.nn.Module, into: dict):
    """Note, by parameter name, the gradients a training step hands its
    optimizer (after the dp all-reduce, before the clip)."""
    from mme_tpu_torch.train.optim import Optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    plain = Optimizer.update

    def noted(self, params, grads, state, generator=None):
        into.update({names[id(p)]: g.detach().clone()
                     for p, g in zip(params, grads)})
        return plain(self, params, grads, state, generator)

    Optimizer.update = noted
    try:
        yield into
    finally:
        Optimizer.update = plain


def _worst_grad_share(pairs) -> Tuple[float, Optional[str]]:
    """Over ``(name, grad, reference)`` triples, the largest
    ``max|grad - reference| / max|reference|`` among leaves whose
    reference is not all zero (such a leaf must be all zero too), and its
    leaf."""
    worst, worst_name = 0.0, None
    for name, g, w in pairs:
        top = w.abs().max().item()
        share = ((g - w).abs().max().item() / top if top > 0
                 else float("inf") if g.abs().max().item() > 0 else 0.0)
        if share > worst:
            worst, worst_name = share, name
    return worst, worst_name


def _projection(g: torch.Tensor, leaf: int) -> Tuple[float, float]:
    """A fixed linear functional of a gradient leaf, Σ w·g with w a
    cosine of the element's index and the leaf's number, and Σ |w·g|, in
    fp64."""
    x = g.detach().reshape(-1).double()
    w = torch.cos(torch.arange(x.numel(), device=x.device,
                               dtype=torch.float64) * 0.7 + leaf)
    return (w * x).sum().item(), (w * x).abs().sum().item()


def p13_dp_fp32(ref: dict) -> dict:
    """A rank of the fp32 dp=2 step: the same weights (broadcast from rank
    0 by ``replicate``) and this rank's 2 rows of the global batch of 4;
    loss, grad norm and every gradient leaf the optimizer is handed against
    the single-rank step's, saved at ``ref["path"]``."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    _rank_setup()
    t0 = time.perf_counter()
    spec = _p13_spec()
    mesh = make_mesh(P13_WORLD, 1)
    cfg = ExperimentConfig(batch_size=P13_FP32_BATCH,
                           learning_rate=P13_LR, text_max_len=70,
                           audio_max_samples=96000)
    model, state, step, _ = build_tav(spec, cfg, 1000,
                                      params=_p13_params(ref["weights"]),
                                      remat=False, use_accum=False,
                                      device="cuda", mesh=mesh)
    replicate(model, mesh)
    batch, labels, mask, cw = train_inputs(spec, P13_FP32_BATCH,
                                           P13_SEED + 1)
    local = shard_batch({**batch, "_labels": labels, "_mask": mask}, mesh)
    labels, mask = local.pop("_labels"), local.pop("_mask")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    grads: dict = {}
    with _handed_grads(model, grads):
        _, loss, cm, norm = step(state, local, labels, mask, cw, 1.0, True,
                                 SEED)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = torch.load(ref["path"], map_location="cuda", weights_only=True)
    worst, worst_name = _worst_grad_share(
        (n, grads[n], w) for n, w in want.items())
    out = {"rank": distributed.rank(), "device": str(state.params[0].device),
           "transport": mesh.world.transport(state.params[0]),
           "loss": loss.item(), "grad_norm": float(norm),
           "cm_sum": int(cm.sum()), "same_leaves": set(grads) == set(want),
           "worst_grad_share": worst, "worst_grad_leaf": worst_name,
           "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    del model, state, step, want, grads
    _free()
    return out


def _reduce_holds(projected: list) -> bool:
    """Every rank saw the same sums leaf by leaf, and each equals the sum
    of the ranks' projections before the all-reduce, to one rounding."""
    first = projected[0]
    n = len(first["after"])
    if any(len(p["before"]) != n or p["after"] != first["after"]
           for p in projected):
        return False
    for j in range(n):
        want = sum(p["before"][j][0] for p in projected)
        scale = sum(p["before"][j][1] for p in projected)
        if abs(first["after"][j] - want) > (P13_REDUCE_EPS
                                            * first["eps"][j] * scale):
            return False
    return True


def p13_dp_bf16(weights: str, steps: int, warmup: int) -> dict:
    """A rank of the bf16 dp=2 steps at the global batch of 8 with every
    knob on: ms per step (host clock, synchronised), the all-reduce's
    share of it, launches of one step, this rank's peak memory, and the
    warm-up's first all-reduce projected leaf by leaf (:func:`_projection`)
    before and after."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import AxisGroup, make_mesh, shard_batch
    _rank_setup()
    t0 = time.perf_counter()
    spec = _p13_spec(torch.bfloat16, quiet=False)
    mesh = make_mesh(P13_WORLD, 1)
    reduce_ms = []
    plain = AxisGroup.all_reduce_many
    projected: dict = {}

    def timed(self, tensors):
        first = not projected
        if first:
            projected["before"] = [_projection(g, j)
                                   for j, g in enumerate(tensors)]
            projected["eps"] = [torch.finfo(g.dtype).eps for g in tensors]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain(self, tensors)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)
        if first:
            projected["after"] = [_projection(g, j)[0]
                                  for j, g in enumerate(out)]
        return out

    os.environ.update(P13_BF16_ENV)
    AxisGroup.all_reduce_many = timed
    try:
        cfg = ExperimentConfig(batch_size=P13_BF16_BATCH,
                               learning_rate=5e-6, text_max_len=70,
                               audio_max_samples=96000)
        model, state, step, _ = build_tav(
            spec, cfg, 1000, params=_p13_params(weights), remat=False,
            use_accum=False, device="cuda", mesh=mesh)
        batch, labels, mask, cw = train_inputs(spec, P13_BF16_BATCH,
                                               P13_SEED + 2)
        local = shard_batch({**batch, "_labels": labels, "_mask": mask},
                            mesh)
        labels, mask = local.pop("_labels"), local.pop("_mask")
        local = to_device(local, "cuda")
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for i in range(warmup + steps):
            reduce_ms.clear()
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, loss, _, _ = step(state, local, labels, mask, cw, 1.0, True,
                                 SEED + i)
            torch.cuda.synchronize()
            if i >= warmup:
                ms.append((time.perf_counter() - t) * 1e3)
                losses.append(loss.item())
                shares = sum(reduce_ms) / ms[-1]
        launches = dict(kernels.LAUNCHES)
        n_ln = sum(fused_ln_shapes(spec, P13_BF16_BATCH // P13_WORLD)
                   .values())
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        AxisGroup.all_reduce_many = plain
        for k in P13_BF16_ENV:
            del os.environ[k]
    out = {"rank": distributed.rank(), "ms_per_step": ms,
           "all_reduce_ms_last": sum(reduce_ms),
           "all_reduce_share_last": shares,
           "losses": losses, "launches": launches,
           "expected_layer_norm": n_ln, "peak_gb": peak,
           "projected": projected, "seconds": time.perf_counter() - t0}
    del model, state, step
    _free()
    return out


def _ring_shapes(record: list):
    """Wrap the ring's K1 calls to note their (q, k) shapes."""
    from mme_tpu_torch.ops import ring_attention as ra
    plain = ra.flash_attention_fwd

    def noted(q, k, v, bias):
        record.append((tuple(q.shape), tuple(k.shape), str(q.dtype)))
        return plain(q, k, v, bias)

    ra.flash_attention_fwd = noted
    return lambda: setattr(ra, "flash_attention_fwd", plain)


def p13_sp(tower: str, weights: str) -> dict:
    """A rank of sp=2 through the CLI path: ``tav_nn.tav_spec`` at full
    width, ``parallel_spec`` with ``MME_SP=2 MME_SP_TOWER=tower`` and
    ``MME_SHARE_FRONTEND=1`` (the phase's tree), ``build_model`` loading
    the phase's weights from ``weights`` where it would draw them; the
    unsharded model on the same weights beside it.
    fp32, dropout and SpecAugment off, the fixed keep-mask. The eval
    logits, then one training forward and backward: loss, every gradient
    leaf, and K1/K2 launches per rank against ring layers × hops plus the
    unsharded layers."""
    from mme_tpu_torch.parallel import distributed
    _rank_setup()
    t0 = time.perf_counter()
    env = {"MME_SP": str(P13_WORLD), "MME_SP_TOWER": tower,
           "MME_SHARE_FRONTEND": "1"}
    os.environ.update(env)
    tav_nn.init_params = lambda *a, **k: _p13_params(weights)
    try:
        cfg = ExperimentConfig(output_dim=7, dataset="chip_smoke_p13",
                               seed=P13_SEED, batch_size=P13_SP_BATCH,
                               dropout=0.0)
        base, _, _ = tav_nn.tav_spec(cfg)
        base = depth_cut(without_noise(base), P13_DEPTH)
        spec, mesh = tav_nn.parallel_spec(cfg, base)
        model = tav_nn.build_model(cfg, spec, "cuda")
    finally:
        tav_nn.init_params = init_params
        for k in env:
            del os.environ[k]
    ref = TAVModel(base, device="cuda")
    ref.load_state_dict(model.state_dict())
    batch, labels, mask, cw = train_inputs(base, P13_SP_BATCH, P13_SEED + 3)
    batch = make_video_keep_transform(base, random_mask=False)(
        None, to_device(batch, "cuda"))
    labels, mask, cw = (torch.as_tensor(x, device="cuda")
                        for x in (labels, mask, cw))
    shapes: list = []
    undo = _ring_shapes(shapes)
    try:
        model.eval()
        ref.eval()
        with torch.no_grad():
            kernels.reset_launches()
            logits = model(batch)
            torch.cuda.synchronize()
            fwd_launches = dict(kernels.LAUNCHES)
            want_logits = ref(batch)
        model.train()
        ref.train()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        loss = cross_entropy(model(batch), labels, cw, mask)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        step_launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        undo()
    want_loss = cross_entropy(ref(batch), labels, cw, mask)
    want = torch.autograd.grad(want_loss, list(ref.parameters()),
                               allow_unused=True)

    def step_ms(m):
        """Host ms of one synchronised training forward and backward
        (the mean of 2, after the ones above)."""
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.autograd.grad(cross_entropy(m(batch), labels, cw, mask),
                                list(m.parameters()), allow_unused=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    ring_ms, whole_ms = step_ms(model), step_ms(ref)
    leaves = [(name, torch.zeros_like(p) if g is None else g,
               torch.zeros_like(p) if w is None else w)
              for (name, p), g, w in zip(model.named_parameters(), grads,
                                         want)]
    norm2 = sum(g.double().square().sum().item() for _, g, _ in leaves)
    norm2_ref = sum(w.double().square().sum().item() for _, _, w in leaves)
    worst, worst_name = _worst_grad_share(leaves)
    ring_layers = (spec.fusion.layers if tower == "fusion"
                   else getattr(spec, tower).encoder.layers)
    layers = (spec.text.encoder.layers + spec.audio.encoder.layers
              + spec.video.encoder.layers + spec.fusion.layers)
    per_call = layers - ring_layers + ring_layers * P13_WORLD
    probs = torch.softmax(logits.float(), -1)
    want_probs = torch.softmax(want_logits.float(), -1)
    out = {"rank": distributed.rank(), "tower": tower,
           "transport": mesh.axis("sp").transport(logits),
           "ring_layers": ring_layers, "hops": P13_WORLD,
           "expected_k1_k2": per_call, "expected_prepass": ring_layers,
           "launches_forward": fwd_launches, "launches_step": step_launches,
           "logit_max_diff": (logits - want_logits).abs().max().item(),
           "prob_max_diff": (probs - want_probs).abs().max().item(),
           "loss": loss.item(), "loss_unsharded": want_loss.item(),
           "grad_norm": norm2 ** 0.5, "grad_norm_unsharded": norm2_ref ** 0.5,
           "worst_grad_share": worst, "worst_grad_leaf": worst_name,
           "ring_shapes": sorted(set(shapes)), "peak_gb": peak,
           "ring_step_ms": ring_ms, "unsharded_step_ms": whole_ms,
           "seconds": time.perf_counter() - t0}
    del model, ref, grads, want
    _free()
    return out


def p13_serve(weights: str, reqs: list) -> dict:
    """A rank of mesh serving: ``Predictor(mesh=dp2)`` over chunks of 8,
    fp32, this rank's 4 rows of each; the probabilities gathered."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import make_mesh
    _rank_setup()
    t0 = time.perf_counter()
    spec = _p13_spec()
    model = TAVModel(spec, device="cuda")
    model.load_state_dict(from_flax(_p13_params(weights)))
    pred = Predictor(model, batch_size=8, device="cuda",
                     mesh=make_mesh(P13_WORLD, 1))
    kernels.reset_launches()
    probs = [pred(r)[1] for r in reqs]
    launches = dict(kernels.LAUNCHES)
    out = {"rank": distributed.rank(), "probs": probs,
           "launches": launches, "seconds": time.perf_counter() - t0}
    del model, pred
    _free()
    return out


def ring_hop_hold(B: int, L: int, H: int, D: int, dtype, seed: int) -> dict:
    """K1 per hop and K2's two kernels per hop with the one global
    pre-pass, on this process, at a ring's local shapes (P13_WORLD blocks
    of L keys): each against its plain version, then the merged hops'
    O / LSE and the summed gradients against the whole sequence's plain
    forward and backward. Batch row 1 has every key masked (the model's
    mask bias), row 0 a random key mask and a padded tail at -1e30: the
    pre-pass must restore row 1's log n of the whole context, which a
    per-block pre-pass would not."""
    from mme_tpu_torch.ops.flash_attention import (flash_bwd_prepass,
                                                   flash_bwd_prepass_plain)
    from mme_tpu_torch.ops.ring_attention import finish_merge, merge_block
    n = P13_WORLD
    S = n * L
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, L, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn(B, L, H, D, generator=g, device="cuda").to(dtype)
    keep = torch.rand(B, S, generator=g, device="cuda") > 0.3
    keep[1] = False
    bias = additive_mask(keep)[:, 0, 0, :].contiguous()
    bias[0, S - 3:] = -1e30
    blocks = [(k[:, i * L:(i + 1) * L], v[:, i * L:(i + 1) * L],
               bias[:, i * L:(i + 1) * L].contiguous()) for i in range(n)]
    tol = TOL[dtype]

    def merged(fwd):
        m = torch.full((B, H, L), float("-inf"), device="cuda")
        l = torch.zeros((B, H, L), device="cuda")
        acc = torch.zeros((B, L, H, D), device="cuda")
        for kb, vb, bb in blocks:
            o_i, lse_i = fwd(q, kb, vb, bb)
            m, l, acc = merge_block(m, l, acc, o_i, lse_i)
        return finish_merge(m, l, acc, dtype)

    kernels.reset_launches()
    out, lse = merged(flash_attention_fwd)
    k1_launches = kernels.LAUNCHES["flash_fwd"]
    out_p, lse_p = merged(flash_attention_fwd_plain)
    whole_o, whole_lse = flash_attention_fwd_plain(q, k, v, bias)
    fwd_err = (out.float() - out_p.float()).abs().max().item()
    whole_err = (out.float() - whole_o.float()).abs().max().item()
    lse_err = ((lse - lse_p).abs() / lse_p.abs().clamp(min=1.0)
               ).max().item()
    rows = flash_bwd_prepass(out, do, lse, bias)
    rows_p = flash_bwd_prepass_plain(out, do, lse, bias)
    pre_err = max((a - b).abs().max().item() for a, b in zip(rows, rows_p))
    got, plain = [], []
    for kb, vb, bb in blocks:
        got.append(flash_attention_bwd(q, kb, vb, bb, out, lse, do, rows))
        plain.append(flash_attention_bwd_plain(q, kb, vb, bb, out, lse, do,
                                               rows_p))
    torch.cuda.synchronize()

    def summed(parts):
        return (sum(p[0].float() for p in parts),
                torch.cat([p[1] for p in parts], 1),
                torch.cat([p[2] for p in parts], 1))

    ok_b, share, bwd_err = grads_close(summed(got), summed(plain), dtype)
    whole = flash_attention_bwd_plain(q, k, v, bias, out, lse, do)
    ok_w, share_w, _ = grads_close(summed(got), whole, dtype)
    # the masked row's dV under a pre-pass per block: n times too large
    per_block = [flash_attention_bwd_plain(q, kb, vb, bb, out, lse, do)
                 for kb, vb, bb in blocks]
    dv_block = summed(per_block)[2][1].float().abs().max().item()
    dv_ring = summed(got)[2][1].float().abs().max().item()
    k1_ms = cuda_ms(lambda: flash_attention_fwd(q, *blocks[0]))
    k1_plain_ms = cuda_ms(lambda: flash_attention_fwd_plain(q, *blocks[0]),
                          iters=5)
    k2_ms = cuda_ms(lambda: flash_attention_bwd(q, *blocks[0], out, lse, do,
                                                rows))
    k2_plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
        q, *blocks[0], out, lse, do, rows_p), iters=5)
    # the library's attention over one hop's block: SDPA forward, and its
    # backward through autograd
    kb, vb, bb = blocks[0]
    lib_in = [x.detach().transpose(1, 2).requires_grad_()
              for x in (q, kb, vb)]
    hop_mask = bb.to(dtype)[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=hop_mask)
    k1_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *lib_in, attn_mask=hop_mask))
    k2_lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, do.transpose(1, 2), retain_graph=True))
    del lib_out, lib_in
    res = {"B": B, "L": L, "S": S, "H": H, "D": D, "dtype": str(dtype)[6:],
           "k1_launches": k1_launches, "fwd_max_err": fwd_err,
           "lse_rel_err": lse_err, "vs_whole_sequence": whole_err,
           "prepass_max_err": pre_err, "bwd_max_err": bwd_err,
           "bwd_share_of_tol": share, "vs_whole_share_of_tol": share_w,
           "masked_row_max_dv_ring": dv_ring,
           "masked_row_max_dv_per_block_prepass": dv_block,
           "k1_hop_ms": k1_ms, "k1_hop_plain_ms": k1_plain_ms,
           "k1_hop_library_ms": k1_lib_ms,
           "k2_hop_ms": k2_ms, "k2_hop_plain_ms": k2_plain_ms,
           "k2_hop_library_ms": k2_lib_ms}
    print(json.dumps({"ring_hop_hold": res}), flush=True)
    excess = ((out.float() - out_p.float()).abs()
              - tol["rtol"] * out_p.float().abs()).max().item()
    if not (ok_b and ok_w and excess <= tol["atol"] and lse_err <= tol["lse"]
            and k1_launches == n and dv_block > 1.5 * dv_ring):
        raise SystemExit(f"the ring's K1/K2 hops disagree with their plain "
                         f"versions at B={B} L={L} {dtype}")
    return res


def parallel_axes(card: str, params: Optional[dict] = None) -> dict:
    """Phases 13, 14 and 15. Phase 13: the single-rank references on this
    process, then two ranks on the card (a pool of two processes, gloo):
    the fp32 dp=2 step, bf16 dp=2 steps with every knob, sp=2 on the
    fusion trunk and on the video tower through the CLI path, mesh
    serving; then the ring's hops held on this process at the local shapes
    the ranks fed K1. Phase 14 on the same pool and references: tp and ep
    (:func:`parallel_axes_two`); phase 15: pp (:func:`pipeline_axis`).
    ``params``: phase 5's draw of the same tree, used instead of drawing
    from ``P13_SEED``."""
    from mme_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    _rank_setup()
    spec = _p13_spec()
    if params is None:
        params = init_params(spec, P13_SEED)
    else:
        params = cut_tree(params, flax_shapes(TAVModel(spec, device="meta")))
    layers = tav_layers(spec)
    directory = tempfile.mkdtemp(prefix="mme_p13_")
    weights = os.path.join(directory, "weights.pt")
    _save_tree(params, weights)
    try:
        # the single-rank fp32 step on the global batch of 4
        cfg = ExperimentConfig(batch_size=P13_FP32_BATCH,
                               learning_rate=P13_LR, text_max_len=70,
                               audio_max_samples=96000)
        model, state, step, _ = build_tav(spec, cfg, 1000, params=params,
                                          remat=False, use_accum=False,
                                          device="cuda")
        batch, labels, mask, cw = train_inputs(spec, P13_FP32_BATCH,
                                               P13_SEED + 1)
        # the weights as loaded, put back after each step on the card
        snapshot = [p.detach().clone() for p in state.params]

        def reference(name, inputs, seed):
            grads: dict = {}
            state.step = 0
            with _handed_grads(model, grads):
                _, loss, _, norm = step(state, *inputs, 1.0, True, SEED)
            out = {"path": os.path.join(directory, f"{name}.pt"),
                   "weights": weights, "loss": loss.item(),
                   "grad_norm": float(norm), "seed": seed}
            torch.save({n: g.cpu() for n, g in grads.items()}, out["path"])
            with torch.no_grad():
                for p, w in zip(state.params, snapshot):
                    p.copy_(w)
            return out

        ref = reference("ref", (batch, labels, mask, cw), P13_SEED + 1)
        # phase 15's video reference: the step at the global batch of 2
        ref_video = reference("ref_video", train_inputs(spec, 2, P15_SEED),
                              P15_SEED)
        del snapshot
        single = Predictor(model, batch_size=8, device="cuda")
        reqs = requests(spec)
        want_probs = [single(r)[1] for r in reqs]
        del model, state, step, single, params
        _free()
        ref_s = time.perf_counter() - t0

        t = time.perf_counter()
        with RankPool(P13_WORLD, device="cuda", env=P13_ENV,
                      timeout_s=P13_RANK_TIMEOUT_S) as pool:
            spawn_s = time.perf_counter() - t
            dp = pool.run(f"{os.path.abspath(__file__)}:p13_dp_fp32", ref)
            bf16 = pool.run(f"{os.path.abspath(__file__)}:p13_dp_bf16",
                            weights, 1, 1)
            sp = {tw: pool.run(f"{os.path.abspath(__file__)}:p13_sp", tw,
                               weights) for tw in P13_TOWERS}
            served = pool.run(f"{os.path.abspath(__file__)}:p13_serve",
                              weights, reqs)
            ranks_s = time.perf_counter() - t
            t = time.perf_counter()
            two = parallel_axes_two(pool, ref, weights, reqs, want_probs,
                                    directory)
            two_s = time.perf_counter() - t
            t = time.perf_counter()
            pp = pipeline_axis(pool, ref, ref_video, weights, reqs)
            pp_s = time.perf_counter() - t
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    local = sorted({q for rs in sp.values()
                    for q, _, _ in rs[0]["ring_shapes"]})
    holds = [ring_hop_hold(B, L, H, D, dtype, P13_SEED + i)
             for i, (B, L, H, D) in enumerate(local)
             for dtype in (torch.float32, torch.bfloat16)]
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    served_diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                      for r in served for a, b in zip(r["probs"],
                                                      want_probs))
    reduce_ok = _reduce_holds([r.pop("projected") for r in bf16])
    out = {"reference_s": ref_s, "spawn_s": spawn_s, "ranks_s": ranks_s,
           "reference": {k: ref[k] for k in ("loss", "grad_norm")},
           "dp_fp32": dp, "dp_bf16": bf16, "dp_bf16_reduce_holds": reduce_ok,
           "sp": sp,
           "served_prob_max_diff": served_diff,
           "served_launches": [r["launches"] for r in served],
           "ring_hops": holds, "card_gb": total_gb,
           "phase_s": time.perf_counter() - t0 - two_s - pp_s,
           "card": card}
    print(json.dumps({"parallel_axes": {
        **out, "served_probs": None}}), flush=True)
    n_ln = bf16[0]["expected_layer_norm"]
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    checks = {
        "dp_fp32": all(
            abs(r["loss"] - ref["loss"]) <= TRAIN_LOSS_RTOL * abs(ref["loss"])
            and abs(r["grad_norm"] - ref["grad_norm"])
            <= TRAIN_NORM_RTOL * ref["grad_norm"]
            and r["same_leaves"] and r["worst_grad_share"] <= P13_GRAD_RTOL
            and r["cm_sum"] == P13_FP32_BATCH
            and r["launches"]["flash_fwd"] == r["launches"]["flash_bwd"]
            == layers and r["transport"] == "gloo-host"
            for r in dp),
        "dp_bf16": all(
            all(np.isfinite(r["losses"]))
            and r["launches"]["flash_fwd"] == r["launches"]["flash_bwd"]
            == r["launches"]["fused_mlp_fwd"]
            == r["launches"]["fused_mlp_bwd"] == layers
            and r["launches"]["layer_norm_fwd"]
            == r["launches"]["layer_norm_bwd"] == n_ln
            and r["launches"]["adam_update"] == 1 for r in bf16)
        and sum(r["peak_gb"] for r in bf16) < total_gb
        and reduce_ok,
        "sp": all(
            r["prob_max_diff"] <= SERVE_TOL[torch.float32]
            and abs(r["loss"] - r["loss_unsharded"])
            <= TRAIN_LOSS_RTOL * abs(r["loss_unsharded"])
            and abs(r["grad_norm"] - r["grad_norm_unsharded"])
            <= TRAIN_NORM_RTOL * r["grad_norm_unsharded"]
            and r["worst_grad_share"] <= P13_GRAD_RTOL
            and r["launches_forward"]["flash_fwd"] == r["expected_k1_k2"]
            and r["launches_step"]["flash_fwd"] == r["expected_k1_k2"]
            and r["launches_step"]["flash_bwd"] == r["expected_k1_k2"]
            and r["launches_step"]["flash_bwd_prepass"]
            == r["expected_prepass"] and r["transport"] == "gloo-host"
            for rs in sp.values() for r in rs),
        "serve": served_diff <= SERVE_TOL[torch.float32] and all(
            r["launches"]["flash_fwd"] == chunks * layers
            for r in served)}
    if not all(checks.values()):
        raise SystemExit(f"phase 13 (the parallel axes) failed: {checks}")
    # phases 14 and 15's clocks: their calls on the pool, then their
    # checks here
    two = parallel_axes_two_checks(two, ref, reqs, spec, card,
                                   time.perf_counter() - two_s)
    refs = {"fusion": ref, "video": ref_video}
    return {"dp": bf16[0]["launches"],
            "sp": {tw: rs[0]["launches_step"] for tw, rs in sp.items()},
            "two": two,
            "pp": pipeline_axis_checks(pp, refs, want_probs[:1], reqs, card,
                                       time.perf_counter() - pp_s)}


# phase 14: the parallel axes, part two, on phase 13's two ranks. Tensor
# parallelism: a ("dp", "mp") mesh of dp=1 and mp=2, every attention on
# half its heads (6 of 12, 8 of 16) and every MLP on half its intermediate
# (1536 of 3072, 2048 of 4096), between "copy to mp" and "reduce from mp"
# (parallel/mesh.py), each reduction of a CUDA tensor staged through pinned
# host memory as phase 13's are. Expert parallelism: TAVMoE's experts cut
# over the dp axis of a dp=2 mesh (MoESpec.ep_axis="dp"), its dispatch
# buffers exchanged by two all_to_all per MoE block.
P14_MP = 2
P14_EP_BATCH = 4            # the global batch of the ep step (2 rows a rank)
P14_MOE_SEED = P13_SEED + 1
# the tp ranks' kernels: the four towers' attention on their local heads
# and MLPs on their local intermediate, at one step's launches
P14_ATTENTION = tuple(
    (name, s, h // P14_MP, n) for (name, _, s, h, _), n in zip(
        SERVED, (e.layers for e in (
            _p13_spec().text.encoder, _p13_spec().audio.encoder,
            _p13_spec().video.encoder, _p13_spec().fusion))))


class _Collectives:
    """The enclosed calls of one ``AxisGroup`` method, timed: per call
    its ms (synchronised before and after) and its tensor's (or tensor
    list's) bytes."""

    def __init__(self, method: str):
        from mme_tpu_torch.parallel.mesh import AxisGroup
        self.cls, self.method = AxisGroup, method
        self.plain = getattr(AxisGroup, method)
        self.ms, self.bytes = [], []

    def __enter__(self):
        plain, ms, nbytes = self.plain, self.ms, self.bytes

        def timed(axis, t, *args, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = plain(axis, t, *args, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - start) * 1e3)
            nbytes.append(sum(x.numel() * x.element_size() for x in (
                t if isinstance(t, (list, tuple)) else [t])))
            return out

        setattr(self.cls, self.method, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.plain)

    def clear(self) -> None:
        self.ms.clear()
        self.bytes.clear()


def _tp_shapes(model) -> dict:
    """What a tp rank's kernels see: (local, whole) heads of every
    attention and (hidden, local intermediate) of every MLP."""
    from mme_tpu_torch.models.layers import Mlp, MultiHeadAttention
    mods = list(model.modules())
    return {"heads": sorted({(m.qkv.weight.shape[0] // (3 * m.head_dim),
                              m.heads) for m in mods
                             if isinstance(m, MultiHeadAttention)}),
            "mlp": sorted({tuple(m.fc1.weight.shape[::-1]) for m in mods
                           if isinstance(m, Mlp)})}


def _whole_grads(model, grads: dict) -> dict:
    """The handed gradients with every cut leaf's blocks gathered (a
    collective: every rank calls, in parameter order)."""
    from mme_tpu_torch.parallel.sharding_rules import full_tensor, shard_of
    params = dict(model.named_parameters())
    return {n: full_tensor(g, shard_of(params[n])) for n, g in grads.items()}


def p14_tp_fp32(ref: dict, reqs: list) -> dict:
    """A rank of fp32 tp=2: phase 13's weights cut by
    ``build_tav(mesh=...)``; ``reqs`` served by ``Predictor(mesh=...)``
    (every row on each rank, the heads and MLPs halved), then one step on
    the whole global batch of 4: the loss, grad norm and every gathered
    gradient leaf the optimizer is handed against the single-rank
    step's."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import make_mesh
    from mme_tpu_torch.parallel.sharding_rules import shard_of
    _rank_setup()
    t0 = time.perf_counter()
    spec = _p13_spec()
    mesh = make_mesh(1, P14_MP)
    cfg = ExperimentConfig(batch_size=P13_FP32_BATCH,
                           learning_rate=P13_LR, text_max_len=70,
                           audio_max_samples=96000)
    model, state, step, _ = build_tav(spec, cfg, 1000,
                                      params=_p13_params(ref["weights"]),
                                      remat=False, use_accum=False,
                                      device="cuda", mesh=mesh)
    kernels.reset_launches()
    probs = [Predictor(model, batch_size=8, device="cuda",
                       mesh=mesh)(r)[1] for r in reqs]
    serve_launches = dict(kernels.LAUNCHES)
    batch, labels, mask, cw = train_inputs(spec, P13_FP32_BATCH,
                                           P13_SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    grads: dict = {}
    with _handed_grads(model, grads):
        _, loss, cm, norm = step(state, batch, labels, mask, cw, 1.0, True,
                                 SEED)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    whole = _whole_grads(model, grads)
    want = torch.load(ref["path"], map_location="cuda", weights_only=True)
    worst, worst_name = _worst_grad_share(
        (n, whole[n], w) for n, w in want.items())
    mp = mesh.axis("mp")
    out = {"rank": distributed.rank(), "mp_index": mp.index,
           "transport": mp.transport(state.params[0]),
           "cut_leaves": sum(shard_of(p) is not None for p in state.params),
           "leaves": len(state.params), **_tp_shapes(model),
           "probs": probs, "serve_launches": serve_launches,
           "loss": loss.item(), "grad_norm": float(norm),
           "cm_sum": int(cm.sum()), "same_leaves": set(whole) == set(want),
           "worst_grad_share": worst, "worst_grad_leaf": worst_name,
           "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    del model, state, step, want, grads, whole
    _free()
    return out


def p14_tp_bf16(weights: str, steps: int, warmup: int) -> dict:
    """A rank of the bf16 mp=2 steps at the global batch of 8 (every row
    on each rank) with every knob on: ms per step, the mp reductions' count,
    bytes, ms and share of the last step, one step's launches, this rank's
    peak memory and the element counts of the leaves K3 updates."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import make_mesh
    _rank_setup()
    t0 = time.perf_counter()
    spec = _p13_spec(torch.bfloat16, quiet=False)
    mesh = make_mesh(1, P14_MP)
    os.environ.update(P13_BF16_ENV)
    try:
        cfg = ExperimentConfig(batch_size=P13_BF16_BATCH,
                               learning_rate=5e-6, text_max_len=70,
                               audio_max_samples=96000)
        model, state, step, _ = build_tav(
            spec, cfg, 1000, params=_p13_params(weights), remat=False,
            use_accum=False, device="cuda", mesh=mesh)
        batch, labels, mask, cw = train_inputs(spec, P13_BF16_BATCH,
                                               P13_SEED + 2)
        batch = to_device(batch, "cuda")
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        with _Collectives("all_reduce") as reduce:
            for i in range(warmup + steps):
                reduce.clear()
                kernels.reset_launches()
                fused = adam_update.LEAVES_FUSED
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, loss, _, _ = step(state, batch, labels, mask, cw, 1.0,
                                     True, SEED + i)
                torch.cuda.synchronize()
                if i >= warmup:
                    ms.append((time.perf_counter() - t) * 1e3)
                    losses.append(loss.item())
            reduce_ms, reduce_bytes = list(reduce.ms), list(reduce.bytes)
        launches = dict(kernels.LAUNCHES)
        leaves_fused = adam_update.LEAVES_FUSED - fused
        n_ln = sum(fused_ln_shapes(spec, P13_BF16_BATCH).values())
        peak = torch.cuda.max_memory_allocated() / 1e9
        k3_sizes = [m.numel() for m in state.opt_state.mu if m is not None]
    finally:
        for k in P13_BF16_ENV:
            del os.environ[k]
    big = [(m, b) for m, b in zip(reduce_ms, reduce_bytes) if b > 1 << 20]
    out = {"rank": distributed.rank(), "ms_per_step": ms, "losses": losses,
           "reductions_last": len(reduce_ms),
           "activation_reductions_last": len(big),
           "reduce_ms_last": sum(reduce_ms),
           "reduce_gb_last": sum(reduce_bytes) / 1e9,
           "reduce_share_last": sum(reduce_ms) / ms[-1],
           "launches": launches, "leaves_fused": leaves_fused,
           "expected_layer_norm": n_ln, "peak_gb": peak,
           "k3_sizes": k3_sizes, **_tp_shapes(model),
           "seconds": time.perf_counter() - t0}
    del model, state, step
    _free()
    return out


def _moe_model(spec: TAVSpec, params: dict, mesh=None):
    """Full-width TAVMoE on the card from ``params``; with a mesh its
    experts are cut over the mesh's dp axis."""
    from mme_tpu_torch.models.moe import MoESpec
    from mme_tpu_torch.parallel.sharding_rules import shard_model
    moe = (MoESpec() if mesh is None
           else MoESpec(ep_axis="dp", ep_mesh=mesh))
    model = TAVMoEFormer(spec, moe=moe, device="cuda")
    model.load_state_dict(from_flax(params), strict=True)
    if mesh is not None:
        shard_model(model, mesh)
    return model


def _moe_step(model, mesh=None):
    tx = make_optimizer(lambda s: P13_LR, 1e-4, 1.0)
    state = TrainState.create(model.parameters(), tx, use_accum=False)
    return state, make_train_step(model, tx, num_classes=7,
                                  has_aux_loss=True, mesh=mesh)


def p14_ep(weights: str, ref: dict, reqs: list) -> dict:
    """A rank of TAVMoE at ep=2 over dp=2: the served requests (each rank
    4 rows of a chunk), then the fp32 step on this rank's 2 rows of the
    global batch of 4 (loss, grad norm, every gathered gradient leaf
    against the single-rank step), then a second step with its
    all_to_all timed."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from mme_tpu_torch.parallel.sharding_rules import shard_of
    _rank_setup()
    t0 = time.perf_counter()
    spec = _p13_spec()
    mesh = make_mesh(P13_WORLD, 1)
    model = _moe_model(spec, _p13_params(weights), mesh)
    pred = Predictor(model, batch_size=8, device="cuda", mesh=mesh)
    kernels.reset_launches()
    probs = [pred(r)[1] for r in reqs]
    serve_launches = dict(kernels.LAUNCHES)
    state, step = _moe_step(model, mesh)
    batch, labels, mask, cw = train_inputs(spec, P14_EP_BATCH,
                                           P14_MOE_SEED + 1)
    local = shard_batch({**batch, "_labels": labels, "_mask": mask}, mesh)
    labels, mask = local.pop("_labels"), local.pop("_mask")
    local = to_device(local, "cuda")
    kernels.reset_launches()
    grads: dict = {}
    with _handed_grads(model, grads):
        _, loss, cm, norm = step(state, local, labels, mask, cw, 1.0, True,
                                 SEED)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    whole = _whole_grads(model, grads)
    want = torch.load(ref["path"], map_location="cuda", weights_only=True)
    worst, worst_name = _worst_grad_share(
        (n, whole[n], w) for n, w in want.items())
    del whole, want, grads
    with _Collectives("all_to_all") as a2a:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, local, labels, mask, cw, 1.0, True, SEED + 1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
    out = {"rank": distributed.rank(),
           "cut_leaves": sum(shard_of(p) is not None for p in state.params),
           "probs": probs, "serve_launches": serve_launches,
           "loss": loss.item(), "grad_norm": float(norm),
           "cm_sum": int(cm.sum()), "worst_grad_share": worst,
           "worst_grad_leaf": worst_name, "launches": launches,
           "step_ms": step_ms, "all_to_all_calls": len(a2a.ms),
           "all_to_all_ms": sum(a2a.ms),
           "all_to_all_gb": sum(a2a.bytes) / 1e9,
           "all_to_all_share": sum(a2a.ms) / step_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    del model, state, step, pred
    _free()
    return out


def moe_reference(spec: TAVSpec, directory: str, reqs: list) -> dict:
    """Phase 14's single-rank TAVMoE on this process: its weights (saved
    for the ranks), the fp32 ``Predictor`` probabilities on phase 4's
    requests and the fp32 step's loss, grad norm and handed gradients."""
    params = init_params(spec, P14_MOE_SEED, model="TAVMoE")
    weights = os.path.join(directory, "moe_weights.pt")
    _save_tree(params, weights)
    model = _moe_model(spec, params)
    del params
    probs = [Predictor(model, batch_size=8, device="cuda")(r)[1]
             for r in reqs]
    state, step = _moe_step(model)
    batch, labels, mask, cw = train_inputs(spec, P14_EP_BATCH,
                                           P14_MOE_SEED + 1)
    grads: dict = {}
    with _handed_grads(model, grads):
        _, loss, _, norm = step(state, batch, labels, mask, cw, 1.0, True,
                                SEED)
    ref = {"path": os.path.join(directory, "moe_ref.pt"),
           "weights": weights, "loss": loss.item(), "grad_norm": float(norm),
           "probs": probs}
    torch.save({n: g.cpu() for n, g in grads.items()}, ref["path"])
    del model, state, step, grads
    _free()
    return ref


def tp_kernel_shapes(spec: TAVSpec, k3_sizes: list, card: str) -> dict:
    """Phase 14 (5), on this process: K1/K2 at every local-heads shape the
    tp ranks fed (the fp32 step's batch of 4, the served and bf16 chunks
    of 8) and K5a/K5b at every local MLP slice, in both types, against
    their plain versions; at batch 8 in bf16 each timed beside its plain
    version and the library call with its bound and its launches per
    step; K3 over the shards' leaves against its plain version, timed."""
    attention, mlp = [], []
    for i, (name, s, h, n) in enumerate(P14_ATTENTION):
        masked = name != "video"
        for b, dt in ((P13_FP32_BATCH, torch.float32),
                      (8, torch.float32), (8, torch.bfloat16)):
            case = (f"tp_{name}", b, s, s, h, 64, dt, int(masked), masked)
            flash_fwd_hold(*case, seed=5000 + i)
            flash_bwd_hold(*case, False, seed=5000 + i)
        attention.append({"tower": name, "launches_per_step": n,
                          **flash_times(8, s, h, masked)})
    for i, (name, n, h, f, layers) in enumerate(mlp_shapes(spec, 8)):
        local = f // P14_MP
        # K5 runs in the bf16 step only (the fp32 legs keep the knobs off)
        mlp_hold(f"tp_{name}", n, h, local, torch.bfloat16, "gelu", 5100 + i)
        mlp.append(mlp_times(name, n, h, local, layers, 5200 + i))
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    bc1, bc2 = 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    gs, mus, nus = time_adam.leaf_state(k3_sizes, 2)
    seeds = [(14 << 20) + k for k in range(len(k3_sizes))]
    before = kernels.LAUNCHES["adam_update"]
    got = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    torch.cuda.synchronize()
    launched = kernels.LAUNCHES["adam_update"] - before
    want = adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds, **kw)
    same, n_ulp = adam_same_bits(got, want)
    k3_err = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(got[0], want[0]))
    del got, want
    _, _, bound, by = adam_update.bounds(k3_sizes)
    adam = {"leaves": len(k3_sizes), "elements": sum(k3_sizes),
            "launches": launched, "moments_equal_plain": same,
            "out_ulps": n_ulp, "max_abs_err": k3_err,
            # in place, as the optimizer calls it
            "ms": cuda_ms(lambda: adam_update_leaves(
                gs, mus, nus, bc1, bc2, seeds, outs=gs, mu_outs=mus,
                nu_outs=nus, **kw), iters=5),
            "plain_ms": cuda_ms(lambda: adam_update_leaves_plain(
                gs, mus, nus, bc1, bc2, seeds, **kw), iters=1, warmup=1),
            "bound_ms": bound, "bound_by": by}
    del gs, mus, nus
    _free()
    out = {"attention": attention, "mlp": mlp, "adam_update": adam}
    print(json.dumps({"tp_kernel_shapes": out, "card": card}), flush=True)
    if not (same and n_ulp <= ADAM_OUT_ULPS and launched == 1):
        raise SystemExit("phase 14: K3 over the tp shards disagrees with "
                         "its plain version")
    return out


def parallel_axes_two(pool, ref: dict, weights: str, reqs: list,
                      want_probs: list, directory: str) -> dict:
    """Phase 14's calls on phase 13's pool: tp fp32, tp bf16, tp serving,
    then the TAVMoE reference on this process and ep on the ranks."""
    here = os.path.abspath(__file__)
    t = time.perf_counter()
    tp = pool.run(f"{here}:p14_tp_fp32", ref, reqs[:1])
    bf16 = pool.run(f"{here}:p14_tp_bf16", weights, 1, 0)
    tp_s = time.perf_counter() - t
    t = time.perf_counter()
    moe_ref = moe_reference(_p13_spec(), directory, reqs[:1])
    moe_ref_s = time.perf_counter() - t
    t = time.perf_counter()
    ep = pool.run(f"{here}:p14_ep", moe_ref["weights"], moe_ref, reqs[:1])
    return {"tp": tp, "bf16": bf16, "ep": ep,
            "moe_ref": moe_ref, "want_probs": want_probs[:1],
            "tp_ranks_s": tp_s,
            "moe_reference_s": moe_ref_s,
            "ep_ranks_s": time.perf_counter() - t}


def parallel_axes_two_checks(res: dict, ref: dict, reqs: list,
                             spec: TAVSpec, card: str, t0: float) -> dict:
    """Phase 14 on this process after the ranks: the kernels at the tp
    ranks' shapes, then every check. Returns one step's launches of the
    bf16 tp leg and of the ep leg, for the kernels line."""
    tp, bf16, ep = res["tp"], res["bf16"], res["ep"]
    moe_ref = res["moe_ref"]
    t = time.perf_counter()
    shapes = tp_kernel_shapes(spec, bf16[0]["k3_sizes"], card)
    shapes_s = time.perf_counter() - t
    want_heads = sorted({(h // P14_MP, h) for _, _, _, h, _ in SERVED})
    want_mlp = sorted({(h, f // P14_MP) for _, _, h, f, _ in
                       mlp_shapes(spec, 8)})
    tp_diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for r in tp for a, b in zip(r["probs"],
                                              res["want_probs"]))
    ep_diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for r in ep for a, b in zip(r["probs"], moe_ref["probs"]))
    chunks = -(-len(reqs[0]["input_ids"]) // 8)
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for r in bf16:
        r.pop("k3_sizes")
    out = {"tp_fp32": [{k: v for k, v in r.items() if k != "probs"}
                       for r in tp], "tp_bf16": bf16,
           "tp_served_prob_max_diff": tp_diff,
           "ep": [{k: v for k, v in r.items() if k != "probs"} for r in ep],
           "ep_served_prob_max_diff": ep_diff,
           "ep_reference": {k: moe_ref[k] for k in ("loss", "grad_norm")},
           "reference": {k: ref[k] for k in ("loss", "grad_norm")},
           "tp_ranks_s": res["tp_ranks_s"],
           "moe_reference_s": res["moe_reference_s"],
           "ep_ranks_s": res["ep_ranks_s"], "kernel_shapes_s": shapes_s,
           "phase_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"parallel_axes_two": out}), flush=True)
    n_ln = bf16[0]["expected_layer_norm"]
    layers = tav_layers(spec)
    checks = {
        "tp_fp32": all(
            abs(r["loss"] - ref["loss"]) <= TRAIN_LOSS_RTOL * abs(ref["loss"])
            and abs(r["grad_norm"] - ref["grad_norm"])
            <= TRAIN_NORM_RTOL * ref["grad_norm"]
            and r["same_leaves"] and r["worst_grad_share"] <= P13_GRAD_RTOL
            and r["cm_sum"] == P13_FP32_BATCH and r["cut_leaves"] > 0
            and r["heads"] == want_heads and r["mlp"] == want_mlp
            and r["launches"]["flash_fwd"] == r["launches"]["flash_bwd"]
            == layers and r["transport"] == "gloo-host"
            for r in tp),
        "tp_bf16": all(
            all(np.isfinite(r["losses"]))
            and r["launches"]["flash_fwd"] == r["launches"]["flash_bwd"]
            == r["launches"]["fused_mlp_fwd"]
            == r["launches"]["fused_mlp_bwd"] == layers
            and r["launches"]["layer_norm_fwd"]
            == r["launches"]["layer_norm_bwd"] == n_ln
            and r["launches"]["adam_update"] == 1
            and r["heads"] == want_heads and r["mlp"] == want_mlp
            for r in bf16)
        and sum(r["peak_gb"] for r in bf16) < total_gb,
        "tp_serve": tp_diff <= SERVE_TOL[torch.float32] and all(
            r["serve_launches"]["flash_fwd"] == chunks * layers
            for r in tp),
        "ep": all(
            abs(r["loss"] - moe_ref["loss"])
            <= TRAIN_LOSS_RTOL * abs(moe_ref["loss"])
            and abs(r["grad_norm"] - moe_ref["grad_norm"])
            <= TRAIN_NORM_RTOL * moe_ref["grad_norm"]
            and r["worst_grad_share"] <= P13_GRAD_RTOL
            and r["cut_leaves"] > 0 and r["cm_sum"] == P14_EP_BATCH
            and r["all_to_all_calls"] > 0
            and r["launches"]["flash_fwd"] == r["launches"]["flash_bwd"]
            == spec.fusion.layers
            and r["serve_launches"]["flash_fwd"] == chunks
            * spec.fusion.layers for r in ep)
        and ep_diff <= SERVE_TOL[torch.float32]}
    if not all(checks.values()):
        raise SystemExit(f"phase 14 (the parallel axes, part two) failed: "
                         f"{checks}")
    return {"tp": bf16[0]["launches"], "ep": ep[0]["launches"],
            "shapes": shapes, "phase_s": time.perf_counter() - t0}


# phase 15: pipeline parallelism on phase 13's two ranks. A ("dp", "pp")
# mesh of dp=1 and pp=2: every rank holds the whole model; the chosen
# tower's L layers run as a GPipe pipeline, stage s the layers s·L/2 …
# (s + 1)·L/2 - 1,
# microbatch by microbatch (parallel/pipeline.py); activations go to the
# next stage and their gradients back, the last stage's output and stage
# 0's input gradient are broadcast, each staged through pinned host memory
# as phase 13's collectives are
P15_PP = 2
P15_SEED = P13_SEED + 150
# (tower, global batch, microbatches) of the fp32 holds: the fusion trunk
# against phase 13's single-rank step at 4, the video tower (the K1/K2
# that cost the most) against a single-rank step at 2
P15_FP32 = (("fusion", P13_FP32_BATCH, 2), ("video", 2, 2))
P15_BF16_MICRO = 4
# (name, microbatch rows, seq, heads, key mask) of the K1/K2 calls a stage
# makes: the bf16 step's fusion microbatch (8 / 4) and the fp32 video
# leg's (2 / 2)
P15_ATTENTION = (("pp_fusion", P13_BF16_BATCH // P15_BF16_MICRO, 473, 12,
                  True),
                 ("pp_video", 1, 1464, 12, False))


def _pp_spec(tower: str, micro: int, batch: int, dtype=torch.float32,
             quiet: bool = True):
    """(spec, mesh) of ``tav_nn.parallel_spec`` with ``MME_PP=2`` on
    ``tower`` and ``micro`` microbatches, over phase 13's tree."""
    env = {"MME_PP": str(P15_PP), "MME_PP_TOWER": tower,
           "MME_PP_MICRO": str(micro)}
    with environ(env):
        return tav_nn.parallel_spec(ExperimentConfig(batch_size=batch),
                                    _p13_spec(dtype, quiet))


def pp_expected(spec: TAVSpec, batch: int, micro: int) -> dict:
    """One pp=2 step's launches on a rank, from the spec: the towers every
    rank runs whole, and the trunk's own stage once per microbatch (its
    LayerNorms on a microbatch's rows, under K4's row gate at M=4)."""
    f = spec.fusion
    k = f.layers // P15_PP
    attn = (spec.text.encoder.layers + spec.audio.encoder.layers
            + spec.video.encoder.layers + k * micro)
    rows = batch // micro * (70 + audio_frames(spec, 96000)
                             + spec.video_keep_k)
    outside = ln_sites(dataclasses.replace(
        spec, fusion=dataclasses.replace(f, layers=0)), batch)
    n_ln = sum(fused_ln_sites(outside + [(rows, f.hidden)] * (2 * k * micro))
               .values())
    return {"flash_fwd": attn, "flash_bwd": attn, "fused_mlp_fwd": attn,
            "fused_mlp_bwd": attn, "layer_norm_fwd": n_ln,
            "layer_norm_bwd": n_ln, "adam_update": 1}


def p15_pp_fp32(tower: str, batch: int, micro: int, ref: dict,
                reqs: list) -> dict:
    """A rank of the fp32 pp=2 step on ``tower`` through the CLI's
    ``parallel_spec`` and ``build_tav(mesh=...)``: ``reqs`` served across
    the mesh first (the step then moves the weights), then one step on the
    global batch (every rank the whole batch): loss, grad norm and every
    gradient leaf the optimizer is handed against the single-rank step's
    at ``ref["path"]``."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.sharding_rules import stage_of
    _rank_setup()
    t0 = time.perf_counter()
    spec, mesh = _pp_spec(tower, micro, batch)
    cfg = ExperimentConfig(batch_size=batch, learning_rate=P13_LR,
                           text_max_len=70, audio_max_samples=96000)
    model, state, step, _ = build_tav(spec, cfg, 1000,
                                      params=_p13_params(ref["weights"]),
                                      remat=False, use_accum=False,
                                      device="cuda", mesh=mesh)
    kernels.reset_launches()
    probs = [Predictor(model, batch_size=8, device="cuda",
                       mesh=mesh)(r)[1] for r in reqs]
    serve_launches = dict(kernels.LAUNCHES)
    inputs, labels, mask, cw = train_inputs(spec, batch, ref["seed"])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    grads: dict = {}
    with _handed_grads(model, grads):
        _, loss, cm, norm = step(state, inputs, labels, mask, cw, 1.0, True,
                                 SEED)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = torch.load(ref["path"], map_location="cuda", weights_only=True)
    worst, worst_name = _worst_grad_share(
        (n, grads[n], w) for n, w in want.items())
    pp = mesh.axis("pp")
    out = {"rank": distributed.rank(), "tower": tower, "batch": batch,
           "micro": micro, "stage": pp.index,
           "transport": pp.transport(state.params[0]),
           "stage_leaves": sum(stage_of(p) is not None
                               for p in state.params),
           "probs": probs, "serve_launches": serve_launches,
           "loss": loss.item(), "grad_norm": float(norm),
           "cm_sum": int(cm.sum()), "same_leaves": set(grads) == set(want),
           "worst_grad_share": worst, "worst_grad_leaf": worst_name,
           "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    del model, state, step, want, grads
    _free()
    return out


class _Waits:
    """``Transfer.wait`` of the enclosed calls, timed (synchronised before
    and after): per call its ms and its message's bytes."""

    def __init__(self):
        from mme_tpu_torch.parallel.mesh import Transfer
        self.cls, self.plain = Transfer, Transfer.wait
        self.ms, self.bytes = [], []

    def __enter__(self):
        plain, ms, nbytes = self.plain, self.ms, self.bytes

        def timed(transfer):
            n = transfer.buf.numel() * transfer.buf.element_size()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = plain(transfer)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - start) * 1e3)
            nbytes.append(n)
            return out

        self.cls.wait = timed
        return self

    def __exit__(self, *exc):
        self.cls.wait = self.plain

    def clear(self) -> None:
        self.ms.clear()
        self.bytes.clear()


def p15_pp_bf16(weights: str, steps: int, warmup: int) -> dict:
    """A rank of the bf16 pp=2 steps on the fusion trunk at the global
    batch of 8, M=4, every knob on: ms per step, the point-to-point
    traffic of the last step (the stage sends' staging, the waits for the
    messages, the output's and input gradient's broadcasts: count, ms, GB,
    share), the gradient sync's ms and share, one step's launches and this
    rank's peak."""
    from mme_tpu_torch.parallel import distributed
    _rank_setup()
    t0 = time.perf_counter()
    spec, mesh = _pp_spec("fusion", P15_BF16_MICRO, P13_BF16_BATCH,
                          torch.bfloat16, quiet=False)
    os.environ.update(P13_BF16_ENV)
    try:
        cfg = ExperimentConfig(batch_size=P13_BF16_BATCH,
                               learning_rate=5e-6, text_max_len=70,
                               audio_max_samples=96000)
        model, state, step, _ = build_tav(
            spec, cfg, 1000, params=_p13_params(weights), remat=False,
            use_accum=False, device="cuda", mesh=mesh)
        inputs, labels, mask, cw = train_inputs(spec, P13_BF16_BATCH,
                                                P13_SEED + 2)
        inputs = to_device(inputs, "cuda")
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        with _Collectives("send_start") as sends, \
                _Collectives("broadcast_") as casts, _Waits() as waits, \
                _Collectives("all_reduce_many") as sync:
            for i in range(warmup + steps):
                for c in (sends, casts, waits, sync):
                    c.clear()
                kernels.reset_launches()
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, loss, _, _ = step(state, inputs, labels, mask, cw, 1.0,
                                     True, SEED + i)
                torch.cuda.synchronize()
                if i >= warmup:
                    ms.append((time.perf_counter() - t) * 1e3)
                    losses.append(loss.item())
            p2p = {name: {"calls": len(c.ms), "ms": sum(c.ms),
                          "gb": sum(c.bytes) / 1e9}
                   for name, c in (("send_staging", sends),
                                   ("wait", waits), ("broadcast", casts))}
            sync_ms = sum(sync.ms)
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for k in P13_BF16_ENV:
            del os.environ[k]
    p2p_ms = sum(v["ms"] for v in p2p.values())
    out = {"rank": distributed.rank(), "stage": mesh.axis("pp").index,
           "ms_per_step": ms, "losses": losses, "p2p_last": p2p,
           "p2p_ms_last": p2p_ms, "p2p_share_last": p2p_ms / ms[-1],
           "grad_sync_ms_last": sync_ms,
           "grad_sync_share_last": sync_ms / ms[-1],
           "launches": launches, "peak_gb": peak,
           "seconds": time.perf_counter() - t0}
    del model, state, step
    _free()
    return out


def pp_kernel_shapes(card: str) -> list:
    """Phase 15 (4), on this process: K1/K2 at the stages' microbatch
    shapes in fp32 and bf16 against their plain versions, then each timed
    in bf16 beside its plain version and SDPA, with its bound."""
    rows = []
    for i, (name, b, s, h, masked) in enumerate(P15_ATTENTION):
        for dt in (torch.float32, torch.bfloat16):
            case = (name, b, s, s, h, 64, dt, int(masked), masked)
            flash_fwd_hold(*case, seed=6000 + i)
            flash_bwd_hold(*case, False, seed=6000 + i)
        rows.append({"shape": name, **flash_times(b, s, h, masked)})
    print(json.dumps({"pp_kernel_shapes": rows, "card": card}), flush=True)
    return rows


def pipeline_axis(pool, ref: dict, ref_video: dict, weights: str,
                  reqs: list) -> dict:
    """Phase 15's calls on phase 13's pool."""
    here = os.path.abspath(__file__)
    t = time.perf_counter()
    fp32 = {}
    for (tower, batch, micro), r in zip(P15_FP32, (ref, ref_video)):
        fp32[tower] = pool.run(f"{here}:p15_pp_fp32", tower, batch, micro,
                               r, reqs[:1] if tower == "fusion" else [])
    fp32_s = time.perf_counter() - t
    t = time.perf_counter()
    bf16 = pool.run(f"{here}:p15_pp_bf16", weights, 1, 1)
    return {"fp32": fp32, "bf16": bf16, "fp32_ranks_s": fp32_s,
            "bf16_ranks_s": time.perf_counter() - t}


def pipeline_axis_checks(res: dict, refs: dict, want_probs: list,
                         reqs: list, card: str, t0: float) -> dict:
    """Phase 15 on this process after the ranks: K1/K2 at the microbatch
    shapes, then every check. Returns one bf16 step's launches of rank 0,
    for the kernels line."""
    t = time.perf_counter()
    shapes = pp_kernel_shapes(card)
    shapes_s = time.perf_counter() - t
    fp32, bf16 = res["fp32"], res["bf16"]
    spec = _p13_spec(torch.bfloat16, quiet=False)
    expected = pp_expected(spec, P13_BF16_BATCH, P15_BF16_MICRO)
    chunks = -(-len(reqs[0]["input_ids"]) // 8)
    served = fp32["fusion"]
    served_diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                      for r in served for a, b in zip(r["probs"],
                                                      want_probs))
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    bubble = (P15_PP - 1) / (P15_BF16_MICRO + P15_PP - 1)
    out = {"fp32": {tw: [{k: v for k, v in r.items() if k != "probs"}
                         for r in rs] for tw, rs in fp32.items()},
           "references": {tw: {k: refs[tw][k] for k in ("loss", "grad_norm")}
                          for tw in refs},
           "served_prob_max_diff": served_diff, "bf16": bf16,
           "bf16_expected_launches": expected, "bubble_fraction": bubble,
           "fp32_ranks_s": res["fp32_ranks_s"],
           "bf16_ranks_s": res["bf16_ranks_s"], "kernel_shapes_s": shapes_s,
           "phase_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"pipeline_axis": out}), flush=True)
    fp32_spec = _p13_spec()

    def f32_layers(tower, micro):
        """K1 (K2) a rank launches in an fp32 step or chunk: the layers it
        runs whole and its stage's share of ``tower``'s, once a
        microbatch."""
        piped = (fp32_spec.fusion.layers if tower == "fusion"
                 else getattr(fp32_spec, tower).encoder.layers)
        return (tav_layers(fp32_spec) - piped
                + piped // P15_PP * micro)

    micros = {tw: micro for tw, _, micro in P15_FP32}
    checks = {
        tw: all(
            abs(r["loss"] - refs[tw]["loss"])
            <= TRAIN_LOSS_RTOL * abs(refs[tw]["loss"])
            and abs(r["grad_norm"] - refs[tw]["grad_norm"])
            <= TRAIN_NORM_RTOL * refs[tw]["grad_norm"]
            and r["same_leaves"] and r["worst_grad_share"] <= P13_GRAD_RTOL
            and r["cm_sum"] == r["batch"] and r["stage_leaves"] > 0
            and r["launches"]["flash_fwd"] == r["launches"]["flash_bwd"]
            == f32_layers(tw, micros[tw]) and r["transport"] == "gloo-host"
            for r in rs) and sorted(r["stage"] for r in rs) == [0, 1]
        for tw, rs in fp32.items()}
    checks["serve"] = served_diff <= SERVE_TOL[torch.float32] and all(
        r["serve_launches"]["flash_fwd"]
        == chunks * f32_layers("fusion", micros["fusion"]) for r in served)
    checks["bf16"] = all(
        all(np.isfinite(r["losses"]))
        and all(r["launches"][k] == v for k, v in expected.items())
        for r in bf16) and sum(r["peak_gb"] for r in bf16) < total_gb
    if not all(checks.values()):
        raise SystemExit(f"phase 15 (pipeline parallelism) failed: {checks}")
    return {"pp": bf16[0]["launches"], "shapes": shapes,
            "phase_s": time.perf_counter() - t0}


# phase 16: the sweeps, the forced alignment and the two timing tools on
# the card. The sweep's data: MELD-like utterances (a few words and one of
# MELD's emotions) as a mapping pickle of columns (the card's machine has
# no pandas), 64 train / 16 validation / 16 test rows; its YAML:
# configs/bert.yaml's space with one epoch of batch 8 and the metric
# val/loss (the summary's test/loss, as in JAX); six trials in process, the
# sixth a TPE proposal (sweep.TPE_STARTUP = 5), with bf16 moments and K3
# (text_nn, as JAX's, reads no MME_DTYPE: the trials compute in fp32, K1/K2
# in fp32 at [8, 70, 12 heads], which phase 3 holds), then two workers of
# one trial each sharing the card
P16_SPLITS = (("train", 64), ("val", 16), ("test", 16))
P16_TRIALS = 6
P16_SWEEP_SEED = 0
P16_ENV = {"MME_DTYPE": "bf16", "MME_OPT_STATE": "bf16",
           "MME_FUSED_ADAM": "1"}
# trial 6's peak memory against trial 1's: a trial that did not free the
# one before it would double it
P16_PEAK_SHARE = 0.05
# the workers' agent: its limit (two cold processes and a trial each)
P16_AGENT_TIMEOUT_S = 300
P16_WORDS = ("oh", "my", "god", "you", "know", "what", "i", "mean", "okay",
             "no", "way", "that", "is", "great", "sorry", "really", "wait",
             "hey", "ross", "rachel", "joey", "monica", "chandler", "phoebe",
             "coffee", "apartment", "tonight", "believe", "this", "happened")
# the alignment: 8 rows of 300 frames (6 s at 16 kHz, 320 samples a frame),
# a transcript of 3 to 5 letters planted over spans of 4 to 8 frames; the
# last row has no emission file (timings None)
P16_ALIGN_ROWS, P16_FRAMES, P16_ALIGN_SEED = 8, 300, SEED + 160
P16_LETTERS = "abcdefghijklmnopqrstuvwxyz"
# profile_towers: windows and steps of its timings
P16_PROF_ENV = {"PROF_STEPS": "3", "PROF_WINDOWS": "1",
                "MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1"}


def sweep_data(directory: str) -> str:
    """The sweep's records as a pickled mapping of columns."""
    rng = np.random.RandomState(SEED + 161)
    n = sum(k for _, k in P16_SPLITS)
    emotions = [MELD[i % len(MELD)] for i in range(n)]
    rng.shuffle(emotions)
    table = {
        "text": np.array([" ".join(rng.choice(P16_WORDS, rng.randint(3, 15)))
                          for _ in range(n)]),
        "emotion": np.array(emotions),
        "split": np.array([s for s, k in P16_SPLITS for _ in range(k)]),
    }
    path = os.path.join(directory, "meld_like.pkl")
    with open(path, "wb") as f:
        pickle.dump(table, f)
    return path


def sweep_yaml(directory: str) -> str:
    """configs/bert.yaml with one epoch of batch 8 and the metric
    val/loss."""
    from mme_tpu_torch.sweep import SweepConfig
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "bert.yaml")) as f:
        text = f.read()
    for old, new in (("epoch:\n    values: [6]", "epoch:\n    values: [1]"),
                     ("batch_size:\n    values: [1]",
                      "batch_size:\n    values: [8]"),
                     ("name: train/train_loss", "name: val/loss")):
        assert old in text, old
        text = text.replace(old, new)
    path = os.path.join(directory, "bert_sweep.yaml")
    with open(path, "w") as f:
        f.write(text)
    cfg = SweepConfig.from_yaml(path)
    assert (cfg.parameters["epoch"]["values"], cfg.metric_name,
            cfg.parameters["batch_size"]["values"]) == ([1], "val/loss", [8])
    return path


def replayed_trials(cfg, results: list) -> list:
    """Each trial's parameters as the sweep's numpy draws give them, from
    the trials before it: the random sequence for the first TPE_STARTUP,
    then ``tpe_propose`` on the recorded history."""
    from mme_tpu_torch.sweep import (TPE_STARTUP, TrialResult, iter_trials,
                                     tpe_propose)
    out, history = [], []
    for i, rec in enumerate(results):
        if i < TPE_STARTUP:
            want = next(iter_trials(cfg, 1, P16_SWEEP_SEED, trial_offset=i))
        else:
            want = tpe_propose(cfg, history, np.random.RandomState(
                (P16_SWEEP_SEED * 1000003 + i) & 0x7FFFFFFF))
        out.append(json.loads(json.dumps(want)))
        history.append(TrialResult(rec["params"], rec["metrics"]))
    return out


def sweep_adam_hold(card: str) -> dict:
    """K3 over the sweep model's leaves (the full-width BertClassifier)
    against its plain version on the same inputs and Philox words."""
    net = BertClassifier(TextEncoderSpec.distilroberta(), 7, device="meta")
    sizes = [p.numel() for p in net.parameters()]
    gs, mus, nus = time_adam.leaf_state(sizes, 16)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    bc1, bc2 = 1.0 - 0.9 ** 2, 1.0 - 0.999 ** 2
    seeds = [(16 << 20) + k for k in range(len(sizes))]
    got = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    want = adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds, **kw)
    same, n_ulp = adam_same_bits(got, want)
    out = {"leaves": len(sizes), "elements": sum(sizes),
           "moments_equal_plain": same, "out_ulps": n_ulp, "card": card}
    print(json.dumps({"sweep_adam_hold": out}), flush=True)
    if not (same and n_ulp <= ADAM_OUT_ULPS):
        raise SystemExit("phase 16: adam_update disagrees with its plain "
                         "version over the sweep model's leaves")
    return out


def start_workers(yml: str, pkl: str, directory: str) -> subprocess.Popen:
    """``python -m mme_tpu_torch.cli.sweep ... --workers 2`` as a user
    starts it, in ``directory`` (each worker's checkpoints under its
    ``checkpoints/sweep_worker_<w>``, the results files under a temporary
    directory there), in a session of its own so that a failure can stop
    it with its workers; its output goes to ``agent.log``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **P16_ENV, TMPDIR=directory,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    with open(os.path.join(directory, "agent.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "mme_tpu_torch.cli.sweep", yml,
             "--trials", "2", "--workers", "2", "--seed",
             str(P16_SWEEP_SEED), "--dataset", pkl, "--device", "cuda"],
            cwd=directory, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)


def sweep_run(card: str, directory: str) -> dict:
    """Phase 16 (1): six trials in process and, started before them as a
    process of its own (the workers' cold start, ~30 s of imports, CUDA
    and kernel libraries, overlaps the trials), two workers of one trial
    each sharing the card."""
    from mme_tpu_torch.cli import sweep as sweep_cli
    from mme_tpu_torch.sweep import SweepConfig
    pkl, yml = sweep_data(directory), sweep_yaml(directory)
    cfg = SweepConfig.from_yaml(yml)
    layers = TextEncoderSpec.distilroberta().encoder.layers
    results_path = os.path.join(directory, "trials.jsonl")
    trials: list = []
    plain_main = text_nn.main

    def traced(argv, device="cuda"):
        run_dir = os.path.join(directory, f"run_{len(trials)}")
        os.environ["MME_RUN_DIR"] = run_dir
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_gb = torch.cuda.memory_allocated() / 1e9
        kernels.reset_launches()
        t = time.perf_counter()
        try:
            summary = plain_main(argv, device=device)
        finally:
            del os.environ["MME_RUN_DIR"]
        torch.cuda.synchronize()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f]
        trials.append({
            "s": time.perf_counter() - t, "start_gb": start_gb,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
            "losses": [d[k] for d in logs for k in ("train/loss", "val/loss",
                                                    "test/loss") if k in d]})
        return summary

    t0 = time.perf_counter()
    agent = start_workers(yml, pkl, directory)
    cwd = os.getcwd()
    os.chdir(directory)
    text_nn.main = traced
    try:
        with environ(P16_ENV):
            best = sweep_cli.main([yml, "--trials", str(P16_TRIALS), "--seed",
                                   str(P16_SWEEP_SEED), "--dataset", pkl,
                                   "--results", results_path],
                                  device="cuda")
        in_process_s = time.perf_counter() - t0
        agent_rc = agent.wait(timeout=P16_AGENT_TIMEOUT_S)
        workers_s = time.perf_counter() - t0
    finally:
        text_nn.main = plain_main
        os.chdir(cwd)
        if agent.poll() is None:
            os.killpg(agent.pid, signal.SIGKILL)
            agent.wait()
    _free()
    with open(os.path.join(directory, "agent.log")) as f:
        merged_line = [json.loads(line) for line in f
                       if line.startswith("{") and '"workers"' in line]
    w_best = merged_line[-1] if merged_line else {}
    with open(results_path) as f:
        results = [json.loads(line) for line in f]
    want = replayed_trials(cfg, results)
    steps = -(-P16_SPLITS[0][1] // 8)
    evals = sum(-(-k // 8) for _, k in P16_SPLITS[1:])
    expected = {"flash_fwd": layers * (steps + evals),
                "flash_bwd": layers * steps, "adam_update": steps}
    worker_files = sorted(
        glob.glob(os.path.join(directory, "mme_sweep_*", "worker_*.jsonl")))
    merged = []
    for path in worker_files:
        with open(path) as f:
            merged.append([json.loads(line)["params"] for line in f])
    worker_dirs = [os.path.join(directory, "checkpoints",
                                f"sweep_worker_{w}") for w in range(2)]
    metric = [r["metrics"]["val/loss"] for r in results]
    out = {
        "trials": [{**tr, "params": r["params"],
                    "val_loss": r["metrics"]["val/loss"]}
                   for tr, r in zip(trials, results)],
        "in_process_s": in_process_s, "workers_s": workers_s,
        "agent_rc": agent_rc,
        "expected_launches": expected,
        "replayed_equal": [a == r["params"] for a, r in zip(want, results)],
        "best_params": best.params, "best_val_loss": best.metrics["val/loss"],
        "workers_best_params": w_best.get("best_params"),
        "workers_merged": merged,
        "worker_checkpoints": [os.path.isfile(os.path.join(d,
                                                           "best_meta.json"))
                               for d in worker_dirs],
        "card": card}
    print(json.dumps({"sweep": out}), flush=True)
    peak0, peak5 = trials[0]["peak_gb"], trials[-1]["peak_gb"]
    checks = {
        "trials": len(results) == len(trials) == P16_TRIALS,
        "replay": all(out["replayed_equal"]),
        "launches": all({k: tr["launches"].get(k, 0) for k in expected}
                        == expected for tr in trials),
        "finite": all(tr["losses"] and np.isfinite(tr["losses"]).all()
                      for tr in trials),
        "peak": abs(peak5 - peak0) <= P16_PEAK_SHARE * peak0,
        "best": best.metrics["val/loss"] == min(metric),
        "workers": agent_rc == 0 and w_best.get("trials") == 2
        and merged == [[r["params"]] for r in results[:2]]
        and w_best.get("best_params") in merged[0] + merged[1]
        and all(out["worker_checkpoints"])
        and not os.path.exists(os.path.join(directory, "checkpoints",
                                            "sweep_worker_2"))}
    if not all(checks.values()):
        raise SystemExit(f"phase 16: the sweep failed its checks: {checks}")
    return {"trial_launches": trials[0]["launches"], **out}


def _planted(rng) -> Tuple[str, list]:
    """A transcript of 3 to 5 letters, no letter twice in a row (the
    trellis puts no blank between two equal tokens, so a repeat may take
    one frame of the first's span), and its spans over the frames."""
    word, n = "", rng.randint(3, 6)
    while len(word) < n:
        c = P16_LETTERS[rng.randint(len(P16_LETTERS))]
        if not word or c != word[-1]:
            word += c
    spans, t = [], int(rng.randint(5, 40))
    for _ in word:
        width = int(rng.randint(4, 9))
        spans.append((t, t + width))
        t += width + int(rng.randint(3, 40))
    assert t < P16_FRAMES
    return word, spans


def _planted_emission(tokens: list, spans: list, classes: int, rng
                      ) -> np.ndarray:
    """Log-probabilities favouring each token over its span and the blank
    elsewhere, with drawn noise."""
    em = np.full((P16_FRAMES, classes), -10.0, np.float32)
    em[:, 0] = -0.5
    for tok, (s, e) in zip(tokens, spans):
        em[s:e, tok] = 0.0
    em += rng.rand(*em.shape).astype(np.float32) * 0.2
    return em - np.log(np.exp(em).sum(-1, keepdims=True))


def align_run(card: str, directory: str) -> dict:
    """Phase 16 (2): the align CLI on the card against the CPU."""
    from mme_tpu_torch.cli import align as align_cli
    rng = np.random.RandomState(P16_ALIGN_SEED)
    labels = ["-", "|", "'"] + list(P16_LETTERS)
    char2id = {c: i for i, c in enumerate(labels) if i > 0}
    with open(os.path.join(directory, "labels.txt"), "w") as f:
        f.write("\n".join(labels) + "\n")
    emdir = os.path.join(directory, "emissions")
    os.makedirs(emdir)
    words, planted = [], []
    for i in range(P16_ALIGN_ROWS):
        word, spans = _planted(rng)
        words.append(word)
        planted.append(spans)
        if i < P16_ALIGN_ROWS - 1:
            np.save(os.path.join(emdir, f"{i}.npy"), _planted_emission(
                [char2id[c] for c in word], spans, len(labels), rng))
    table = {"text": np.array(words),
             "audio_shape": np.full(P16_ALIGN_ROWS, P16_FRAMES * 320)}
    pkl = os.path.join(directory, "align.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(table, f)
    flags = ["--emissions_dir", emdir, "--labels",
             os.path.join(directory, "labels.txt")]
    timings = {}
    seconds = {}
    for leg, dev in (("card", "cuda"), ("cpu", "cpu")):
        t = time.perf_counter()
        out = align_cli.main([pkl, *flags, "--out", os.path.join(
            directory, f"aligned_{leg}.pkl")], device=dev)
        seconds[leg] = time.perf_counter() - t
        with open(out, "rb") as f:
            timings[leg] = pickle.load(f)["timings"]
    recovered = []
    for got, spans in zip(timings["card"], planted):
        if got is None:
            recovered.append(None)
            continue
        first, last = round(got[0] * 50), round(got[1] * 50)
        recovered.append(spans[0][0] <= first < spans[0][1]
                         and spans[-1][0] < last <= spans[-1][1])
    out = {"rows": P16_ALIGN_ROWS, "frames": P16_FRAMES,
           "card_equals_cpu": timings["card"] == timings["cpu"],
           "recovered": recovered, "timings": timings["card"],
           "seconds": seconds, "card": card}
    print(json.dumps({"align": out}), flush=True)
    if not (out["card_equals_cpu"] and all(recovered[:-1])
            and recovered[-1] is None):
        raise SystemExit("phase 16: the forced alignment failed its checks")
    return out


def timing_tools(card: str) -> dict:
    """Phase 16 (3): flash_crossover at its four shapes and
    profile_towers at PROF_STEPS=3, PROF_WINDOWS=1 (K3 on)."""
    from mme_tpu_torch import flash_crossover, profile_towers
    rows = flash_crossover.run(card=card)
    _free()
    with environ(P16_PROF_ENV):
        prof = profile_towers.run()
    _free()
    spec = profile_towers.bench_spec()
    want = {"text_tower": spec.text.encoder.layers,
            "audio_tower_with_conv": spec.audio.encoder.layers,
            f"video_tower_{spec.video.num_patches - spec.video_keep_k}":
                spec.video.encoder.layers,
            "fusion_trunk_473": spec.fusion.layers,
            "full_model_fwd_bwd": tav_layers(spec)}
    checks = {
        "crossover": all(isinstance(r[k], float) and r[k] > 0
                         for r in rows for k in ("flash", "plain", "sdpa"))
        and all(r["launches"] == {"flash_fwd": 1, "flash_bwd": 1}
                for r in rows),
        "towers": all(np.isfinite(v) and v > 0 for v in prof["ms"].values())
        and all(prof["launches"][k].get("flash_fwd") == n
                == prof["launches"][k].get("flash_bwd")
                for k, n in want.items())
        and prof["launches"]["adamw_update"] == {"adam_update": 1}}
    if not all(checks.values()):
        raise SystemExit(f"phase 16: the timing tools failed: {checks}")
    return {"flash_crossover": rows, "profile_towers": prof}


def tools_phase(card: str) -> dict:
    """Phase 16: the sweep (and K3 at its model's leaves), the alignment,
    then the timing tools."""
    directory = tempfile.mkdtemp(prefix="mme_p16_")
    try:
        hold = sweep_adam_hold(card)
        _free()
        sweep = sweep_run(card, directory)
        _free()
        align = align_run(card, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    tools = timing_tools(card)
    return {"sweep": sweep, "adam_hold": hold, "align": align, **tools}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--parallel"], ["--tools"]):
        print("usage: python3 chip_smoke.py [--parallel | --tools]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; count {torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    seconds = {}
    t0 = time.perf_counter()
    logs = kernels.build(["flash_fwd", "flash_bwd", "fused_mlp",
                          "layer_norm", "adam_update"])
    seconds["2"] = time.perf_counter() - t0
    print(f"build: {time.perf_counter() - t0:.1f} s\n{logs['flash_fwd']}\n"
          f"{logs['flash_bwd']}", flush=True)
    print(json.dumps({"fused_mlp_ptxas": ptxas_summary(logs["fused_mlp"])}),
          flush=True)
    print(json.dumps({"flash_ptxas": {name: kernel_ptxas(logs[name])
                                      for name in ("flash_fwd", "flash_bwd")}}),
          flush=True)
    print(json.dumps({"layer_norm_ptxas": kernel_ptxas(logs["layer_norm"])}),
          flush=True)
    print(json.dumps({"adam_update_ptxas": kernel_ptxas(logs["adam_update"])}),
          flush=True)

    if argv == ["--parallel"]:
        # phases 13, 14 and 15 alone: a quick run while the parallel axes
        # change; no result lines
        t0 = time.perf_counter()
        par = parallel_axes(card)
        seconds["14"] = par["two"]["phase_s"]
        seconds["15"] = par["pp"]["phase_s"]
        seconds["13"] = (time.perf_counter() - t0 - seconds["14"]
                         - seconds["15"])
        print(json.dumps({"phase_seconds": seconds}), flush=True)
        return 0
    if argv == ["--tools"]:
        # phase 16 alone: the sweeps, the alignment and the timing tools;
        # no result lines
        t0 = time.perf_counter()
        tools_phase(card)
        seconds["16"] = time.perf_counter() - t0
        print(json.dumps({"phase_seconds": seconds}), flush=True)
        return 0

    def timed(phase, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - start
        return out

    spec = TAVSpec(output_dim=7)
    t0 = time.perf_counter()
    fwd_err, fwd_shapes = check_flash(card)
    bwd_err, bwd_shapes = check_flash_bwd(card)
    # the trained model shares its audio frontend: one conv stack's leaves
    train_spec = dataclasses.replace(spec, share_audio_frontend=True)
    adam_err, adam = check_adam(train_spec, card)
    ln_fwd, ln_bwd = check_layer_norm(train_spec, card)
    check_gemm_core(card)
    mlp_fwd, mlp_bwd = check_fused_mlp(train_spec, card)
    seconds["3"] = time.perf_counter() - t0
    served, served_knobs = timed("4", main_path, card)
    params, step, step_fused, step_knobs = timed("5", train_path, card)
    torch.cuda.empty_cache()
    front_dir = tempfile.mkdtemp(prefix="mme_front_")
    try:
        loop, exports, loop_spec = timed("6", train_loop, params, card,
                                         front_dir)
        torch.cuda.empty_cache()
        bundle = timed("7", front_ends, card, loop_spec, front_dir, exports)
    finally:
        shutil.rmtree(front_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    family = timed("8", fusion_family, card)
    torch.cuda.empty_cache()
    w2v = timed("9", slice_models, card)
    torch.cuda.empty_cache()
    zoo_launches = timed("10", zoo, card)
    torch.cuda.empty_cache()
    data = timed("11", data_path, card)
    torch.cuda.empty_cache()
    pre = timed("12", pretrained, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    par = parallel_axes(card, params=params)
    del params
    # phases 13, 14 and 15 share a pool; phases 14 and 15 timed their own
    # parts
    seconds["14"] = par["two"]["phase_s"]
    seconds["15"] = par["pp"]["phase_s"]
    seconds["13"] = (time.perf_counter() - t0 - seconds["14"]
                     - seconds["15"])
    _free()
    tools = timed("16", tools_phase, card)
    print(json.dumps({"phase_seconds": seconds}), flush=True)

    def family_launches(name):
        """launches_<model> of phases 8, 9 and 10: one served chunk with
        both knobs on for a forward kernel, one bf16 train step with every
        knob on for the others (the MTL's fp32 step; 0 for a model without
        a train leg); phase 11's whole run and one of its train steps per
        bucket bound; phase 12's train run; phase 16's first sweep
        trial."""
        leg = "serve" if name.endswith("_fwd") else "step"
        out = {f"launches_{m}": family[m][leg].get(name, 0) for m in FAMILY}
        out["launches_wav2vec2_base"] = w2v[leg].get(name, 0)
        out.update({f"launches_{m}": zoo_launches[m][leg].get(name, 0)
                    for m in ZOO})
        out["launches_data_path"] = data["launches"].get(name, 0)
        out["launches_data_path_step"] = {
            str(bound): step.get(name, 0)
            for bound, step in sorted(data["per_step"].items())}
        out["launches_pretrained"] = pre.get(name, 0)
        out["launches_parallel_dp"] = par["dp"].get(name, 0)
        out.update({f"launches_parallel_sp_{tw}": par["sp"][tw].get(name, 0)
                    for tw in P13_TOWERS})
        out["launches_parallel_tp"] = par["two"]["tp"].get(name, 0)
        out["launches_parallel_ep"] = par["two"]["ep"].get(name, 0)
        out["launches_parallel_pp"] = par["pp"]["pp"].get(name, 0)
        out["launches_sweep"] = tools["sweep"]["trial_launches"].get(name, 0)
        return out

    def entry(name, route, source, replaces, result):
        """A kernel of this slice: launches of one training step with both
        knobs on (and of one served chunk for a forward kernel); times and
        bound summed over those launches."""
        out = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": step_knobs[name], **result}
        if name.endswith("_fwd"):
            out["launches_serve_chunk"] = served_knobs[name]
            out["launches_bundle_chunk"] = bundle["knobs_on"][name]
        return {**out, **family_launches(name)}

    def flash_entry(name, source, replaces, shapes, per, err, launches):
        total = {k: sum(r[k] * r[per] for r in shapes)
                 for k in ("ms", "plain_ms", "library_ms")}
        flops = sum(r["gflop"] * r[per] for r in shapes) * 1e9
        nbytes = sum(r["mbytes"] * r[per] for r in shapes) * 1e6
        # times and bound: the 54 launches of one chunk or step of 8
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, **launches,
                **total,
                "bound_ms": max(flops / PEAK_BF16_FLOPS,
                                nbytes / PEAK_BYTES) * 1e3,
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                             >= nbytes / PEAK_BYTES else "bytes"),
                **family_launches(name)}

    print(json.dumps({"kernels": [
        flash_entry("flash_fwd", "mme_tpu_torch/csrc/flash_fwd.cu",
                    "mme_tpu/ops/flash_attention.py:125", fwd_shapes,
                    "launches_per_chunk", fwd_err,
                    {"launches": served,
                     "launches_train_step": step["flash_fwd"],
                     "launches_train_loop": loop["flash_fwd"],
                     "launches_bundle_chunk": bundle["flash_fwd"]}),
        flash_entry("flash_bwd", "mme_tpu_torch/csrc/flash_bwd.cu",
                    "mme_tpu/ops/flash_attention.py:184", bwd_shapes,
                    "launches_per_step", bwd_err,
                    {"launches": step["flash_bwd"],
                     "launches_train_loop": loop["flash_bwd"]}),
        # times and bound: one call over every trainable leaf of one step
        {"name": "adam_update", "route": "cuda",
         "source": "mme_tpu_torch/csrc/adam_update.cu",
         "replaces": "mme_tpu/ops/adam_update.py:67",
         "launches": step_fused["adam_update"],
         "launches_train_loop": loop["adam_update"], "max_abs_err": adam_err,
         "ms": adam["all"]["ms"], "plain_ms": adam["all"]["plain_ms"],
         "library_ms": None, "bound_ms": adam["all"]["bound_ms"],
         "bound_by": adam["all"]["bound_by"],
         "kernel_ms": adam["all"]["kernels_ms"],
         "host_us": adam["all"]["host_us"], "leaves": adam["all"]["leaves"],
         "big_leaves_ms": adam["big"]["ms"],
         **family_launches("adam_update")},
        entry("layer_norm_fwd", "cuda", "mme_tpu_torch/csrc/layer_norm.cu",
              "mme_tpu/ops/layer_norm.py:63", ln_fwd),
        entry("layer_norm_bwd", "cuda", "mme_tpu_torch/csrc/layer_norm.cu",
              "mme_tpu/ops/layer_norm.py:73", ln_bwd),
        entry("fused_mlp_fwd", "cuda", "mme_tpu_torch/csrc/fused_mlp.cu",
              "mme_tpu/ops/fused_mlp.py:105", mlp_fwd),
        entry("fused_mlp_bwd", "cuda", "mme_tpu_torch/csrc/fused_mlp.cu",
              "mme_tpu/ops/fused_mlp.py:116", mlp_bwd)]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
