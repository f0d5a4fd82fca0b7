"""Chip smoke test of ofasys_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi
  2. build: every CUDA kernel of ofasys_torch/csrc, one nvcc each, in parallel,
     and beside them the host C++ libraries of csrc/host (the BPE encoder,
     the line index) with the host's compiler
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving and training paths give it, with times (CUDA
     events, median), the library call's time and the bound
  4. serve: text→text serving at the base arch's full width (E=768, 12 heads,
     6+6 layers) with a 50,000-symbol text vocabulary, random weights from a
     seed: 16 requests through InferenceServer -> OFASys.inference ->
     SequenceGenerator, with the kernel launch counts of that run
  5. profile: one serving dispatch under torch.profiler (device busy and
     idle share, the kernels that take the most device time)
  6. train: 5 summed two-task updates (text_infilling B=128 with span
     masking, gigaword B=64) through make_multitask_train_step at the same
     width, dropout 0.1, adamw with clipping, with the kernel launch counts
     of that run, a falling loss, and one update's gradients under the
     kernels against the plain attention path
  7. profile: one training update under torch.profiler
  8. serve_long: the text lengths raised to 1,000 (a second hub on the same
     model): 16 summarization requests with sources of 600-960 bytes
     (encoder T up to about 1,000), kernel B3 in every dispatch's encoder
  9. serve_truncated: one dispatch of 8 requests under the default
     max_src_length = 256 with 300-400 byte sources, cut to 257 tokens
 10. train_long: 5 summed two-task updates at long lengths
     (text_infilling_long B=16 with documents of 480-520 bytes,
     gigaword_long B=16 with articles of 880-960 bytes): kernel B3 and the
     one backward pass (B4-dq, B4-dkv, B5) on every long attention, B1/B2
     on the short decoder, a falling loss and one update's gradients
     against the plain attention path (4 samples per task), also with the
     flash backward's dd taken from the unrounded output
 11. profile_long: one long update under torch.profiler
 12. serve_int8: the serve phase's 16 requests on a deep copy of the serve
     model after ``OFASys.quantize()`` (w8a8): kernel B7 on every
     projection and the tied logits, 48 + 49 S launches per dispatch of S
     decode steps, tokens equal to the same hub with B7's plain version,
     parameter bytes before and after, one dispatch profiled
 13. serve_ln: one dispatch of the serve mix on a second model from the
     same seed with ln_impl='pallas' (kernel B6-fwd, 25 + 37 S launches per
     dispatch), first-step logits against ln_impl='xla'
 14. train_ln: the train phase's 5 updates with ln_impl='pallas' (124
     B6-fwd and 124 B6-bwd per update), gradients against ln_impl='xla',
     one update profiled (B6-bwd's device time); then one ln_impl='hybrid'
     update (124 B6-bwd, no B6-fwd)
 15. serve_caption: image→text serving on the same model (adaptors text +
     image_vit): 16 requests of "[IMAGE:img] what does the image describe?
     -> [TEXT:cap]" with 224 x 224 images from a seeded generator (12 beam
     5, 4 greedy), kernel B1 in every dispatch's encoder (196 patches + the
     prompt's tokens), p50 and tokens/s beside serve's
 16. train_mm: 5 summed three-task updates (caption B=64 with 224 x 224
     images, text_infilling B=128, vqa B=48 with an image and a question):
     B1 and B2 once per attention call, a falling loss, one update's
     gradients against the plain attention path; one update profiled
 17. train_rowmajor: the same three-task step with OFASYS_DENSE_BWD=rowmajor
     set for the phase and restored after: kernel B2r once per dense
     attention and B2 not at all, one update's gradients against the plain
     attention path and against B2's from the same weights and batches
     (GRAD_FROB_TOL), the step time beside train_mm's
 18. serve_asr: speech→text serving on the same model (adaptors text +
     image_vit + audio_fbank + motion_6d): 16 requests of "[AUDIO:wav] what
     is the transcription? -> [TEXT:text]" with 16 kHz wav bytes of 3.0-4.8 s
     from a seeded generator (12 beam 5, 4 greedy), the host time of the
     audio preprocessing per request, kernel B1 in every dispatch's encoder
     (the 4x-subsampled frames + the prompt's tokens), served answers
     against the hub on the same batch composition, p50 and tokens/s
     beside serve's; one dispatch profiled
 19. serve_motion: 8 text→motion requests with open 64 x 135 targets in one
     batch through DiffusionGenerator.generate (50 DDIM steps, eta 0, the
     motion preprocessor's clamp): B1 in the encoder and in every decoder
     self- and cross-attention of every full-context denoiser pass, the
     features against the plain attention path from the same initial noise
     (MOTION_REL_TOL), the wall time
 20. train_full: 5 summed five-task updates at bench.py's sizes (caption
     B=64, text_infilling B=128, asr B=32 with 480 fbank frames under
     speech_to_text_loss, vqa B=48, motion_t2m B=32 with 64 x 135 targets
     under diffusion_criterion): B1 and B2 once per attention call, a
     falling loss, each task's loss, one update's gradients against the
     plain attention path, the peak device memory; one update profiled
 21. serve_ground: a second model (adaptors text + image_resnet at
     resnet101, the 1,000 <bin>_i in its dictionary): 16 refcoco requests
     "[IMAGE:img,adaptor=image_resnet] which region does the text
     " [TEXT:text] " describe? -> [BOX:region_coord]" with 224 x 224
     images and expressions of GROUND_TEXT bytes (every encoder 252 < 256:
     B1) under the hub's BOX defaults, then 4 with the bins as
     constraint_range: B1 launches from the planned shapes, 4 tokens + EOS
     a request, a 4-vector box in [0, 1] wherever the 4 tokens are bins
     (the requests without one logged), every box a 4-vector under the
     range (a planted empty box caught), tokens against the plain attention path,
     the trunk's bf16 output against fp32 and its RMS block by block, p50
     and requests/s beside serve_caption's, the host ms of the image + box
     preprocessing; one dispatch profiled with the trunk's share
 22. train_ground: 5 summed refcoco B=48 + vqa B=48 updates through the
     trunk (the train split's joint flip / resize / object-centred crop on
     the host): B1/B2 launches, a falling loss, gradients against the plain
     attention path with the ResNet leaves, step time beside train_mm's,
     peak memory, one update profiled with the trunk's share; then
     RandAugment(2, 9) timed on the host
 23. train_ground_modal_ffn: one such update on a third model with
     modal_ffn=True: spans, experts, gradients; its generate raises in the
     first decode step (no plain fc1), as ofasys_tpu's does
After serve_motion (phase 19), on the serve model:
 24. serve_closed: 16 requests of the closed-set template (image_classify's,
     task/tasks.py:81) with 224 x 224 images, beam 5 under the trie of an
     ans2label table of 3,129 answers of 1-3 words from a seeded
     vocabulary: B1 in both dispatches' encoders, every answer in the set,
     tokens equal to the plain attention path's
 25. serve_sample: serve's 16 requests with sampling, top-k 256 (the hub's
     IMAGE default), then top-p 0.9: the same seed gives the same tokens
     (served against direct), another seed other tokens, top-k 1 greedy's
 26. serve_diverse: serve's 12 beam requests under diverse_beam (beam 4, 2
     groups) and diverse_siblings (beam 5), 4-best each, with the count of
     hypotheses plain beam search's 4-best does not hold
 27. serve_lexical: 16 gigaword-style requests with 1-3 constraints of 1-3
     tokens through SequenceGenerator under pointer, ordered and unordered:
     B1 per encoder layer and batch, every finished hypothesis holds its
     constraints (in order under ordered)
 28. serve_ensemble: serve's requests on an ensemble of the serve model and
     a second base model from seed 1: B1 in both members' encoders, a
     one-member ensemble is the model bit for bit, p50 beside serve's
 38. serve_speculative: OFASys.set_draft with a tiny-arch draft (random
     weights from SEED + 7), gamma 4: the first 4 of serve's sources as
     greedy calls (beam 1, no n-gram blocking) one at a time, then one
     dispatch of 8,
     each against the target alone in the same run (tokens equal, or
     parting at a near-tie of the target within SPEC_TIE_TOL, or where one
     side takes EOS and beam 1's answer scores better); the target steps,
     tokens per verify, mean acceptance, host syncs per verify, p50 beside
     the target alone's; B1 once per dense encoder layer of the target and
     the draft in the dispatch of 8, none at B=1; then the target as its
     own draft: every proposal accepted but at near-ties
 39. nan_check: one backward through the serve model with a NaN planted in
     one gradient leaf, found by check_tree at its flax path; a NaN planted
     in one encoder layer's fc1 output, named first by debug_forward
After train (phase 6), from the same seed:
 29. train_qat: train's updates under quant_training='fwd': B7 in every
     forward projection (4 per encoder and 7 per decoder layer per task,
     132 an update), the loss tracking train's, one update's gradients
     against quant_training='none', one update profiled beside train's
 30. train_chunked: train's updates with the chunked-vocab CE: loss and
     gradients against the unfused criterion, peak memory beside train's
 31. train_optimizers: one update under each of adafactor, sgd, nag,
     adagrad, adadelta and adamax: a finite loss, moved parameters, sgd's
     steps against the gradient
After train_full (phase 20), before the grounding model:
 32. train_fit: the README's front door at the base arch, from files: a
     GPT-2-sized BPE table made from the seed (encoder.json with 50,257
     entries, vocab.bpe with 50,000 merges) set as the text preprocess
     through the ConfigStore, text_infilling and gigaword TSV files of two
     batches' worth of rows each (train's byte lengths), two Tasks reading
     them (load_dataset_from_path; train's templates and batch sizes), then
     Trainer(cfg).fit(GeneralistModel(arch="base"), tasks, max_update=4)
     in summed mode (dropout 0.1, adamw at 1e-4, a checkpoint every 2
     updates): the vocabulary (about 50.3k), 36 B1 and 36 B2 an update, a
     falling loss, the update ms beside train's, the batches' host ms and
     the prefetch thread's waits, checkpoint bytes and save/join/load ms,
     the host syncs of an update; a second Trainer resumes from
     checkpoint_1_2 into its own save_dir and its checkpoint_last equals
     the first's bit for bit, with the meters and iterator states; one
     resumed update profiled
 33. serve_pretrained: OFASys.from_pretrained(checkpoint_last) serves
     serve's 16 requests (sources of serve's token counts under the BPE
     table) through InferenceServer, tokens equal to
     OFASys.from_trainer(trainer, tasks)'s on the same batches; an ensemble
     from_pretrained([checkpoint_last, checkpoint_1_2]) serves 4 (B1 twice
     per encoder layer); p50 beside serve's
After serve_pretrained, on train_fit's files and checkpoints:
 35. evaluate: `python -m ofasys_torch.cli.evaluate evaluate.json --ckpt
     checkpoint_last --split valid` on a JSON config of two tasks at the
     base arch (the shape of examples/text_infilling.yaml): gigaword (128
     valid rows of train's byte lengths, B=64, beam 5, rouge) and glue sst2
     (256 rows, B=64, the answers no/yes through ans2label, accuracy): the
     printed metrics, gigaword's hypotheses equal to hub.inference on the
     same records, sst2's picks equal to the argmax of the plain attention
     path's scores but at ties (a plain margin of at most twice the row's
     score difference), the largest score difference within
     TRAVERSE_SCORE_ATOL, B1 once per dense encoder layer of each
     generation batch and of each candidate pass, rows per second, one
     traverse batch profiled
 37. traverse_kernels: one sst2 traverse batch's scores under B1 against
     the same scores with B1's plain version in its place, on the card
 36. launch: `python -m ofasys_torch.launch launch.json`, train_fit's run
     written as JSON (its tasks, TSV files, batch sizes, dropout, adamw,
     seed, 4 updates: the polynomial schedule's length is max_update, so a
     2-update run would step another learning rate), into its own
     save_dir: checkpoint_1_2 and checkpoint_last equal train_fit's bit for
     bit (params, moments, step) with equal meters, 36 B1 and 36 B2 an
     update; the same config as YAML with an _include parent and
     ${var} paths loads to the same dict; one
     `python -m ofasys_torch.cli.train launch.json --set ...` run whose
     overrides reach its TrainerConfig
 40. train_profile: train_fit's run with common.profile=True: the Chrome
     trace the trainer wrote read back by tools/profile_breakdown (one
     summary per `update <n>` range), B1 and B2 counted in it by kernel
     name (36 each an update), each update's wall, busy time (the union of
     its device events) and idle share (the median of updates 2, 4 and 6
     beside train_fit's torch.profiler figure), checkpoints and meters bit
     for bit with train_fit's
 40a. host_native: serve's request sources and train_fit's TSV texts
     tokenized by NativeGPT2BPE and by GPT2BPE on train_fit's 50,257-entry
     table (the same ids for every string; µs a string, cold and warm);
     train_fit's preprocess_ms per task with each encoder, alternated in
     this call; the TSVs' line index built natively and by the numpy scan
     (the same bytes; ms each); profile_breakdown's summary of
     train_profile's trace: device time by kind, the top ops, the five
     longest idle gaps with the host event active on the launching thread,
     and the steady updates' idle share beside train_fit's figure
 41. train_fetch: train_fit's TSVs read as testfs:// URLs through a
     fetcher the phase registers (a copy of the local file) into a fresh
     $OFA_CACHE_HOME: checkpoints bit for bit with train_fit's at updates 3
     and 6, one cache entry with its .json sidecar per fetched file; a
     seeded .bin token file read through OssTextBinReader, its records
     the array's blocks
After serve_ground, on its hub:
 34. import_reference: the grounding model exported as a reference
     state_dict (export_reference_state_dict, plus the decoder's
     embed_tokens copy and every num_batches_tracked, as a fairseq
     checkpoint holds them) saved as {"model": sd}, converted by
     `python -m ofasys_torch.utils.torch_import --arch base --adaptors
     text,image_resnet --dict <the saved dictionary>` and served by
     OFASys.from_pretrained: missing empty, unused exactly those extras,
     every leaf the source's bit for bit, serve_ground's 16 requests (6 B1
     a dispatch) with the source hub's boxes on the same batches; bytes,
     convert and load seconds, p50 beside serve_ground's; with
     OFASYS_MULTITASK_CKPT naming a released checkpoint, it is converted
     and one caption decoded greedily
After train_ground_modal_ffn, on a speech model (adaptors text, image_vit,
audio_fbank, audio_tgt_fbank; random weights from SEED):
 42. serve_tts: 8 text-to-speech requests (serve's sources) in one dispatch
     through the hub, at the EOS threshold and for a full 256 frames:
     frames, lengths, Griffin-Lim waveforms, B1 once per encoder layer a
     dispatch, the first 8 frames against the plain attention path with
     the same prenet draws (TTS_REL_TOL)
 43. train_tts: 5 updates of TTS B=16 (1.0-3.0 s targets) under
     ofa_tacotron2 with guided attention: B1/B2 in the encoder, B3 and
     the flash backward in the decoder's self-attention, a falling loss,
     gradients against the plain attention path
 44. train_audio_pretrain: 5 updates of audio pretraining B=32 (serve_asr's
     wavs) under speech_pretrain_loss at mask_prob 0.65: B1 also in the
     teacher's encoder, gradients as above
 45. train_scst: one scst_train_step on a caption batch of 16 (224 px) with
     5 samples each at top-k 50: B1 in every sampling encoder and in the
     policy pass, B2 in its backward; the policy gradient on the same
     samples against the plain attention path; B1 and B2 held at the
     pass's shapes
Then, on an image-code model (the 8,192 <code>_i in its dictionary, the
image_vqgan preprocessor's VQGAN at 256 px on the card; adaptors text,
image_vit, image_vqgan):
 46. serve_image_gen (the image-code model at 3+3 layers, CODE_LAYERS): 2
     prompts best-of-2 through Task("image_gen"): 1,024
     codes each, every token a <code>, 256 x 256 images, the rerank skipped
     without CLIP weights (logged), B1 in the encoder
 47. train_image_infilling: 5 updates of B=8 with targets encoded to codes
     on the card: B3 and the flash backward in the decoder at T = 1,025,
     gradients against the plain attention path, peak memory
Then, on a video model (the image-code model's dictionary; adaptors text,
image_vqgan, video_image_sequence; random weights from SEED):
 48. serve_video: 8 video_caption requests (12 frames of 224 px sampled
     to 8: 1,568 patches + the prompt) through the server with beam 5: B3
     once per encoder layer of each dispatch, as attention_route gives it
     for the encoder's (B, T), served against direct, the encoder output
     against plain attention, the tokens against the plain attention path
     (near-ties within CLOSED_TIE_TOL, at a step's selection or at the pick
     among the finished hypotheses), the video preprocessor's host ms a
     request, p50 beside serve's
 49. train_video: 5 summed video_caption (B=8) + video_generation (B=4,
     the condition frame's 1,025 VQGAN codes as target) updates: B3 and the
     flash backward on the encoders, video_generation's decoder and both
     cross attentions (the caption encoder's dq partials past SCRATCH_CAP:
     samples in groups), B1/B2 on the caption decoder, the bias shape (one
     for the batch: B5's sum), a falling loss, gradients against the plain
     attention path on VIDEO_GRAD_BATCH samples a task, the relative
     tables' gradient against the plain gather's, step time, peak memory;
     one update profiled
On the serve model, after serve_speculative:
 50. serve_spider: Task("spider").evaluate over 16 rows on two sqlite
     databases built from the seed (the schema read from the file, question
     words linked to cells): exact_match, sql_match_acc, sql_exec_acc and
     rows/s, the encoder's route by the schema prompt's length (the 3-table
     database's batch B1, the 11-table one's B3), the SQL
     metrics recomputed on the host from the written hypotheses, and the
     references against themselves 1
After train_video:
 51. train_struct: 5 summed sudoku (9 x 9 grids), dart (tables of
     triples) and spider (schema prompts) updates of B=32 through the
     struct, table and database preprocessors: B1/B2, a falling loss,
     gradients against the plain attention path
 52. train_asr_ctc: on a model whose dictionary the text_phone and phone
     preprocessors built (41 + 2 <phone> rows), 5 updates of
     speech_to_text B=32 with text_phone targets under speech_to_text_loss
     at ctc_weight 0.5: ce_loss and ctc_loss finite and falling, B1/B2,
     gradients against the plain attention path; then phone_to_text served
     once (8 requests of seeded words' phones, beam 5)
 53. heads: HiFi-GAN V1 (random weights from SEED, fp32) over serve_tts's
     frames on the card, ms a second of audio, the first two against the
     CPU; the pooling head in each mode over serve's encoder output, card
     against CPU
 54. serve_scan (after nan_check): the serve hub's weights saved as a
     stacked-layout checkpoint (``layers_scan/layer``) and served by
     OFASys.from_pretrained into a scan_layers model: serve's tokens
 55. train_remat: one update's gradients of the two-task step under remat
     'none', 'full' and 'dots' (equal bit for bit), each mode's peak memory
     and gradient-step time, B1 twice per attention call under remat; then
     train_long's batches under 'none' and 'full' (B3 recomputed)
 56. train_moe / serve_moe: 8 experts in every second layer at the base
     width: 5 updates with a falling loss and the aux term logged, then
     serve's 16 requests
 57. parallel_world: two spawned ranks on cuda:0 over gloo: one gradient
     step at data=2, fsdp=2, tensor=2 (six heads a rank), sequence=2
     (gigaword_long padded to 1,000: ring blocks of 500 on B3 and the flash
     backward), expert=2 and pipeline=2, each against the one-process
     step at the base width and 2+2 layers (each rank's parameter bytes
     printed: fsdp holds only its slices); OFASys.shard at tensor=2
     serving serve's dispatches in bf16 and after quantize() (B7 on the
     weight shards) against one-rank serving; the ops staged through the
     host printed
 58. nccl_world: the data path in a one-rank NCCL world, run beside
     parallel_world
The kernel phase holds B1 and B2 at the shapes of the new paths too (the
asr encoder, causal decoder and cross attention, the motion decoder in full
context and its cross attention, serve_asr's dispatches and serve_motion's
denoiser, serve_ground's dispatches and train_ground's refcoco calls; its
vqa calls are train_mm's shapes; B1 also at evaluate's encoder shapes and
at the decoder self and cross attentions of its sst2 candidate passes that
reach the dense kernel) and prints each shape's route. It also holds kernel B3 and the
one flash backward pass (for B4-dq, B4-dkv and B5) against their plain versions at every shape of the
long paths, a per-(b, h) bias, a causal and a ragged shape and at
FLASH_EDGE_SHAPES (head dims 88, 128 and 256, a batch of one, ragged Tq !=
Tk, T = 4,096 past the backward's scratch cap), each run twice for equal
bits and with planted faults (a key tile left out; for the backward also
dd = 0) at every shape; B7 at serve_int8's shapes (decode logits, fc1, fc2
and q/k/v/out at 40 and 4 rows, the encoder's projections, a ragged K for
the __dp4a kernel), bit for bit, each with its plan and a planted fault (a
K slice left out: one cluster rank's share under a split); B6 at the train
mix's shapes and at E = 1,024, 4,096 and an odd 1,001, B6-bwd with its plan,
the same bits from two calls and from its two parts run apart, each part's
time, and two planted faults (a row left out; one block's partial left out
of the reduction); B2r beside B2 at
every training shape and at EDGE_SHAPES (ragged Tq != Tk, B=1, head dims
88, 128 and 256), B2 and B2r each run
twice for equal bits and with a planted key-tile fault, and B1 and B2r (and
B2) with the scale and the causal mask inside the kernel at a decoder shape
and at a shape with Tq < Tk (the causal offset), with two planted faults;
B1 also at serve_closed's, serve_lexical's, serve_pretrained's, evaluate's,
serve_tts's and serve_image_gen's dispatch shapes, B1 and B2 at the
encoders of train_tts, train_audio_pretrain (and its decoder) and
train_image_infilling, B3 and the flash backward at their decoders' flash
calls (with both planted faults),
and at the speculative draft's dispatch of 8 (its own 4 heads, D = 64), B1 and
B2 at every attention shape of train_fit's six updates, and B7 also
at every shape of train_qat's projections. B3 and the flash backward are
held at train_video's flash calls (the caption encoder at 8 x 1,600,
video_generation's encoder, causal decoder and its 1,032 x 1,568 cross)
with both planted faults, B3 at serve_video's dispatch and serve_spider's
second batch; B1 and B2 at train_video's caption decoder and every call of
train_struct and train_asr_ctc, B1 at serve_spider's first batch; B1
and B2 at the tensor rank's six heads and B3 with the flash backward at
the ring's blocks (non-causal and the causal diagonal).
The build phase logs ptxas's registers and spills of every kernel and
fails if B6-bwd's row kernel spills.
Prints a ``{"kernels": [...]}`` line, then, last,
``{"ok": true, "device": {"platform": "gpu", ...}}``.
Imports nothing of JAX or ofasys_tpu. Exits non-zero without CUDA.

The serve and train phases can be rehearsed on the CPU at a tiny arch,
where the kernels' plain versions stand in and no launch is counted:
``train_and_check(build_train_model(d, "cpu", arch="tiny"), gp, "cpu",
tasks=TINY_TRAIN_TASKS)``; the long paths the same way with
``long_preprocess(d)``, ``TINY_LONG_TRAIN_TASKS`` and
``ofasys_torch.model.transformer.flash_available`` patched to return True
(see the README); serve_int8 and serve_ln with
``serve_int8_and_check(hub, "cpu")`` and ``serve_ln_and_check(hub, "cpu")``,
train_ln with ``train_ln_and_check(d, gp, "cpu", arch="tiny",
tasks=TINY_TRAIN_TASKS)``; the image phases with a ``GeneralPreprocess(d,
active=["text", "image"])``: ``serve_caption_and_check(hub, "cpu")``,
``train_and_check(m, gp, "cpu", tasks=TINY_MM_TRAIN_TASKS, label="train_mm")``
and ``train_rowmajor_and_check(d, gp, "cpu", arch="tiny",
tasks=TINY_MM_TRAIN_TASKS)``; the speech and motion phases on a tiny hub
whose model has ``ACTIVE_ADAPTORS`` and ``cfg.attn_kernel="pallas"``:
``serve_asr_and_check(hub, "cpu")``, ``serve_motion_and_check(hub, "cpu")``
and ``train_and_check(m, gp, "cpu", tasks=TINY_FULL_TRAIN_TASKS,
label="train_full")``; the grounding phases with ``d, gp =
ground_preprocess()``, ``hub = build_ground_hub(d, gp, device="cpu",
arch="tiny")`` (``cfg.attn_kernel="pallas"``): ``serve_ground_and_check(hub,
"cpu")``, and ``train_and_check(build_train_model(d, "cpu", arch="tiny",
adaptors=GROUND_ADAPTORS), gp, "cpu", tasks=TINY_GROUND_TRAIN_TASKS,
label="train_ground")``; phases 24-28 on the tiny image hub with
``serve_closed_and_check(hub, "cpu")``, ``serve_sample_and_check``,
``serve_diverse_and_check``, ``serve_lexical_and_check`` and
``serve_ensemble_and_check``, phases 29-31 with ``build_train_model``
patched to the tiny arch: ``train_qat_and_check(d, gp, "cpu", batches,
train_res)``, ``train_chunked_and_check`` and
``train_optimizers_and_check(d, gp, "cpu", batches)``; phases 35-37 after
train_fit's rehearsal (``fx = fit_fixture(root, tasks=TINY_FIT_TASKS)``,
``efx = eval_fixture(fx, TINY_EVAL_TASKS, arch="tiny", device="cpu")``,
under ``gpt2_text(fx)``): ``evaluate_and_check(fx, efx, "cpu",
fit["last"], device="cpu")``, ``traverse_kernels_and_check(trav, "cpu")``
and ``launch_and_check(fx, fit, "cpu", counts, device="cpu",
arch="tiny")``; phase 34 on the tiny grounding hub with
``import_reference_and_check(hub, "cpu", None, device="cpu", arch="tiny")``;
phases 38-39 on a tiny hub (fp32, ``attn_kernel="pallas"``) with
``serve_speculative_and_check(hub, "cpu")`` and ``nan_check_and_check(hub,
"cpu")``; phases 40-41 after train_fit's rehearsal with
``launches, prof, breakdown = train_profile_and_check(fx, fit, "cpu", res,
device="cpu", arch="tiny")``, ``host_native_and_check(fx, "cpu", breakdown,
prof, res)`` and ``train_fetch_and_check(fx, fit, "cpu", device="cpu",
arch="tiny")``;
phases 42-47 as the README's rehearsal paragraph shows (a tiny fp32 speech
model and image-code model at 32 px, ``flash_available`` patched); phases
48-53 the same way on tiny fp32 models: ``serve_video_and_check(vm, gp,
"cpu")`` and ``train_video_and_check(vm, gp, "cpu", b, b)`` with ``b =
video_batches(gp, TINY_VIDEO_TRAIN_TASKS)`` (the store's video preprocess
at 4 frames of 128 px), ``serve_spider_and_check(m, "cpu", root)``,
``train_and_check(m, gp, "cpu", tasks=TINY_STRUCT_TRAIN_TASKS,
batches=struct_batches(gp, root, TINY_STRUCT_TRAIN_TASKS))``,
``train_asr_ctc_and_check(m, gp, "cpu", tasks=TINY_ASR_CTC_TASKS)`` on
``ctc_preprocess()``'s dictionary, ``serve_phone_and_check`` and
``heads_and_check(frames, enc, "cpu", device="cpu")``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# FLOP/s, int8 OP/s (tensor cores), fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12

# the H100 SXM's boost clock (cycles a second of torch.cuda._sleep) and the
# calls of a plain version timed (each takes up to milliseconds; its time
# is a reference column, the kernels' are taken with time_ms's defaults)
SLEEP_CYCLES_PER_S = 1.98e9
PLAIN_TIMING = dict(n=10, repeats=3)

SEED = 0
TPL = "[TEXT:src] -> [TEXT:tgt]"
SERVE_SRC = (40, 200)         # source bytes of the serving run
N_BEAM_REQUESTS = 12          # the hub's TEXT defaults: beam 5, no-repeat 3-grams
N_GREEDY_REQUESTS = 4         # beam_size=1
MAX_LEN_B = 16
# bf16 tolerances. Kernel vs plain version: B3 rounds p to bf16 before p.V
# unnormalized (its online softmax), its plain version normalized; B1
# rounds the normalized p as its plain version does, with the fp32 sums in
# another order -> out atol 2e-2; lse is an fp32 sum of the same products
# in another order -> atol 1e-3.
OUT_ATOL = 2e-2
LSE_ATOL = 1e-3
# Encoder output, kernel vs plain attention through 6 bf16 layers: the plain
# path rounds scores to bf16 before the softmax (attn_logits='compute'), the
# kernel keeps them fp32, so the two differ by bf16 rounding carried through
# the stack: relative Frobenius error <= 2e-2 and max abs <= 0.25 (final-LN
# outputs of order 1; a bf16 ulp at 4 is 0.03).
ENC_REL_TOL = 2e-2
ENC_ABS_TOL = 0.25

# the training slice: ofasys_tpu's task zoo templates (task/tasks.py)
INFILL_TPL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
SUMMARY_TPL = 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]'
# batch and text lengths in bytes (the byte tokenizer: one token each):
# text_infilling targets of about 64 tokens (bench.py's infilling shape),
# gigaword sources that give the encoder about 190 tokens and summaries of
# about 24
TRAIN_TASKS = {
    "text_infilling": dict(template=INFILL_TPL, batch=128, text=(58, 62)),
    "gigaword": dict(template=SUMMARY_TPL, batch=64, src=(140, 150), tgt=(20, 24)),
}
TINY_TRAIN_TASKS = {
    "text_infilling": dict(template=INFILL_TPL, batch=4, text=(58, 62)),
    "gigaword": dict(template=SUMMARY_TPL, batch=2, src=(140, 150), tgt=(20, 24)),
}
# the long paths (sources and targets past 256 tokens: kernel B3 and the
# one flash backward pass for B4 and B5):
# the text preprocessor's max_src_length and max_tgt_length raised to 1,000
# (examples/long_context.yaml), so every sequence with bos and eos fits the
# base arch's 1,024 positions
LONG = 1000
LONG_SRC = (600, 960)         # serve_long sources: encoder T of about 640-1,000
TRUNC_SRC = (300, 400)        # serve_truncated: cut to 257 tokens at the default 256
LONG_TRAIN_TASKS = {
    "text_infilling_long": dict(template=INFILL_TPL, batch=16, text=(480, 520)),
    "gigaword_long": dict(template=SUMMARY_TPL, batch=16, src=(880, 960), tgt=(40, 60)),
}
TINY_LONG_TRAIN_TASKS = {n: dict(spec, batch=2) for n, spec in LONG_TRAIN_TASKS.items()}
# samples per task of the long gradient check: the plain path it compares
# with keeps (B, H, T, T) scores per layer for the backward
GRAD_CHECK_BATCH = 4
# Kernels B3-B5 vs their plain versions (bf16): B3 out atol 2e-2 (bf16
# output; p is rounded to bf16 against its tile's running max in the
# kernel, the row max in the plain version) and lse atol 1e-3 (fp32 sums in
# another order).
# Backward kernels B2 and the flash backward (B4, B5): each gradient is
# held to the reference's own size, |got - ref|_F / |ref|_F and
# max|got - ref| / max|ref|. dq, dk,
# dv are bf16 outputs that both sides round at the same points (p and ds
# to bf16 before their products), so they differ only where a reordered
# fp32 sum crosses a rounding boundary: Frobenius 1e-3, max 1e-2 (2.5 bf16
# ulps of the largest entry). B2's dbias, B5's and the per-(b, h) ds are
# fp32 sums of unrounded ds: 1e-3 on both measures. At the long shapes
# (rms of dq, dk, dv 0.013-0.25, largest entries 0.65-6.8) a kernel that
# dropped dd is off by 8e-2 or more and one that skipped a key tile by 0.26
# or more (Frobenius): check_flash plants both faults at every training
# and edge shape and fails unless the limits catch them.
GRAD_FROB_TOL = 1e-3
GRAD_MAX_TOL = 1e-2
DS_REL_ATOL = 1e-3
FLASH_TIMING = dict(n=5, repeats=3)   # flash calls take milliseconds: fewer repeats

# the image slice: ofasys_tpu's caption template (task/tasks.py:78, the hub's
# first example) and the VQA template (task/tasks.py:485), 224 x 224 images
# (196 patches of 16 pixels); batch sizes and lengths follow bench.py's
# caption (B=64, target about 24) and grounding/VQA (B=48, question about
# 16, answer about 8) tasks
ACTIVE_ADAPTORS = ("text", "image_vit", "audio_fbank", "motion_6d")
CAPTION_TPL = "[IMAGE:img] what does the image describe? -> [TEXT:cap]"
VQA_TPL = "[IMAGE:img] [TEXT:question] -> [TEXT:answer]"
IMAGE_SIZE = 224
MM_TRAIN_TASKS = {
    "caption": dict(template=CAPTION_TPL, batch=64, image=IMAGE_SIZE, cap=(20, 24)),
    "text_infilling": TRAIN_TASKS["text_infilling"],
    "vqa": dict(template=VQA_TPL, batch=48, image=IMAGE_SIZE, question=(14, 16), answer=(6, 8)),
}
TINY_MM_TRAIN_TASKS = {
    "caption": dict(MM_TRAIN_TASKS["caption"], batch=4),
    "text_infilling": TINY_TRAIN_TASKS["text_infilling"],
    "vqa": dict(MM_TRAIN_TASKS["vqa"], batch=2),
}
# the speech and motion slice: ofasys_tpu's speech_to_text template
# (task/tasks.py:360) with 16 kHz mono 16-bit wavs of ASR_SECONDS (300-480
# fbank frames, 75-120 encoder positions after the 4x subsampling), and its
# text-to-motion template (task/tasks.py:454) with 64-frame x 135-feature
# targets, sampled by the DiffusionGenerator's defaults (1,000 train steps,
# cosine schedule, 50 DDIM steps, eta 0)
ASR_TPL = "[AUDIO:wav] what is the transcription? -> [TEXT:text]"
MOTION_TPL = 'motion capture: " [TEXT:text] " -> [MOTION:bvh,preprocess=motion_6d,adaptor=motion_6d]'
SAMPLE_RATE = 16000
ASR_SECONDS = (3.0, 4.8)
MOTION_FEAT = 135
N_MOTION_REQUESTS = 8
# serve_motion: features after 50 DDIM steps under the kernels against the
# plain attention path (fp32 scores) from the same initial noise. Each
# denoiser pass differs by the bf16 rounding of ENC_REL_TOL; the x0
# estimate divides by sqrt(alpha_bar_t) (0.016 at t = 999 of the cosine
# schedule) and is clamped to +-5, and the last steps set the sample, so
# the pass-level error carries over about as it is: relative Frobenius
# error <= MOTION_REL_TOL.
MOTION_REL_TOL = 5e-2
# the five tasks of bench.py:36-45 at its sizes: caption B=64 (224 x 224
# images), text_infilling B=128, asr B=32 with wavs of 4.75-4.8 s (473-478
# fbank frames, padded to 480: 120 encoder positions + the prompt's
# tokens) and transcripts of 26-30 bytes (32-token targets with bos and
# eos), vqa B=48, motion_t2m B=32 with short texts and 64 x 135 targets
# cropped from clips of 64-80 frames; asr under speech_to_text_loss,
# motion under diffusion_criterion
FULL_TRAIN_TASKS = {
    "caption": MM_TRAIN_TASKS["caption"],
    "text_infilling": TRAIN_TASKS["text_infilling"],
    "asr": dict(template=ASR_TPL, batch=32, audio=(4.75, 4.8), text=(26, 30),
                criterion="speech_to_text"),
    "vqa": MM_TRAIN_TASKS["vqa"],
    "motion_t2m": dict(template=MOTION_TPL, batch=32, motion=(64, 80), text=(8, 14),
                       criterion="diffusion"),
}
TINY_FULL_TRAIN_TASKS = {
    "caption": dict(MM_TRAIN_TASKS["caption"], batch=4),
    "text_infilling": TINY_TRAIN_TASKS["text_infilling"],
    "asr": dict(FULL_TRAIN_TASKS["asr"], batch=2, audio=(1.0, 1.2)),
    "vqa": dict(MM_TRAIN_TASKS["vqa"], batch=2),
    "motion_t2m": dict(FULL_TRAIN_TASKS["motion_t2m"], batch=4),
}
# the grounding slice: ofasys_tpu's refcoco template (task/tasks.py:182) and
# the vqa template with the IMAGE slot on the reference OFA-base image trunk,
# image_resnet at resnet101 (``adaptor=image_resnet``: an IMAGE source slot
# resolves to image_vit by default); a second model (GROUND_ADAPTORS) whose
# dictionary also holds the box preprocessor's 1,000 <bin>_i. serve_ground's
# referring expressions are GROUND_TEXT bytes: with the prompt's 42 bytes,
# bos and eos the text group is 52-56 tokens, padded to 56, so every
# dispatch's encoder holds 196 + 56 = 252 positions (< 256: kernel B1).
# train_ground is bench.py's grounding_vqa (B=48) as refcoco B=48 (seeded
# images of 240-320 pixels a side, a seeded region each, the train split's
# joint flip / resize / object-centred crop) + vqa B=48, both through the
# trunk
GROUND_ADAPTORS = ("text", "image_resnet")
REFCOCO_TPL = ('[IMAGE:img,adaptor=image_resnet] which region does the text " [TEXT:text] " '
               'describe? -> [BOX:region_coord]')
GROUND_VQA_TPL = "[IMAGE:img,adaptor=image_resnet] [TEXT:question] -> [TEXT:answer]"
GROUND_TEXT = (8, 12)
N_GROUND_REQUESTS = 16
N_CONSTRAINED_REQUESTS = 4
GROUND_TRAIN_TASKS = {
    "refcoco": dict(template=REFCOCO_TPL, batch=48, image=(240, 320), region=True, text=GROUND_TEXT),
    "vqa": dict(MM_TRAIN_TASKS["vqa"], template=GROUND_VQA_TPL),
}
TINY_GROUND_TRAIN_TASKS = {n: dict(spec, batch=2) for n, spec in GROUND_TRAIN_TASKS.items()}
# image_resnet's trunk in bf16 against the same trunk in fp32 (TF32 off) on
# the same images: every convolution rounds its bf16 operands (2^-9
# relative) and its output, each FrozenBatchNorm its factors and its
# output; over 104 convolutions the roundings add up as a random walk of
# about sqrt(104) * 2^-9 = 2e-2 before the ReLUs and the residual sums
# damp or carry them: relative Frobenius error <= TRUNK_REL_TOL
TRUNK_REL_TOL = 5e-2
RAND_AUGMENT_IMAGES = 48

# B1 and B2r with the scale and the causal mask inside the kernel, as a
# direct ``_dense_attention(..., scale, causal=True, H)`` call runs them:
# the caption decoder's shape and one with Tq < Tk (the causal offset)
INSIDE_SHAPES = [("caption_decoder_inside", (64, 32, 32)), ("causal_offset_inside", (5, 40, 72))]
INSIDE_SCALE = 0.125          # (2 * D) ** -0.5 at D = 32; exact in bf16
# the kernel phase's shapes beyond the paths' own (B, Tq, Tk, H, D): ragged
# Tq != Tk, a batch of one, the image tasks' nominal 196 patches, and head
# dims where the tensor-core kernels pad D (88, the 10b arch's) or split
# B2's keys into ranges (128 at Tk = 256, 256), with H * D <= 4096
EDGE_SHAPES = [("ragged_cross", (3, 24, 200, 12, 64), False), ("ragged_40_200", (3, 40, 200, 12, 64), False),
               ("B1", (1, 64, 64, 12, 64), False), ("patches_196", (64, 196, 196, 12, 64), False),
               ("D88", (8, 96, 96, 32, 88), False), ("D128_T256", (4, 256, 256, 8, 128), False),
               ("D256", (4, 64, 100, 16, 256), False)]
# the flash kernels' shapes beyond the long paths' own (B, Tq, Tk, H, D),
# causal: head dims where the tensor-core kernels pad D (88) or take their
# other tiles (B3: 128; 256 with 32-key tiles; the backward: 112-, 112- and
# 48-key ranges), with H * D <= 4096, a batch of one at T = 1,000 (the
# backward's per-(b, h) ds), ragged Tq != Tk with Tk no multiple of the
# 64-key tile, and T = 4,096, where the backward's dq partials (18 ranges)
# pass fl.SCRATCH_CAP and its samples go one at a time
FLASH_EDGE_SHAPES = [("flash_D88", (2, 300, 333, 32, 88), False),
                     ("flash_D128", (4, 300, 300, 16, 128), False),
                     ("flash_D256_causal", (2, 290, 290, 16, 256), True),
                     ("flash_B1", (1, 1000, 1000, 12, 64), False),
                     ("flash_ragged", (3, 200, 333, 12, 64), False),
                     ("flash_long_T4096", (2, 4096, 4096, 12, 64), False)]

# decode extras and training options: the closed-set template of
# image_classify (task/tasks.py:81) with an ans2label table of N_ANSWERS
# answers (the usual VQAv2 answer set's size) of 1-3 words; the length
# limit is above the longest answer (3 words of up to 8 letters, the
# leading space, eos), since EOS forced at the limit would cut one
CLOSED_TPL = "[IMAGE:img] what does the image describe? -> [TEXT:label_name,closed_set]"
N_ANSWERS = 3129
CLOSED_MAX_LEN = 32
N_CLOSED_REQUESTS = 16
# serve_closed's tokens against the plain attention path: the bf16 encoder
# differs from the plain path's by ENC_REL_TOL-sized rounding, which moves
# a step's log-probs by about 1e-2; with random weights many answers score
# alike, and a beam selection that keeps one prefix over another by less
# than that can go the other way, after which the searches part. A request
# whose best answer differs passes only if both answers are in the set and
# the first selection at which its two searches part had a margin of at
# most CLOSED_TIE_TOL (cumulative log-prob) in one of them.
CLOSED_TIE_TOL = 5e-2
DIVERSE = {"diverse_beam": dict(search_strategy="diverse_beam", beam_size=4, num_groups=2),
           "diverse_siblings": dict(search_strategy="diverse_siblings", beam_size=5)}
N_BEST = 4
LEXICAL_SRC = (140, 150)      # gigaword sources of the train mix: encoders of about 190 tokens
N_LEXICAL_REQUESTS = 16
LEXICAL_MAX_LEN = 32
REPRESENTATIONS = ("pointer", "ordered", "unordered")
NEG_SCORE = -1e8              # below: a slot of the finished pool no hypothesis filled
OPTIMIZERS = ("adafactor", "sgd", "nag", "adagrad", "adadelta", "adamax")
# train_qat: ofasys_tpu's own bound on the quantized run's loss
# (tests/test_quant_training.py:95)
QAT_LOSS_FACTOR, QAT_LOSS_SLACK = 1.25, 0.25
# One update's gradients, quant_training 'fwd' vs 'none' at the same
# parameters: every forward projection of the 12 layers carries the int8
# rounding of its input rows and weight columns (a product's relative error
# about 1%), which the backward carries to every leaf: 1.2e-2 over all
# leaves in a CPU rehearsal at the tiny arch (4+4 layers, bf16); the limit
# leaves room for the base arch's 6+6 layers.
QAT_GRAD_REL_TOL = 0.1
# train_chunked vs the unfused criterion: the same bf16 logits reduced in
# fp32 in another order (chunk by chunk online)
CHUNKED_LOSS_RTOL = 1e-5

N_UPDATES = 5
TRAIN_LR = 1e-4
# One update's gradients (dropout 0) under the kernels vs the plain
# attention path differ by bf16 rounding carried through 12 layers forward
# and back (the flash route also rounds the bias and its gradient to bf16):
# the position leaves by up to 4e-2 even between the plain path with bf16
# and with fp32 scores. The worst leaf was the flash dd from the bf16
# output (0.148 on the long path, 0.261 at the image_infilling decoder's
# T = 1,032): the port takes it from B3's fp32 output (``out32``), which
# check_flash holds against the plain version's fp32 output. The
# key-side biases (k_proj, pos_k_linear, cross_pos_k_linear) shift every
# score of a softmax row alike: their gradient is 0 in exact arithmetic and
# rounding noise on both paths, so the per-leaf check leaves them out.
GRAD_REL_TOL = 5e-2
LEAF_REL_TOL = 0.25
# the relative-bias tables' gradient through BiasSpec's planned backward
# against autograd's own backward of the plain gather, both fp32 sums of the
# same terms in another order: largest error over the largest entry
GATHER_GRAD_RTOL = 1e-5
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")
# the plain path's score dtype (attn_logits) for the gradient comparison:
# both are computed and logged, the check reads GRAD_REF_LOGITS (fp32
# scores, as the kernels keep them)
GRAD_PLAIN_LOGITS = ("compute", "fp32")
GRAD_REF_LOGITS = "fp32"
# Kernel B6 vs its plain version (same inputs on the card): y (bf16) within
# one bf16 ulp, |y - ref| <= 2^-7 |ref| + 1e-3 (a reordered fp32 row sum can
# move the value before rounding across a rounding boundary); mu and rstd
# rtol 1e-5; dx (bf16) as GRAD_FROB_TOL / GRAD_MAX_TOL; dg and db, fp32 sums
# over up to 12,288 rows in another order, LN_SUM_TOL on both measures. A dg
# that skipped one row is off by about 1/sqrt(N) (Frobenius), 9e-3 at
# N = 12,288: the planted fault must fail LN_SUM_TOL.
LN_SUM_TOL = 1e-4
# serve_ln: first-step logits under B6 (fast-variance stats) vs the default
# LayerNorm (two-pass variance): both fp32 stats of the same bf16 inputs, so
# only single bf16 roundings differ, carried through 12 layers as in
# ENC_REL_TOL: relative Frobenius error <= LN_LOGIT_REL_TOL.
LN_LOGIT_REL_TOL = 2e-2


# every CUDA kernel of the port: the TPU kernel it replaces and its source
KERNELS = {
    "dense_attention_fwd": ("ofasys_tpu/ops/pallas_dense_attention.py:87",
                            "ofasys_torch/csrc/dense_attention_fwd.cu"),
    "dense_attention_bwd": ("ofasys_tpu/ops/pallas_dense_attention.py:180",
                            "ofasys_torch/csrc/dense_attention_bwd.cu"),
    "dense_attention_bwd_rowmajor": ("ofasys_tpu/ops/pallas_dense_attention.py:116",
                                     "ofasys_torch/csrc/dense_attention_bwd_rowmajor.cu"),
    "flash_attention_fwd": ("ofasys_tpu/ops/pallas_attention.py:58",
                            "ofasys_torch/csrc/flash_attention_fwd.cu"),
    "flash_attention_bwd": ("ofasys_tpu/ops/pallas_attention.py:341",
                            "ofasys_torch/csrc/flash_attention_bwd.cu"),
    "int8_matmul_fwd": ("ofasys_tpu/ops/pallas_int8.py:44", "ofasys_torch/csrc/int8_matmul.cu"),
    "layer_norm_fwd": ("ofasys_tpu/ops/pallas_layernorm.py:45", "ofasys_torch/csrc/layer_norm.cu"),
    "layer_norm_bwd": ("ofasys_tpu/ops/pallas_layernorm.py:59", "ofasys_torch/csrc/layer_norm.cu"),
}
# the three TPU kernels of the flash backward, each replaced by the one pass
# flash_attention_bwd: one row each in the kernels line, with the error of
# its part of the gradients
FLASH_BWD_ROWS = {
    "flash_attention_bwd_dq": ("ofasys_tpu/ops/pallas_attention.py:341", "err_dq"),
    "flash_attention_bwd_dkv": ("ofasys_tpu/ops/pallas_attention.py:404", "err_dkv"),
    "flash_attention_bwd_dbias": ("ofasys_tpu/ops/pallas_attention.py:466", "err_dbias"),
}
# the device kernels of B7 (csrc/int8_matmul.cu), by name in a profile
B7_KERNEL_NAMES = ("int8_mma_kernel", "int8_dp4a_kernel")
# the module of each kernel's wrapper, under ofasys_torch.ops
_WRAPPER_MODULE = {"dense": "dense_attention", "flash": "flash_attention", "int8": "int8_matmul",
                   "layer": "layer_norm"}


def log(msg: str):
    print(msg, flush=True)


def _wrappers():
    """Each kernel's wrapper, which counts its launches in ``.launches``."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"ofasys_torch.ops.{_WRAPPER_MODULE[name.split('_')[0]]}"), name) for name in KERNELS}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _route(cfg, B, Tq, Tk, dropout_rate=0.0):
    """Which attention the model runs on the card for a text-path call of
    this shape (a bias shared by the batch, a padding mask): 'flash'
    (B3-B5), 'dense' (B1/B2) or 'plain', by MultiheadAttention's own rule."""
    from ofasys_torch.model.transformer import attention_route

    H = cfg.encoder.attention_heads
    return attention_route(cfg, "cuda", B, Tq, Tk, H, cfg.encoder.embed_dim // H, dropout_rate,
                           bias_shape=(1, H, Tq, Tk), mask_shape=(B, 1, 1, Tk))


def time_ms(fn, n: int = 50, repeats: int = 3) -> float:
    """Median over ``repeats`` of the mean device time of ``n`` back-to-back
    calls. A GPU sleep first lets the host queue the calls ahead, so the
    events bracket device work and not Python launch overhead: twice the
    host time the n calls take to launch (from the warm-up's), at least
    1e6 and at most 5e7 cycles."""
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    launch_s = (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    cycles = int(min(5e7, max(1e6, 2 * n * launch_s * SLEEP_CYCLES_PER_S)))
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


# ------------------------------------------------------------------ phases
def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(f"nvidia-smi name, power.limit: {smi}")
    return name, smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ofasys_torch.ops import cuda_build, host_build

    names = sorted(p[:-3] for p in os.listdir(cuda_build.CSRC) if p.endswith(".cu"))
    host_names = sorted(p[:-4] for p in os.listdir(host_build.HOST_CSRC) if p.endswith(".cpp"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(host_build.build, host_names)
        reports = cuda_build.build(names)
        host.result()
    secs = time.perf_counter() - t0
    log(f"build: {names} in {secs:.2f} s; beside them the host libraries {host_names} with "
        f"{os.environ.get('CXX') or 'c++'}")
    spill = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
            # B6-bwd's row kernel holds the row and dg/db in registers: a
            # spill would put them in local memory
            m = spill.search(line)
            if "ln_bwd_rows_kernel" in entry and m and (int(m[1]) or int(m[2])):
                raise SystemExit(f"ptxas spills in {entry}: {line.strip()}")
    if "layer_norm" not in reports:
        log("  layer_norm was built before this run: no ptxas report, B6-bwd's spill gate "
            "did not run")
    return names


def _dense_inputs(B, Tq, Tk, H, D, seed, causal=False, fold=True):
    """bf16 q (pre-scaled by 0.125), k, v, do, a bf16 bias and an int8
    keep-mask. ``causal`` is folded into the bias as the public wrapper does
    it, or, with ``fold=False``, left to the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(B, Tq, H * D, device="cuda", generator=g) * 0.125).to(torch.bfloat16)
    k = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn(H, Tq, Tk, device="cuda", generator=g)
    if causal and fold:                       # folded into the bias, as the wrapper does
        cm = torch.ones(Tq, Tk, device="cuda").tril(Tk - Tq).bool()
        bias = torch.where(cm, bias, torch.full((), -1e9, device="cuda"))
    bias = bias.to(torch.bfloat16)
    keep = torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.2
    for b in range(1, B):                     # padding-style tails
        keep[b, :, max(1, Tk - 3 * b):] = False
    keep[:, :, 0] = True                      # no fully-masked query row
    do = torch.randn(B, Tq, H * D, device="cuda", generator=g).to(torch.bfloat16)
    return q, k, v, bias, keep.to(torch.int8), do


def _fwd_bound(B, Tq, Tk, H, D):
    """Bytes (q, k, v, bias, mask read once; out, lse written once) and
    FLOPs (q.k and p.v) of kernel B1."""
    n_bytes = 2 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + H * Tq * Tk) + B * Tk + 4 * B * H * Tq
    return n_bytes, 4 * B * H * Tq * Tk * D


def _bwd_bound(B, Tq, Tk, H, D, with_bias=True):
    """Bytes (q, k, v, do, lse, bias, mask read once; dq, dk, dv, dbias
    written once) and FLOPs (five (Tq, Tk, D) products per head: q.k, do.v,
    ds.k, ds.q, p.do; 10 B Tq Tk E) of kernel B2."""
    E = H * D
    n_bytes = 2 * (2 * B * Tq * E + 2 * B * Tk * E) + 2 * (B * Tq * E + 2 * B * Tk * E) \
        + 4 * B * H * Tq + B * Tk + (2 + 4) * H * Tq * Tk * with_bias
    return n_bytes, 10 * B * Tq * Tk * E


def _bound(n_bytes, ops, peak_ops=PEAK_BF16_FLOPS):
    """The least time in ms: the larger of the bytes over the memory rate
    and the operations over ``peak_ops``, and which of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa_args(q, k, v, bias, mask, H, D, grad=False):
    """The same function for one library call: (B, H, T, D) views and an
    additive bias with the mask folded in as -1e9."""
    add = (bias[None].float() + torch.where(mask[:, :, None, :] != 0, 0.0, -1e9)).to(torch.bfloat16)
    q4, k4, v4 = (t.view(t.shape[0], t.shape[1], H, D).transpose(1, 2) for t in (q, k, v))
    if grad:
        q4, k4, v4, add = (t.detach().clone().requires_grad_() for t in (q4, k4, v4, add))
    return q4, k4, v4, add


def check_fwd(label, shape, causal=False):
    """Kernel B1 against its plain version at one shape, with its times."""
    import torch.nn.functional as F

    from ofasys_torch.ops.dense_attention import dense_attention_fwd, dense_attention_fwd_reference

    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, _ = _dense_inputs(B, Tq, Tk, H, D, SEED, causal)
    out, lse = dense_attention_fwd(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    ref, ref_lse = dense_attention_fwd_reference(q, k, v, bias, mask, H)
    err_out = (out.float() - ref.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err_out <= OUT_ATOL and err_lse <= LSE_ATOL
    log(f"kernel dense_attention_fwd [{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}]: "
        f"max|out-plain|={err_out:.3e} (atol {OUT_ATOL}) max|lse-plain|={err_lse:.3e} "
        f"(atol {LSE_ATOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dense_attention_fwd disagrees with its plain version at {label}")
    q4, k4, v4, add = _sdpa_args(q, k, v, bias, mask, H, D)
    kernel_ms = time_ms(lambda: dense_attention_fwd(q, k, v, bias, mask, H))
    plain_ms = time_ms(lambda: dense_attention_fwd_reference(q, k, v, bias, mask, H), **PLAIN_TIMING)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=1.0))
    n_bytes, flops = _fwd_bound(B, Tq, Tk, H, D)
    bound_ms, bound_by = _bound(n_bytes, flops)
    log(f"  times [{label}]: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (scaled_dot_product_attention) {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({n_bytes} B, {flops} FLOP)")
    return dict(shape=label, B=B, Tq=Tq, Tk=Tk, err_out=err_out, err_lse=err_lse,
                kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _sdpa_bwd_ms(q4, k4, v4, add, do4):
    """The library yardstick of B2: autograd through scaled_dot_product_attention
    with a float mask that requires grad (the memory-efficient backend's
    backward with a bias gradient), minus its forward."""
    import torch.nn.functional as F

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=1.0)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q4, k4, v4, add), do4)

    try:
        both = time_ms(fwd_bwd, n=20)
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library backward not timed: {str(e).splitlines()[0][:120]}")
        return None
    with torch.no_grad():
        return both - time_ms(fwd, n=20)


def check_bwd(label, shape, causal=False):
    """Kernels B2 and B2r against their plain version at one shape as the
    model's path gives it (scale 1, causal folded into the bias), with their
    times side by side. Returns (B2's row, B2r's row)."""
    from ofasys_torch.ops.dense_attention import (
        dense_attention_bwd,
        dense_attention_bwd_reference,
        dense_attention_bwd_rowmajor,
        dense_attention_fwd,
    )

    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, do = _dense_inputs(B, Tq, Tk, H, D, SEED, causal)
    _, lse = dense_attention_fwd(q, k, v, bias, mask, H)
    kernels = {
        "dense_attention_bwd": lambda: dense_attention_bwd(q, k, v, do, lse, bias, mask, H),
        "dense_attention_bwd_rowmajor": lambda: dense_attention_bwd_rowmajor(
            q, k, v, do, lse, bias, mask, H, 1.0, False),
    }
    ref = dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H)
    errs = {}
    for name, fn in kernels.items():
        got = fn()
        torch.cuda.synchronize()
        errs[name], ok = grad_errors(got, ref, False)
        same = all(torch.equal(a, b) for a, b in zip(got, fn()))
        log(f"kernel {name} [{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}]: "
            f"{_grad_report(errs[name])}, the same bits twice: {same} -> "
            f"{'ok' if ok and same else 'FAIL'}")
        if not ok or not same:
            raise SystemExit(f"{name} disagrees with its plain version at {label}")
    # planted fault: each kernel with one key tile's p and dS left out
    # (those keys masked, the lse of the full forward kept) must fail the
    # limits on dq, dk, dv and dbias
    lo, hi = min(64, Tk // 2), min(128, Tk)
    hidden = mask.clone()
    hidden[:, :, lo:hi] = 0
    for name, fn in (("B2", dense_attention_bwd), ("B2r", dense_attention_bwd_rowmajor)):
        extra = () if name == "B2" else (1.0, False)
        ferrs, _ = grad_errors(fn(q, k, v, do, lse, bias, hidden, H, *extra), ref, False)
        caught = [n for n, e in ferrs.items() if not e["ok"]]
        log(f"  planted fault {name} with keys {lo}-{hi - 1} left out: "
            + " ".join(f"{n} frob {e['frob']:.2e} max {e['max_rel']:.2e}" for n, e in ferrs.items())
            + f" -> fails the limits for {caught} of {list(ferrs)}")
        if caught != list(ferrs):
            raise SystemExit(f"{label}: the gradient limits pass {name} with a key tile left out")
    q4, k4, v4, add = _sdpa_args(q, k, v, bias, mask, H, D, grad=True)
    do4 = do.view(B, Tq, H, D).transpose(1, 2)
    kernel_ms = {name: time_ms(fn, n=20) for name, fn in kernels.items()}
    plain_ms = time_ms(lambda: dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H),
                       **PLAIN_TIMING)
    library_ms = _sdpa_bwd_ms(q4, k4, v4, add, do4)
    n_bytes, flops = _bwd_bound(B, Tq, Tk, H, D)
    bound_ms, bound_by = _bound(n_bytes, flops)
    lib = "not timed" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  times [{label}]: B2 {kernel_ms['dense_attention_bwd']:.4f} ms, B2r "
        f"{kernel_ms['dense_attention_bwd_rowmajor']:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (scaled_dot_product_attention backward) {lib}, bound {bound_ms:.5f} ms "
        f"({n_bytes} B, {flops} FLOP)")
    return tuple(dict(shape=label, B=B, Tq=Tq, Tk=Tk, err=max(e["max"] for e in errs[name].values()),
                      errs={n: e["max"] for n, e in errs[name].items()},
                      kernel_ms=kernel_ms[name], plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound_ms, bound_by=bound_by) for name in kernels)


def check_inside(label, shape):
    """Kernels B1, B2r and B2 with the scale inside, and B1 and B2r with the
    causal mask inside too (``j <= i + Tk - Tq``), as a direct
    ``_dense_attention(q, k, v, bias, mask, scale, True, H)`` call runs them:
    q unscaled, the bias without the causal fold. Each against its plain
    version, and the causal pair timed beside the folded form of the same
    function. Two planted faults must fail the limits: the causal offset
    dropped (keys ``j <= i`` visible instead), and the scale left out of dq.
    Returns (B1's row, B2r's row)."""
    from ofasys_torch.ops import dense_attention as da

    B, Tq, Tk, H, D = shape
    scale = INSIDE_SCALE
    q, k, v, bias, mask, do = _dense_inputs(B, Tq, Tk, H, D, SEED + 4, causal=True, fold=False)
    q_raw = (q.float() / scale).to(torch.bfloat16)        # exact: a power of two
    tag = f"[{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D} scale={scale} causal inside]"
    out, lse = da.dense_attention_fwd(q_raw, k, v, bias, mask, H, scale, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = da.dense_attention_fwd_reference(q_raw, k, v, bias, mask, H, scale, True)
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err_out <= OUT_ATOL and err_lse <= LSE_ATOL
    log(f"kernel dense_attention_fwd {tag}: max|out-plain|={err_out:.3e} (atol {OUT_ATOL}) "
        f"max|lse-plain|={err_lse:.3e} (atol {LSE_ATOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dense_attention_fwd with scale and causal inside disagrees at {label}")
    got = da.dense_attention_bwd_rowmajor(q_raw, k, v, do, lse, bias, mask, H, scale, True)
    torch.cuda.synchronize()
    ref = da.dense_attention_bwd_rowmajor_reference(q_raw, k, v, do, lse, bias, mask, H, scale, True)
    errs, ok = grad_errors(got, ref, False)
    log(f"kernel dense_attention_bwd_rowmajor {tag}: {_grad_report(errs)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dense_attention_bwd_rowmajor with scale and causal inside disagrees at {label}")
    again = da.dense_attention_bwd_rowmajor(q_raw, k, v, do, lse, bias, mask, H, scale, True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"dense_attention_bwd_rowmajor: two runs differ at {label}")
    # the entry itself: autograd through _dense_attention(causal=True) runs B1
    # and B2r (not B2) and hands back the same gradients, dbias in the bias's bf16
    leaves = [t.clone().requires_grad_() for t in (q_raw, k, v, bias)]
    before = da.dense_attention_bwd.launches, da.dense_attention_bwd_rowmajor.launches
    da._dense_attention(*leaves[:3], leaves[3], mask, scale, True, H).backward(do)
    torch.cuda.synchronize()
    ran = (da.dense_attention_bwd.launches - before[0],
           da.dense_attention_bwd_rowmajor.launches - before[1])
    same = all(torch.equal(t.grad, g.to(t.dtype)) for t, g in zip(leaves, got))
    log(f"  _dense_attention(scale={scale}, causal=True) {tag}: backward launches (B2, B2r) {ran}, "
        f"gradients equal to the direct B2r call: {same}")
    if ran != (0, 1) or not same:
        raise SystemExit(f"_dense_attention(causal=True) did not take B2r at {label}")

    # the scale inside B2 and B2r without causal (a non-causal _dense_attention call)
    _, lse_nc = da.dense_attention_fwd(q_raw, k, v, bias, mask, H, scale)
    ref_nc = da.dense_attention_bwd_reference(q_raw, k, v, do, lse_nc, bias, mask, H, scale=scale)
    for name, g in (("dense_attention_bwd", da.dense_attention_bwd(
            q_raw, k, v, do, lse_nc, bias, mask, H, scale=scale)),
                    ("dense_attention_bwd_rowmajor", da.dense_attention_bwd_rowmajor(
                        q_raw, k, v, do, lse_nc, bias, mask, H, scale, False))):
        e, ok = grad_errors(g, ref_nc, False)
        log(f"kernel {name} [{label} scale={scale} inside, not causal]: {_grad_report(e)} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} with the scale inside disagrees with its plain version at {label}")

    # planted faults: the same kernel on wrong inputs must fail the limits
    wrong = torch.ones(Tq, Tk, device="cuda").tril().bool()          # j <= i: the offset dropped
    folded = torch.where(wrong, bias.float(), torch.full((), -1e9, device="cuda")).to(torch.bfloat16)
    faults = {}
    if Tk != Tq:
        _, lse_w = da.dense_attention_fwd(q_raw, k, v, folded, mask, H, scale)
        faults["causal offset dropped"] = (
            da.dense_attention_bwd_rowmajor(q_raw, k, v, do, lse_w, folded, mask, H, scale, False),
            ("dq", "dk", "dv", "dbias"))
    # a pre-scaled q with scale 1 gives the same scores and the dq of a
    # kernel that forgot the scale: round(ds) k instead of round(ds * scale) k
    faults["scale left out of dq"] = (
        da.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, 1.0, True), ("dq",))
    for fault, (fgot, moved) in faults.items():
        ferrs, _ = grad_errors(fgot, ref, False)
        caught = [n for n in moved if not ferrs[n]["ok"]]
        log(f"  planted fault {fault}: "
            + " ".join(f"{n} frob {ferrs[n]['frob']:.2e} max {ferrs[n]['max_rel']:.2e}" for n in moved)
            + f" -> fails the limits for {caught} of {list(moved)}")
        if caught != list(moved):
            raise SystemExit(f"{label}: the gradient limits pass a kernel with {fault}")

    # times: inside (tiles above the diagonal skipped) beside the folded form
    fb = torch.where(torch.ones(Tq, Tk, device="cuda").tril(Tk - Tq).bool(), bias.float(),
                     torch.full((), -1e9, device="cuda")).to(torch.bfloat16)
    _, lse_f = da.dense_attention_fwd(q, k, v, fb, mask, H)
    fwd_ms = time_ms(lambda: da.dense_attention_fwd(q_raw, k, v, bias, mask, H, scale, True))
    fwd_folded_ms = time_ms(lambda: da.dense_attention_fwd(q, k, v, fb, mask, H))
    fwd_plain_ms = time_ms(lambda: da.dense_attention_fwd_reference(q_raw, k, v, bias, mask, H, scale, True),
                           **PLAIN_TIMING)
    bwd_ms = time_ms(lambda: da.dense_attention_bwd_rowmajor(
        q_raw, k, v, do, lse, bias, mask, H, scale, True), n=20)
    bwd_folded_ms = time_ms(lambda: da.dense_attention_bwd_rowmajor(
        q, k, v, do, lse_f, fb, mask, H, 1.0, False), n=20)
    b2_folded_ms = time_ms(lambda: da.dense_attention_bwd(q, k, v, do, lse_f, fb, mask, H), n=20)
    bwd_plain_ms = time_ms(lambda: da.dense_attention_bwd_rowmajor_reference(
        q_raw, k, v, do, lse, bias, mask, H, scale, True), **PLAIN_TIMING)
    import torch.nn.functional as F

    q4, k4, v4, add = _sdpa_args(q, k, v, fb, mask, H, D, grad=True)
    with torch.no_grad():
        fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=1.0))
    bwd_lib_ms = _sdpa_bwd_ms(q4, k4, v4, add, do.view(B, Tq, H, D).transpose(1, 2))
    fb_ms, fb_by = _bound(*_fwd_bound(B, Tq, Tk, H, D))
    bb_ms, bb_by = _bound(*_bwd_bound(B, Tq, Tk, H, D))
    lib = "not timed" if bwd_lib_ms is None else f"{bwd_lib_ms:.4f} ms"
    log(f"  times {tag}: B1 {fwd_ms:.4f} ms (causal folded into the bias {fwd_folded_ms:.4f}, plain "
        f"{fwd_plain_ms:.4f}, library {fwd_lib_ms:.4f}, bound {fb_ms:.5f}); B2r {bwd_ms:.4f} ms "
        f"(folded {bwd_folded_ms:.4f}, B2 folded {b2_folded_ms:.4f}, plain {bwd_plain_ms:.4f}, "
        f"library {lib}, bound {bb_ms:.5f})")
    common = dict(shape=label, B=B, Tq=Tq, Tk=Tk, scale=scale, causal_inside=True)
    return (dict(common, err_out=err_out, err_lse=err_lse, kernel_ms=fwd_ms, folded_ms=fwd_folded_ms,
                 plain_ms=fwd_plain_ms, library_ms=fwd_lib_ms, bound_ms=fb_ms, bound_by=fb_by),
            dict(common, err=max(e["max"] for e in errs.values()),
                 errs={n: e["max"] for n, e in errs.items()}, kernel_ms=bwd_ms,
                 folded_ms=bwd_folded_ms, b2_folded_ms=b2_folded_ms, plain_ms=bwd_plain_ms,
                 library_ms=bwd_lib_ms, bound_ms=bb_ms, bound_by=bb_by))


def phase_kernels(dispatch_shapes, train_shapes, serve_calls=()):
    """Kernel B1 at the serving paths' encoder shapes (``dispatch_shapes``:
    [(label, (B, T))], one per planned dispatch), at ``serve_calls`` ([(label,
    (B, Tq, Tk), causal)]: serve_motion's denoiser attentions, the decoder
    attentions of evaluate's candidate passes), the nominal serving
    shape B=8 T=128 and every training shape; kernels B2 and B2r at every
    training shape (B2 also the same bits twice, and with a key tile left out, which
    the limits must catch); all three at EDGE_SHAPES; B1 and B2r with the
    scale and the causal mask inside at INSIDE_SHAPES. The paths' shapes are
    at the base arch, H=12, D=64. ``train_shapes`` is [(label, (B, Tq, Tk),
    causal)]. Returns the rows of B1, B2 and B2r."""
    fwd, bwd, row = [], [], []
    for label, (B, T) in dispatch_shapes:
        fwd.append(check_fwd(label, (B, T, T, 12, 64)))
    for label, (B, Tq, Tk), causal in serve_calls:
        fwd.append(check_fwd(label, (B, Tq, Tk, 12, 64), causal))
    fwd.append(check_fwd("serving", (8, 128, 128, 12, 64)))
    calls = [(label, (B, Tq, Tk, 12, 64), causal) for label, (B, Tq, Tk), causal in train_shapes]
    for label, shape, causal in calls + EDGE_SHAPES:
        fwd.append(check_fwd(label, shape, causal))
        b2, b2r = check_bwd(label, shape, causal)
        bwd.append(b2)
        row.append(b2r)
    for label, (B, Tq, Tk) in INSIDE_SHAPES:
        f, r = check_inside(label, (B, Tq, Tk, 12, 64))
        fwd.append(f)
        row.append(r)
    return fwd, bwd, row


def _flash_inputs(B, Tq, Tk, H, D, seed, per_bh=False):
    """bf16 q, k, v, do (B, T, H*D) as the projections give them, a bias
    (H, Tq, Tk) shared by the batch or (B*H, Tq, Tk), and an int8 keep-mask
    (B, 1, Tk) with padding-style tails that keeps key 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H * D, device="cuda", generator=g).to(torch.bfloat16)
                   for T in (Tq, Tk, Tk, Tq))
    bias = torch.randn(B * H if per_bh else H, Tq, Tk, device="cuda", generator=g).to(torch.bfloat16)
    keep = torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.2
    for b in range(1, B):
        keep[b, :, max(1, Tk - 7 * b):] = False
    keep[:, :, 0] = True
    return q, k, v, bias, keep.to(torch.int8), do


def _flash_bounds(B, Tq, Tk, H, D, nb, causal, out32=False):
    """(bytes, FLOP) of kernel B3 and of the whole backward (the one pass of
    B4-dq, B4-dkv and B5) at one shape: each input read once, each output
    written once (the bias gradient in full: (H, Tq, Tk) for a shared bias,
    ds (B H, Tq, Tk) for one per (b, h); with ``out32`` B3's fp32 copy of
    its output too); FLOP 2 B H Tq Tk D for each (Tq, Tk, D) product the
    function needs: B3 two (q.k, p.v), the backward five (q.k, do.v, p.do,
    ds.q, ds.k). Causal skips the tiles above the diagonal: half the FLOP
    and half the bias read."""
    E = H * D
    frac = 0.5 if causal else 1.0
    bias = int(2 * nb * Tq * Tk * frac)
    qkv = 2 * (B * Tq * E + 2 * B * Tk * E)
    core = B * H * Tq * Tk * D * frac
    reads = qkv + 2 * B * Tq * E + 8 * B * H * Tq + bias + B * Tk      # q, k, v, do, lse, dd
    writes = 2 * (B * Tq * E + 2 * B * Tk * E) + 4 * nb * Tq * Tk      # dq, dk, dv, bias gradient
    return {
        "flash_attention_fwd": (qkv + bias + B * Tk + (6 if out32 else 2) * B * Tq * E + 4 * B * H * Tq,
                                int(4 * core)),
        "flash_attention_bwd": (reads + writes, int(10 * core)),
    }


def _flash_sdpa(q, k, v, bias, mask, H, D, causal, grad=False):
    """The same function for one library call: (B, H, T, D) views and an
    additive bf16 mask = bias + (-1e9 on masked keys and above the causal
    diagonal). With ``grad`` the bias is a (1|B, H, Tq, Tk) leaf that needs
    its gradient and the sum is taken inside the timed call."""
    B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
    neg = torch.where(mask[:, :, None, :] != 0, 0.0, -1e9)
    if causal:
        neg = neg + torch.where(torch.ones(Tq, Tk, device="cuda").tril().bool(), 0.0, -1e9)
    neg = neg.to(torch.bfloat16)
    b4 = bias.view(-1, H, Tq, Tk)
    q4, k4, v4 = (t.view(B, t.shape[1], H, D).transpose(1, 2) for t in (q, k, v))
    if grad:
        q4, k4, v4, b4 = (t.detach().clone().requires_grad_() for t in (q4, k4, v4, b4))
        return q4, k4, v4, b4, neg
    return q4, k4, v4, (b4 + neg).to(torch.bfloat16)


def _flash_sdpa_bwd_ms(q4, k4, v4, b4, neg, do4, scale):
    """The library yardstick of B4 + B5: autograd through
    scaled_dot_product_attention with the bias needing its gradient, minus
    the forward."""
    import torch.nn.functional as F

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=b4 + neg, scale=scale)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q4, k4, v4, b4), do4)

    try:
        both = time_ms(fwd_bwd, **FLASH_TIMING)
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library backward not timed: {str(e).splitlines()[0][:120]}")
        return None
    with torch.no_grad():
        return both - time_ms(fwd, **FLASH_TIMING)


def grad_errors(got, ref, per_bh):
    """dq, dk, dv and the bias gradient (ds for a per-(b, h) bias) against
    the plain version's: max abs error, that over max|ref|, the relative
    Frobenius error, the reference's largest entry and rms, and whether
    the error is within the limits. Returns ({name: errors}, all ok)."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv", "ds" if per_bh else "dbias"), got, ref):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        ref_max, ref_norm = b.abs().max().item(), b.norm().item()
        frob = (a - b).norm().item() / ref_norm
        tol_frob, tol_max = (GRAD_FROB_TOL, GRAD_MAX_TOL) if name in ("dq", "dk", "dv") \
            else (DS_REL_ATOL, DS_REL_ATOL)
        out[name] = dict(max=err, max_rel=err / ref_max, frob=frob, ref_max=ref_max,
                         ref_rms=ref_norm / b.numel() ** 0.5,
                         ok=bool(torch.isfinite(a).all()) and frob <= tol_frob
                         and err <= tol_max * ref_max)
    return out, all(e["ok"] for e in out.values())


def _grad_report(errs):
    return " ".join(f"{n}: max {e['max']:.3e} ({e['max_rel']:.2e} of max|plain| {e['ref_max']:.3e}, "
                    f"rms {e['ref_rms']:.3e}) frob {e['frob']:.2e}" for n, e in errs.items()) \
        + f" (dq/dk/dv limits frob {GRAD_FROB_TOL}, max {GRAD_MAX_TOL}; dbias/ds {DS_REL_ATOL})"


def check_flash(label, shape, causal=False, per_bh=False, backward=True, plant_faults=False):
    """Kernel B3 and, with ``backward``, the one backward pass (dq, dk, dv
    and the bias gradient: B4-dq, B4-dkv and B5, or ds for a per-(b, h)
    bias) against their plain versions at one shape, each run twice for
    equal bits, with their times; with ``plant_faults`` also shows that the
    gradient limits fail the pass run on wrong inputs. With ``backward`` B3
    runs as FlashAttentionFunction launches it on a training path: it also
    writes its fp32 output (``out32``, the backward's dd), held against the
    plain version's fp32 output, timed and counted in the bound with it
    (and timed without it, as serving launches it). Returns one row per
    kernel."""
    import torch.nn.functional as F

    from ofasys_torch.ops import flash_attention as fl

    B, Tq, Tk, H, D = shape
    scale = (2 * D) ** -0.5                   # the model's (head_dim * attn_scale_factor) ** -0.5
    q, k, v, bias, mask, do = _flash_inputs(B, Tq, Tk, H, D, SEED, per_bh)
    nb = bias.shape[0]
    tag = f"[{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}{' causal' if causal else ''}" \
          f"{' per-(b,h) bias' if per_bh else ''}]"

    def fp32_out():
        return torch.empty(q.shape, dtype=torch.float32, device="cuda") if backward else None

    out32, ref32 = fp32_out(), fp32_out()
    out, lse = fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal, out32)
    torch.cuda.synchronize()
    ref, ref_lse = fl.flash_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal, ref32)
    err_out = (out.float() - ref.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err_out <= OUT_ATOL and err_lse <= LSE_ATOL
    again32 = fp32_out()
    again = fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal, again32)
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    msg32 = ""
    if backward:
        # the fp32 output: within OUT_ATOL of the plain version's, and out
        # is exactly its rounding to bf16
        err_out32 = (out32 - ref32).abs().max().item()
        rounded = torch.equal(out32.to(out.dtype), out)
        ok = ok and bool(torch.isfinite(out32).all()) and err_out32 <= OUT_ATOL and rounded
        same = same and torch.equal(out32, again32)
        msg32 = f" max|out32-plain fp32|={err_out32:.3e} (atol {OUT_ATOL}), out = out32 in bf16: {rounded}"
    log(f"kernel flash_attention_fwd {tag}: max|out-plain|={err_out:.3e} (atol {OUT_ATOL}) "
        f"max|lse-plain|={err_lse:.3e} (atol {LSE_ATOL}){msg32}, the same bits twice: {same} "
        f"-> {'ok' if ok and same else 'FAIL'}")
    if not ok or not same:
        raise SystemExit(f"flash_attention_fwd disagrees with its plain version at {label}")
    # planted fault: the kernel with keys 64-127 left out (a skipped key
    # tile) must fail the out or the lse limit, and the out32 limit
    hidden = mask.clone()
    hidden[:, :, 64:128] = 0
    f_out32 = fp32_out()
    f_out, f_lse = fl.flash_attention_fwd(q, k, v, bias, hidden, H, scale, causal, f_out32)
    f_err_out = (f_out.float() - ref.float()).abs().max().item()
    f_err_lse = (f_lse - ref_lse).abs().max().item()
    caught = f_err_out > OUT_ATOL or f_err_lse > LSE_ATOL
    msg32 = ""
    if backward:
        f_err_out32 = (f_out32 - ref32).abs().max().item()
        caught = caught and f_err_out32 > OUT_ATOL
        msg32 = f" max|out32-plain fp32|={f_err_out32:.3e}"
    log(f"  planted fault keys 64-127 left out: max|out-plain|={f_err_out:.3e} "
        f"max|lse-plain|={f_err_lse:.3e}{msg32} -> {'fails the limits' if caught else 'PASSES the limits'}")
    if not caught:
        raise SystemExit(f"{label}: the out/lse limits pass B3 with a key tile left out")
    del again, again32, hidden, f_out, f_lse, f_out32
    bounds = _flash_bounds(B, Tq, Tk, H, D, nb, causal, out32=backward)
    rows = {}

    def row(name, err, kernel_ms, plain_ms, library_ms):
        bound_ms, bound_by = _bound(*bounds[name])
        rows[name] = dict(shape=label, B=B, Tq=Tq, Tk=Tk, causal=causal, per_bh=per_bh, err=err,
                          kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        lib = "not timed" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  times {name} {tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib}, bound {bound_ms:.5f} ms ({bound_by}; {bounds[name][0]} B, {bounds[name][1]} FLOP)")

    q4, k4, v4, add = _flash_sdpa(q, k, v, bias, mask, H, D, causal)
    row("flash_attention_fwd", max(err_out, err_out32) if backward else err_out,
        time_ms(lambda: fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal, out32),
                **FLASH_TIMING),
        time_ms(lambda: fl.flash_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal, ref32),
                **FLASH_TIMING),
        time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=scale),
                **FLASH_TIMING))
    rows["flash_attention_fwd"]["err_lse"] = err_lse
    if backward:
        # the same kernel without the fp32 write, as serving launches it
        rows["flash_attention_fwd"].update(
            out32=True, err_out32=err_out32,
            kernel_ms_without_out32=time_ms(
                lambda: fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal), **FLASH_TIMING),
            bound_ms_without_out32=_bound(*_flash_bounds(B, Tq, Tk, H, D, nb, causal)["flash_attention_fwd"])[0])
        log(f"  times flash_attention_fwd {tag} without out32: kernel "
            f"{rows['flash_attention_fwd']['kernel_ms_without_out32']:.4f} ms, bound "
            f"{rows['flash_attention_fwd']['bound_ms_without_out32']:.5f} ms")
    del q4, k4, v4, add
    if not backward:
        return rows

    # dd as FlashAttentionFunction forms it, from the fp32 output
    dd = (do.float() * out32).reshape(B, Tq, H, D).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dd, bias, mask, H, scale, causal)
    ref_grads = fl.flash_attention_bwd_reference(*args)
    plan = fl.backward_plan(B, H, Tq, Tk, D, nb != B * H,
                            torch.cuda.get_device_properties(0).multi_processor_count,
                            fl.SCRATCH_CAP)
    got = fl.flash_attention_bwd(*args)
    errs, ok = grad_errors(got, ref_grads, per_bh)
    again = fl.flash_attention_bwd(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # each part wrapper returns its part of the one pass
    dq1, ds1 = fl.flash_attention_bwd_dq(*args, want_ds=nb == B * H)
    parts = [torch.equal(dq1, got[0]), *(torch.equal(a, b) for a, b in
                                        zip(fl.flash_attention_bwd_dkv(*args), got[1:3]))]
    parts.append(torch.equal(ds1 if nb == B * H else fl.flash_attention_bwd_dbias(*args), got[3]))
    log(f"kernel flash_attention_bwd {tag}: {_grad_report(errs)}; plan {plan._asdict()} "
        f"(scratch {4 * (plan.dq_scratch + plan.dbias_scratch) / 2 ** 20:.1f} MiB); the same "
        f"bits twice: {same}; the part wrappers give its parts: {all(parts)} "
        f"-> {'ok' if ok and same and all(parts) else 'FAIL'}")
    if not ok or not same or not all(parts):
        raise SystemExit(f"the flash backward disagrees with its plain version at {label}")
    del again, dq1, ds1
    if plant_faults:
        # the same kernel on wrong inputs must fail the same limits: dd
        # zeroed (a kernel that dropped it) moves dq, dk and the bias
        # gradient; keys 64-127 masked (a kernel that skipped that key
        # tile) moves all four
        hidden = mask.clone()
        hidden[:, :, 64:128] = 0
        faults = {"dd=0": ((q, k, v, do, lse, torch.zeros_like(dd), bias, mask, H, scale, causal),
                           ("dq", "dk", "ds" if per_bh else "dbias")),
                  "key tile 64-127 skipped": ((q, k, v, do, lse, dd, bias, hidden, H, scale, causal),
                                              tuple(errs))}
        for fault, (fargs, moved) in faults.items():
            ferrs, _ = grad_errors(fl.flash_attention_bwd(*fargs), ref_grads, per_bh)
            caught = [n for n in moved if not ferrs[n]["ok"]]
            log(f"  planted fault {fault}: "
                + " ".join(f"{n} frob {ferrs[n]['frob']:.2e} max {ferrs[n]['max_rel']:.2e}"
                           for n in moved)
                + f" -> fails the limits for {caught} of {list(moved)}")
            if caught != list(moved):
                raise SystemExit(f"{label}: the gradient limits pass a kernel with {fault}")
        del hidden
    plain_ms = time_ms(lambda: fl.flash_attention_bwd_reference(*args), **FLASH_TIMING)
    q4, k4, v4, b4, neg = _flash_sdpa(q, k, v, bias, mask, H, D, causal, grad=True)
    library_ms = _flash_sdpa_bwd_ms(q4, k4, v4, b4, neg, do.view(B, Tq, H, D).transpose(1, 2), scale)
    del q4, k4, v4, b4, neg
    row("flash_attention_bwd", max(e["max"] for e in errs.values()),
        time_ms(lambda: fl.flash_attention_bwd(*args), **FLASH_TIMING), plain_ms, library_ms)
    bias_err = errs["ds" if per_bh else "dbias"]["max"]
    rows["flash_attention_bwd"].update(
        err_dq=max(errs["dq"]["max"], bias_err if nb == B * H else 0.0),
        err_dkv=max(errs["dk"]["max"], errs["dv"]["max"]), err_dbias=bias_err, plan=plan._asdict())
    return rows


def flash_bwd_breakdown(label, shape):
    """Where the one flash backward pass spends its time at one shape, for
    PERF.md (no check): with no bias, a bias that needs no gradient, a
    per-(b, h) bias (ds written) and a shared one (its chunk partials read,
    added and written back per sample); the shared case with one chunk and
    with twice the plan's; and the pass's kernels by device time
    (torch.profiler, per call)."""
    from torch.profiler import ProfilerActivity, profile

    from ofasys_torch.ops import flash_attention as fl

    B, Tq, Tk, H, D = shape
    scale = (2 * D) ** -0.5
    res = {}
    for kind in ("no_bias", "bias_without_gradient", "per_bh_ds", "shared_dbias"):
        q, k, v, bias, mask, do = _flash_inputs(B, Tq, Tk, H, D, SEED, kind == "per_bh_ds")
        bias = None if kind == "no_bias" else bias
        out, lse = fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, False)
        dd = (do.float() * out.float()).reshape(B, Tq, H, D).sum(-1).permute(0, 2, 1).contiguous()
        args = (q, k, v, do, lse, dd, bias, mask, H, scale, False)
        want = kind != "bias_without_gradient"
        res[kind] = time_ms(lambda: fl.flash_attention_bwd(*args, want_dbias=want), **FLASH_TIMING)
    plan = fl.backward_plan(B, H, Tq, Tk, D, True,
                            torch.cuda.get_device_properties(0).multi_processor_count,
                            fl.SCRATCH_CAP)
    orig = fl.backward_plan
    for chunks in (1, 2 * plan.chunks):
        alt = plan._replace(chunks=chunks, dbias_scratch=chunks * H * Tq * Tk if chunks > 1 else 0)
        fl.backward_plan = lambda *a, _alt=alt, **kw: _alt
        try:
            res[f"shared_dbias_chunks_{chunks}"] = time_ms(lambda: fl.flash_attention_bwd(*args),
                                                           **FLASH_TIMING)
        finally:
            fl.backward_plan = orig
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fl.flash_attention_bwd(*args)
        torch.cuda.synchronize()
    res["kernels_ms"] = {e.key.split("(")[0][:60]: e.device_time_total / 1e3 / 5
                         for e in prof.key_averages() if e.device_time_total > 0}
    log(f"  flash_attention_bwd breakdown [{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}, plan chunks "
        f"{plan.chunks}]: " + ", ".join(f"{n} {v:.4f} ms" for n, v in res.items() if n != "kernels_ms")
        + "; by kernel " + ", ".join(f"{n} {v:.4f} ms" for n, v in res["kernels_ms"].items()))
    return res


def phase_flash_kernels(serve_shapes, train_shapes):
    """Kernel B3 at every serving shape of the long paths (``serve_shapes``:
    [(label, (B, T))]); B3 and the one backward pass at every flash call of
    the long training update (``train_shapes``: [(label, (B, Tq, Tk),
    causal)]), at a per-(b, h) bias (ds) and at a ragged shape whose keys
    are not a multiple of the 64-key tile, all at the base arch's H=12,
    D=64, and at FLASH_EDGE_SHAPES; both planted faults at each of those;
    the backward's breakdown (flash_bwd_breakdown) at the largest training
    call. Returns {kernel name: [rows]}."""
    rows = {name: [] for name in KERNELS if name.startswith("flash")}

    def add(r):
        for name, v in r.items():
            rows[name].append(v)

    for label, (B, T) in serve_shapes:
        add(check_flash(label, (B, T, T, 12, 64), backward=False))
    extra = [("per_bh_causal", (2, 300, 300), True, True), ("ragged", (2, 300, 333), False, False)]
    for label, (B, Tq, Tk), causal, per_bh in [s + (False,) for s in train_shapes] + extra:
        add(check_flash(label, (B, Tq, Tk, 12, 64), causal, per_bh, plant_faults=True))
    for label, shape, causal in FLASH_EDGE_SHAPES:
        add(check_flash(label, shape, causal, plant_faults=True))
    # the breakdown at the largest training call
    label, (B, Tq, Tk), _ = max(train_shapes, key=lambda c: c[1][0] * c[1][1] * c[1][2])
    row = next(r for r in rows["flash_attention_bwd"] if r["shape"] == label)
    row["breakdown"] = flash_bwd_breakdown(label, (B, Tq, Tk, 12, 64))
    return rows


def _int_mm_ms(xq, sx, q, scale):
    """The library yardstick of B7: ``torch._int_mm`` (cuBLASLt int8, int32
    out) plus the same epilogue. Its shape rules want M > 16 and K and N
    multiples of 8, so a product outside them is timed zero-padded to the
    least work it accepts for the same function: rows to M = 32, K to a
    multiple of 16 (zero columns of xq against zero columns of q add 0), N
    to a multiple of 8 (outputs past N sliced off)."""
    M, K = xq.shape
    N = q.shape[0]
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros(32 - M, K)])
        sx = torch.cat([sx, sx.new_zeros(32 - M, 1)])
    if K % 8 or N % 8:
        Kp, Np = -(-K // 16) * 16, -(-N // 8) * 8
        xq = torch.nn.functional.pad(xq, (0, Kp - K))
        q = torch.nn.functional.pad(q, (0, Kp - K, 0, Np - N))
        scale = torch.nn.functional.pad(scale, (0, Np - N))
    qt = q.t()
    try:
        return time_ms(lambda: ((torch._int_mm(xq, qt).float() * sx) * scale)[:, :N].to(torch.bfloat16))
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library int8 product not timed: {str(e).splitlines()[0][:120]}")
        return None


def check_int8(label, M, K, N):
    """Kernel B7 against its plain version at one (M, K, N), bit for bit,
    with its plan (``int8_plan``: kernel, tile, K split) and its times: the
    kernel, the plain version, the library's int8 product with the same
    epilogue, and (for context) the bf16 ``F.linear`` of the same product.
    A planted fault, one K slice of xq left out (the last cluster rank's
    share under a split, else the last 64 bytes), must change the bits."""
    import torch.nn.functional as F

    from ofasys_torch.ops.int8_matmul import (int8_matmul_fwd, int8_matmul_reference, int8_plan,
                                              split_ranges)
    from ofasys_torch.ops.quant import _quantize_rows, quantize_weight

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, device="cuda", generator=g) * K ** -0.5
    xq, sx = _quantize_rows(x)
    q, scale = quantize_weight(w)
    plan = int8_plan(M, N, K, xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    out = int8_matmul_fwd(xq, sx, q, scale, torch.bfloat16)
    torch.cuda.synchronize()
    ref = int8_matmul_reference(xq, sx, q, scale, torch.bfloat16)
    err = (out.float() - ref.float()).abs().max().item()
    equal = torch.equal(out, ref)
    plan_s = (f"{plan.kernel} {plan.tile_m}x{plan.tile_n} split {plan.split}, "
              f"{plan.blocks(M, N)} blocks")
    log(f"kernel int8_matmul_fwd [{label} M={M} K={K} N={N}; {plan_s}]: bit-equal to its plain "
        f"version: {equal} (max |out-plain| {err:.3e}) -> {'ok' if equal else 'FAIL'}")
    if not equal:
        raise SystemExit(f"int8_matmul_fwd differs from its plain version at {label}")
    k0, k1 = split_ranges(K, plan.split)[-1] if plan.split > 1 else (max(0, K - 64), K)
    cut = xq.clone()
    cut[:, k0:k1] = 0
    caught = not torch.equal(int8_matmul_fwd(cut, sx, q, scale, torch.bfloat16), ref)
    log(f"  planted fault K bytes {k0}-{k1 - 1} left out: "
        f"{'caught by bit-equality' if caught else 'NOT caught'}")
    if not caught:
        raise SystemExit(f"{label}: bit-equality passes B7 with a K slice left out")
    del cut
    wb = w.to(torch.bfloat16)
    kernel_ms = time_ms(lambda: int8_matmul_fwd(xq, sx, q, scale, torch.bfloat16))
    plain_ms = time_ms(lambda: int8_matmul_reference(xq, sx, q, scale, torch.bfloat16), **PLAIN_TIMING)
    library_ms = _int_mm_ms(xq, sx, q, scale)
    bf16_ms = time_ms(lambda: F.linear(x, wb))
    n_bytes = M * K + N * K + 4 * M + 4 * N + 2 * M * N
    ops = 2 * M * N * K
    bound_ms, bound_by = _bound(n_bytes, ops, PEAK_INT8_OPS)
    pads = [p for p, cut in (("M to 32", M <= 16), (f"K to {-(-K // 16) * 16} and N to "
                                                      f"{-(-N // 8) * 8}", K % 8 or N % 8)) if cut]
    lib = "not timed" if library_ms is None else \
        f"{library_ms:.4f} ms{' (zero-padded: ' + ', '.join(pads) + ')' if pads else ''}"
    log(f"  times [{label}]: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(torch._int_mm + epilogue) {lib}, bf16 F.linear {bf16_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}; {n_bytes} B, {ops} int8 OP)")
    return dict(shape=label, M=M, K=K, N=N, plan=vars(plan), err=err, bit_equal=equal,
                fault_caught=caught, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bf16_linear_ms=bf16_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def qat_shapes(batches, E=768, F=3072):
    """(label, M, K, N) of every distinct B7 call of one train_qat update at
    the base arch under fuse_qkv: per task the encoder's fused q/k/v, out
    (also the decoder's cross q and outs), fc1 and fc2 at B*Ts rows, the
    decoder's at B*Tt rows, and the cross k/v at B*Ts rows."""
    out, seen = [], set()
    for name, b in batches.items():
        B, Ts, Tt = _task_shapes(b)
        Me, Md = B * Ts, B * Tt
        for label, M, K, N in ((f"train_{name}_encoder_qkv", Me, E, 3 * E), (f"train_{name}_encoder_out", Me, E, E),
                               (f"train_{name}_encoder_fc1", Me, E, F), (f"train_{name}_encoder_fc2", Me, F, E),
                               (f"train_{name}_decoder_qkv", Md, E, 3 * E), (f"train_{name}_decoder_out", Md, E, E),
                               (f"train_{name}_cross_kv", Me, E, 2 * E),
                               (f"train_{name}_decoder_fc1", Md, E, F), (f"train_{name}_decoder_fc2", Md, F, E)):
            if (M, K, N) not in seen:
                seen.add((M, K, N))
                out.append((label, M, K, N))
    return out


def phase_int8_kernels(encoder_rows, vocab, train_batches=None):
    """Kernel B7 at serve_int8's shapes: the tied logits of a beam-5 and a
    greedy decode step over ``vocab`` symbols, a beam-5 decode step's fc1,
    fc2 and q/k/v/out (8 requests x beam 5 = 40 rows), a greedy step's
    q/k/v/out (4 rows), the encoder's fc1, fc2 and q/k/v/out at the largest
    dispatch's B*T rows, and a ragged shape (K % 16 != 0: the __dp4a
    kernel); then at train_qat's shapes (:func:`qat_shapes` of
    ``train_batches``). Every plan of ``int8_plan`` the paths take is among
    them."""
    shapes = [("decode_logits", 40, 768, vocab), ("greedy_logits", 4, 768, vocab),
              ("decode_fc1", 40, 768, 3072), ("decode_fc2", 40, 3072, 768),
              ("decode_qkv", 40, 768, 768), ("greedy_qkv", 4, 768, 768),
              ("encoder_fc1", encoder_rows, 768, 3072), ("encoder_fc2", encoder_rows, 3072, 768),
              ("encoder_qkv", encoder_rows, 768, 768), ("ragged", 300, 200, 333)]
    if train_batches is not None:
        shapes += qat_shapes(train_batches)
    return [check_int8(*s) for s in shapes]


def _rel_errors(a, r):
    """max |a - r|, that over max |r|, and the relative Frobenius error."""
    a, r = a.float(), r.float()
    e = (a - r).abs().max().item()
    return dict(max=e, max_rel=e / r.abs().max().item(), frob=((a - r).norm() / r.norm()).item())


def _ln_library_ms(x, w, b, dy):
    """The library yardsticks of B6: ``F.layer_norm`` forward, and autograd
    of it minus its forward. PyTorch's CUDA LayerNorm takes g and b in x's
    dtype only, so they are rounded to it outside the timed calls (its
    statistics are fp32 all the same)."""
    import torch.nn.functional as F

    E = x.shape[1]
    xs, ws, bs = (t.detach().to(x.dtype).requires_grad_() for t in (x, w, b))

    def fwd():
        return F.layer_norm(xs, (E,), ws, bs, 1e-5)

    try:
        with torch.no_grad():
            f_ms = time_ms(fwd)
        both = time_ms(lambda: torch.autograd.grad(fwd(), (xs, ws, bs), dy))
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library LayerNorm not timed: {str(e).splitlines()[0][:120]}")
        return None, None
    return f_ms, both - f_ms


def _ln_bwd_parts(tln, x, w, mu, rstd, dy, drop_block=None):
    """B6-bwd run in its two parts (the per-chunk pass, then the reduction
    of the partials), not counted; with ``drop_block`` one block's partial
    is zeroed between them (a planted fault). Returns (dg, db, setup)."""
    setup = tln.bwd_setup(x, w, dy)
    plan, rows, dx, dg, db, part = setup
    tln.bwd_launch(x, w, mu, rstd, dy, dx, dg, db, part, plan, rows, parts=1)
    if drop_block is not None:
        part[drop_block] = 0
    tln.bwd_launch(x, w, mu, rstd, dy, dx, dg, db, part, plan, rows, parts=2)
    torch.cuda.synchronize()
    return dg, db, setup


def _ln_bwd_alternatives(tln, x, w, mu, rstd, dy, plan, blocks, rows):
    """The per-chunk pass's ms with the choices the plan and the partition
    did not make, where the kernel takes them: straight loads for the ring,
    and the other number of blocks a SM (one or two) for a plan that allows
    two. Not counted; the outputs are thrown away."""
    if plan.kernel != "rows":
        return {}
    N, E = x.shape
    dx, dg, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ways = {}
    if plan.ring:
        ways["straight loads"] = (dataclasses.replace(plan, ring=0), blocks, rows)
    if plan.sm_blocks == 2:
        per = 1 if blocks > sms else 2             # the count the partition did not take
        per_rows = max(1, -(-N // (sms * per)))
        ways[f"{per} block{'s' if per > 1 else ''} a SM"] = (plan, -(-N // per_rows), per_rows)
    out = {}
    for name, (p, n_blocks, rows) in ways.items():
        part = torch.empty((n_blocks, 2, E), dtype=torch.float32, device=x.device)
        out[name] = time_ms(lambda p=p, part=part, rows=rows: tln.bwd_launch(
            x, w, mu, rstd, dy, dx, dg, db, part, p, rows, parts=1))
    return out


def check_ln(label, N, E):
    """Kernels B6-fwd and B6-bwd against their plain versions at one (N, E)
    in bf16, with their times (B6-bwd's two parts apart beside the call),
    the same bits from two B6-bwd calls, and two planted faults that must
    fail LN_SUM_TOL: dg summed over all rows but one, and dg and db reduced
    over all blocks' partials but one. Returns (forward row, backward row)."""
    from ofasys_torch.ops import layer_norm as tln

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn(N, E, device="cuda", generator=g) * 2.0 + 0.5).to(torch.bfloat16)
    dy = torch.randn(N, E, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(E, device="cuda", generator=g) * 0.3 + 1.0
    b = torch.randn(E, device="cuda", generator=g) * 0.1
    y, mu, rstd = tln.layer_norm_fwd(x, w, b, 1e-5)
    dx, dg, db = tln.layer_norm_bwd(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    ry, rmu, rrstd = tln.layer_norm_fwd_reference(x, w, b, 1e-5)
    rdx, rdg, rdb = tln.layer_norm_bwd_reference(x, w, mu, rstd, dy)
    dy_err = (y.float() - ry.float()).abs()
    y_ok = bool((dy_err <= 2.0 ** -7 * ry.float().abs() + 1e-3).all())
    stat_err = max(((mu - rmu).abs() / rmu.abs().clamp(min=1e-6)).max().item(),
                   ((rstd - rrstd).abs() / rrstd.abs()).max().item())
    errs = {n: _rel_errors(a, r) for n, a, r in (("dx", dx, rdx), ("dg", dg, rdg), ("db", db, rdb))}
    ok_dx = errs["dx"]["frob"] <= GRAD_FROB_TOL and errs["dx"]["max_rel"] <= GRAD_MAX_TOL \
        and bool(torch.isfinite(dx.float()).all())
    ok_sums = all(errs[n]["frob"] <= LN_SUM_TOL and errs[n]["max_rel"] <= LN_SUM_TOL
                  for n in ("dg", "db"))
    dx2, dg2, db2 = tln.layer_norm_bwd(x, w, mu, rstd, dy)
    sdg, sdb, (bplan, chunk_rows, *_, part) = _ln_bwd_parts(tln, x, w, mu, rstd, dy)
    same = torch.equal(dx, dx2) and torch.equal(dg, dg2) and torch.equal(db, db2) \
        and torch.equal(sdg, dg) and torch.equal(sdb, db)
    ok = y_ok and stat_err <= 1e-5 and ok_dx and ok_sums and same
    fplan = tln.ln_fwd_plan(E, x.element_size())
    blocks = part.shape[0]
    bdesc = (f"{bplan.kernel} {bplan.warps}x{bplan.slots} acc {bplan.acc} ring {bplan.ring}"
             if bplan.kernel == "rows"
             else f"two_walk vec {int(bplan.vec)}") + f", {blocks} blocks of {chunk_rows} rows"
    tag = f"[{label} N={N} E={E} bf16; B6-fwd {fplan.kernel} {fplan.warps}x{fplan.slots}]"
    log(f"kernels layer_norm_fwd/bwd {tag} B6-bwd {bdesc}: max|y-plain| {dy_err.max().item():.3e} "
        f"(one bf16 ulp), mu/rstd rel {stat_err:.2e} (1e-5); "
        + " ".join(f"{n} frob {v['frob']:.2e} max {v['max_rel']:.2e}" for n, v in errs.items())
        + f" (dx {GRAD_FROB_TOL}/{GRAD_MAX_TOL}, dg/db {LN_SUM_TOL}); B6-bwd same bits twice and "
        f"by parts: {same} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"layer_norm kernels disagree with their plain versions at {label}")
    skip = dy.clone()
    skip[N // 2] = 0
    _, fdg, _ = tln.layer_norm_bwd(x, w, mu, rstd, skip)
    fault = _rel_errors(fdg, rdg)
    caught = fault["frob"] > LN_SUM_TOL or fault["max_rel"] > LN_SUM_TOL
    drop = blocks // 2
    pdg, pdb, _ = _ln_bwd_parts(tln, x, w, mu, rstd, dy, drop_block=drop)
    pfault = {n: _rel_errors(a, r) for n, a, r in (("dg", pdg, rdg), ("db", pdb, rdb))}
    pcaught = all(v["frob"] > LN_SUM_TOL or v["max_rel"] > LN_SUM_TOL for v in pfault.values())
    log(f"  planted faults: dg without row {N // 2}: frob {fault['frob']:.2e} max "
        f"{fault['max_rel']:.2e} -> {'caught' if caught else 'NOT caught'}; dg/db without "
        f"block {drop}'s partial: "
        + " ".join(f"{n} frob {v['frob']:.2e} max {v['max_rel']:.2e}" for n, v in pfault.items())
        + f" -> {'caught' if pcaught else 'NOT caught'}")
    if not (caught and pcaught):
        raise SystemExit(f"{label}: LN_SUM_TOL passes a dg that skipped a row or a partial")
    lib_f, lib_b = _ln_library_ms(x, w, b, dy)
    sz = x.element_size()
    fwd_bytes, fwd_ops = 2 * N * E * sz + 8 * E + 8 * N, 8 * N * E
    bwd_bytes, bwd_ops = 3 * N * E * sz + 8 * N + 12 * E, 12 * N * E
    _, _, *bufs = tln.bwd_setup(x, w, dy)
    stage_ms = {k: time_ms(lambda k=k: tln.bwd_launch(x, w, mu, rstd, dy, *bufs, bplan,
                                                       chunk_rows, parts=k))
                for k in (1, 2)}
    alt_ms = _ln_bwd_alternatives(tln, x, w, mu, rstd, dy, bplan, blocks, chunk_rows)
    rows = []
    for name, kernel, plain, lib, n_bytes, ops, err in (
            ("layer_norm_fwd", lambda: tln.layer_norm_fwd(x, w, b, 1e-5),
             lambda: tln.layer_norm_fwd_reference(x, w, b, 1e-5), lib_f, fwd_bytes, fwd_ops,
             dy_err.max().item()),
            ("layer_norm_bwd", lambda: tln.layer_norm_bwd(x, w, mu, rstd, dy),
             lambda: tln.layer_norm_bwd_reference(x, w, mu, rstd, dy), lib_b, bwd_bytes, bwd_ops,
             max(e["max"] for e in errs.values()))):
        bound_ms, bound_by = _bound(n_bytes, ops, PEAK_FP32_FLOPS)
        k_ms, p_ms = time_ms(kernel), time_ms(plain, **PLAIN_TIMING)
        lib_s = "not timed" if lib is None else f"{lib:.4f} ms"
        alts = ", ".join(f"{k} {v:.4f} ms" for k, v in alt_ms.items()) or "no other plan"
        split = "" if name.endswith("fwd") else \
            f" (per-chunk pass {stage_ms[1]:.4f} ms, reduction {stage_ms[2]:.4f} ms; " \
            f"the pass with {alts})"
        log(f"  times {name} {tag}: kernel {k_ms:.4f} ms{split}, plain {p_ms:.4f} ms, library "
            f"(F.layer_norm{'' if name.endswith('fwd') else ' backward'}) {lib_s}, bound "
            f"{bound_ms:.5f} ms ({bound_by}; {n_bytes} B, {ops} FLOP)")
        extra = {"plan": vars(fplan)} if name == "layer_norm_fwd" else \
            {"plan": vars(bplan), "blocks": blocks, "rows_per_block": chunk_rows,
             "chunk_pass_ms": stage_ms[1], "reduction_ms": stage_ms[2], "alt_pass_ms": alt_ms}
        rows.append(dict(shape=label, N=N, E=E, err=err, kernel_ms=k_ms, plain_ms=p_ms,
                         library_ms=lib, bound_ms=bound_ms, bound_by=bound_by, **extra))
    return rows


def phase_ln_kernels(batches):
    """Kernels B6-fwd and B6-bwd at the train mix's LayerNorm shapes (each
    task's encoder and decoder rows at E = 768, the encoder rows of the
    first task at fc2_ln's 3,072), a decode step and a ragged N; then at
    E = 1,024 and 4,096 (the large arch's width and FFN width: B6-fwd's row
    in registers with one warp and with a group of six) and at an odd E =
    1,001 (the two-walk kernel). Returns {kernel name: [rows]}."""
    shapes = []
    for i, (name, b) in enumerate(batches.items()):
        B, Ts, Tt = _task_shapes(b)
        shapes += [(f"{name}_encoder", B * Ts, 768), (f"{name}_decoder", B * Tt, 768)]
        if i == 0:
            shapes.append((f"{name}_encoder_fc2_ln", B * Ts, 3072))
    shapes += [("decode_step", 40, 768), ("ragged", 1001, 768), ("E1024", 12288, 1024),
               ("E4096", 12288, 4096), ("E1001_odd", 12288, 1001)]
    rows = {"layer_norm_fwd": [], "layer_norm_bwd": []}
    for label, N, E in shapes:
        f, bw = check_ln(label, N, E)
        rows["layer_norm_fwd"].append(f)
        rows["layer_norm_bwd"].append(bw)
    return rows


class RecordingHub:
    """Passes ``inference`` through to the hub and records each dispatch the
    server makes, so the same batches can be replayed directly, and the
    decode steps each dispatch ran (``steps``)."""

    def __init__(self, hub):
        self.hub = hub
        self.device = hub.device
        self.calls = []
        self.steps = []

    def inference(self, instruction, data=None, **kw):
        net = self.hub.model.net
        orig, n = net.decode_step, [0]

        def counted(*a, **k):
            n[0] += 1
            return orig(*a, **k)

        net.decode_step = counted
        try:
            out = self.hub.inference(instruction, data, **kw)
        finally:
            del net.decode_step
        self.calls.append((instruction, data, kw, out))
        self.steps.append(n[0])
        return out


def _requests(tpl=TPL, lengths=SERVE_SRC, seed=SEED, fixed=None):
    """The 16 requests of a serving run: (data, generation overrides), 12
    with the hub's TEXT defaults and 4 greedy, sources of ``lengths`` bytes
    (``fixed``: {request index: bytes} set after the draw)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lengths[0], lengths[1] + 1, size=N_BEAM_REQUESTS + N_GREEDY_REQUESTS)
    for i, n in (fixed or {}).items():
        sizes[i] = n
    srcs = _sources(rng, sizes)
    reqs = [({"src": s}, {"max_len_b": MAX_LEN_B}) for s in srcs[:N_BEAM_REQUESTS]]
    reqs += [({"src": s}, {"max_len_b": MAX_LEN_B, "beam_size": 1}) for s in srcs[N_BEAM_REQUESTS:]]
    return reqs


def _serve_requests():
    """serve: sources of 40-200 bytes; the first request of the 2nd and 3rd
    dispatch (4 records each) has 160, so every dispatch has B*T >= 256
    and meets kernel B1's gate."""
    return _requests(fixed={N_BEAM_REQUESTS - 4: 160, N_BEAM_REQUESTS: 160})


def _long_requests():
    """serve_long: summarization requests with sources of 600-960 bytes."""
    return _requests(SUMMARY_TPL, LONG_SRC, SEED + 2)


def _truncated_requests():
    """serve_truncated: one dispatch of 8 requests with sources of 300-400
    bytes, cut to 257 tokens under the default max_src_length of 256."""
    return _requests(SUMMARY_TPL, TRUNC_SRC, SEED + 3)[:8]


def _encoder_tokens(slots):
    """(B, T) of the encoder's input: a text slot counts its tokens, an
    image slot its patches, a video slot its frames' patches, an audio slot
    its fbank frames after the 4x subsampling."""
    from ofasys_torch import ModalityType
    from ofasys_torch.adaptor.audio import AudioFbankAdaptorConfig
    from ofasys_torch.adaptor.image import PATCH_SIZE

    stride = AudioFbankAdaptorConfig().subsample_stride
    B = T = 0
    for s in slots:
        if s.is_src:
            a = s.value["inputs"]
            B = a.shape[0]
            if s.modality == ModalityType.IMAGE:
                T += (a.shape[1] // PATCH_SIZE) * (a.shape[2] // PATCH_SIZE)
            elif s.modality == ModalityType.VIDEO:
                T += a.shape[1] * (a.shape[2] // PATCH_SIZE) * (a.shape[3] // PATCH_SIZE)
            elif s.modality == ModalityType.AUDIO:
                T += -(-a.shape[1] // stride)
            else:
                T += a.shape[1]
    return B, T


def _encoder_shape(gp, recs, tpl=TPL):
    from ofasys_torch.preprocessor.instruction import Instruction

    sample = gp.collate([gp(Instruction(tpl, split="test").format(**r)) for r in recs])
    return _encoder_tokens(sample["net_input"]["slots"])


def _images(rng, n, size=IMAGE_SIZE):
    """``n`` uint8-valued float32 (size, size, 3) arrays: at the
    preprocessor's size, so they need no resize."""
    return [rng.integers(0, 256, (size, size, 3)).astype(np.float32) for _ in range(n)]


def _caption_requests():
    """serve_caption: 16 images, 12 with the hub's TEXT defaults (beam 5) and
    4 greedy."""
    imgs = _images(np.random.default_rng(SEED + 5), N_BEAM_REQUESTS + N_GREEDY_REQUESTS)
    reqs = [({"img": a}, {"max_len_b": MAX_LEN_B}) for a in imgs[:N_BEAM_REQUESTS]]
    reqs += [({"img": a}, {"max_len_b": MAX_LEN_B, "beam_size": 1}) for a in imgs[N_BEAM_REQUESTS:]]
    return reqs


def _wav_bytes(rng, seconds):
    """16 kHz mono 16-bit wav bytes (stdlib ``wave``) of two tones and
    noise, ``seconds`` long."""
    import io
    import wave

    t = np.arange(int(SAMPLE_RATE * seconds)) / SAMPLE_RATE
    f1, f2 = rng.uniform(120, 1200, 2)
    x = 0.4 * np.sin(2 * np.pi * f1 * t) + 0.2 * np.sin(2 * np.pi * f2 * t) \
        + 0.05 * rng.standard_normal(t.shape)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(np.round(np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _asr_requests():
    """serve_asr: 16 wavs of ASR_SECONDS, 12 with the hub's TEXT defaults
    (beam 5) and 4 greedy."""
    rng = np.random.default_rng(SEED + 6)
    wavs = [_wav_bytes(rng, rng.uniform(*ASR_SECONDS)) for _ in range(N_BEAM_REQUESTS + N_GREEDY_REQUESTS)]
    reqs = [({"wav": w}, {"max_len_b": MAX_LEN_B}) for w in wavs[:N_BEAM_REQUESTS]]
    reqs += [({"wav": w}, {"max_len_b": MAX_LEN_B, "beam_size": 1}) for w in wavs[N_BEAM_REQUESTS:]]
    return reqs


def _motion_texts():
    """serve_motion: the 8 requests' motion descriptions."""
    return [_text(np.random.default_rng(SEED + 7 + i), 12, 40) for i in range(N_MOTION_REQUESTS)]


def _same_record(a, b):
    """Two request records hold the same values (arrays by identity)."""
    return a is not None and a.keys() == b.keys() and all(
        a[k] is b[k] or (not isinstance(a[k], np.ndarray) and a[k] == b[k]) for k in a)


def planned_dispatch_shapes(gp=None, reqs=None, tpl=TPL):
    """(B, T) of the encoder in each dispatch the server will make: the
    first 8 beam requests, the other 4 beam requests, the 4 greedy ones."""
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    gp = gp or GeneralPreprocess(Dictionary(), active=["text", "image"])
    recs = [r for r, _ in (reqs or _serve_requests())]
    groups = (recs[:8], recs[8:N_BEAM_REQUESTS], recs[N_BEAM_REQUESTS:])
    return [_encoder_shape(gp, g, tpl) for g in groups if g]


def _sources(rng, lengths):
    words = ["the", "model", "serves", "a", "batch", "of", "text", "requests", "on", "one", "card",
             "with", "beam", "search", "and", "greedy", "decoding", "over", "fifty", "thousand",
             "symbols", "quick", "brown", "fox", "jumps", "lazy", "dog", "12", "345", "north"]
    out = []
    for L in lengths:
        s = ""
        while len(s) < L:
            s += rng.choice(words) + " "
        out.append(s[:L].strip().ljust(L, "x"))
    return out


def _per_dispatch(net):
    """Launches of B7 and B6-fwd in one serving dispatch of S decode steps,
    as (once, per step), counted from the net's modules: B7 on every int8
    projection of the encoder and on the decoder's cross k/v (projected
    once, in decode_prepare), then on the other decoder projections and the
    tied logits at every step; B6-fwd on every fused LayerNorm of the
    encoder, then of the decoder at every step."""
    from ofasys_torch.ops.layer_norm import FusedLayerNorm
    from ofasys_torch.ops.quant import is_quantized

    def count(prefix, pred):
        return sum(1 for n, m in net.named_modules() if n.startswith(prefix) and pred(n, m))

    def int8(n, m):
        return is_quantized(m)

    def cross_kv(n, m):
        return is_quantized(m) and n.endswith(("encoder_attn.k_proj", "encoder_attn.v_proj"))

    def fused(n, m):
        return isinstance(m, FusedLayerNorm) and m.mode == "fused"

    cross = count("decoder.", cross_kv)
    logits = int(is_quantized(net.embed_tokens))
    return {"int8_matmul_fwd": (count("encoder.", int8) + cross,
                                count("decoder.", int8) - cross + logits),
            "layer_norm_fwd": (count("encoder.", fused), count("decoder.", fused))}


def _expected_launches(gp, calls, steps, net, tpl=TPL, members=1):
    """Per dispatch (B, T, route) and the kernel launches the dispatches
    should make: one per encoder layer of kernel B3 (flash, T >= 256) or B1
    (dense gate) for each of the ``members`` models, none on the plain path;
    B7 and B6-fwd by :func:`_per_dispatch` for each dispatch's decode steps."""
    cfg = net.cfg
    shapes, expected = [], dict.fromkeys(KERNELS, 0)
    per = _per_dispatch(net)
    for (_, data, _, _), S in zip(calls, steps, strict=True):
        B, T = _encoder_shape(gp, data if isinstance(data, list) else [data], tpl)
        route = _route(cfg, B, T, T)
        shapes.append((B, T, route))
        if route != "plain":
            expected[f"{route}_attention_fwd"] += members * cfg.encoder.layers
        for name, (once, step) in per.items():
            expected[name] += once + step * S
    return shapes, expected


def base_dictionary():
    """The base slice's dictionary (50,000 ``<text>_i`` symbols padded to a
    multiple of 128) and its text and image preprocessor."""
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text", "image"])   # registers <text>_0..255 and <mask>
    for i in range(256, 50000):                       # GPT-2-scale text vocabulary
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(128)
    return d, gp


def build_base_hub():
    """The base arch at full width (E=768, FFN 3072, 12 heads, 6+6 layers)
    with 50,000 ``<text>_i`` symbols padded to a multiple of 128, random
    weights from SEED, bf16 compute on the card."""
    from ofasys_torch import GeneralistModel, OFASys

    t0 = time.perf_counter()
    d, gp = base_dictionary()
    model = GeneralistModel(arch="base")
    model.cfg.dropout = 0.0
    model.initialize(d, active_adaptors=ACTIVE_ADAPTORS, dtype=torch.bfloat16, device="cuda", seed=SEED)
    hub = OFASys(model, None, d, gp)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"slice: base arch E={cfg.encoder.embed_dim} ffn={cfg.encoder.ffn_embed_dim} "
        f"heads={cfg.encoder.attention_heads} layers={cfg.encoder.layers}+{cfg.decoder.layers} "
        f"vocab={len(d)} adaptors={ACTIVE_ADAPTORS} params={n_params} "
        f"built in {time.perf_counter() - t0:.1f} s")
    return hub


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best(o):
    """The best hypothesis of an answer (an n-best list or one hypothesis)."""
    return o[0] if isinstance(o, list) else o


def serve_and_check(hub, card, tpl=TPL, reqs=None, label="serve", check_encoder=True, members=1):
    """Drive the serving path with the requests (default: the serve run's 16) and
    check what comes out; returns the kernel launch counts of that run
    (``launches``), its p50 latency, tokens/s, answers, and the dispatches
    with their decode steps. ``check_encoder`` holds the encoder output
    under the attention kernel against plain attention (ENC_REL_TOL).
    ``members``: the models of an ensemble hub, each running its encoder."""
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.serve import InferenceServer
    from ofasys_torch.utils.pytree import slots_to_device

    gp, model = hub.general_preprocess, hub.model
    cfg = model.cfg
    reqs = reqs or _serve_requests()
    on_card = hub.device.type == "cuda"

    # warm-up (cuBLAS handles, allocator) outside the measured run
    hub.inference(tpl, [r for r, _ in reqs[:8]], max_len_b=4)
    hub.inference(tpl, [r for r, _ in reqs[:4]], max_len_b=4, beam_size=1)
    _sync(hub.device)

    rec = RecordingHub(hub)
    srv = InferenceServer(rec, max_batch=8, max_wait_ms=50.0, device=hub.device)
    try:
        reset_counts()
        t_start = time.perf_counter()
        futs = [srv.submit(tpl, data, **opts) for data, opts in reqs]
        outs = [f.result(timeout=600) for f in futs]
        _sync(hub.device)
        wall = time.perf_counter() - t_start
        launches = read_counts()
    finally:
        srv.close()
    stats = srv.stats()

    for i, o in enumerate(map(_best, outs)):
        if not (np.isfinite(o.score) and (isinstance(o.text, str) or o.box is not None)
                and o.tokens.size > 0):
            raise SystemExit(f"{label} request {i}: bad answer {o!r}")
    n_tokens = int(sum(_best(o).tokens.size for o in outs))
    shapes, expected = _expected_launches(gp, rec.calls, rec.steps, model.net, tpl, members)
    launched = {n: c for n, c in launches.items() if c or expected[n]}
    log(f"  {label} dispatches (B, T, encoder route): {shapes}, decode steps {rec.steps}")
    for name, (once, step) in _per_dispatch(model.net).items():
        if once or step:
            log(f"  {label} {name} per dispatch: {once} + {step} * S = "
                f"{[once + step * S for S in rec.steps]}")
    log(f"  {label} launches: {launched} (expected {({n: c for n, c in expected.items() if c})})")
    if on_card and (launches != expected or any(route == "plain" for *_, route in shapes)):
        raise SystemExit(f"{label}: a kernel did not run as often as the path calls it")
    log(f"  {label}: served {stats['requests']} requests in {stats['batches']} batches, "
        f"p50 latency {stats['p50_latency_ms']} ms, {n_tokens} tokens in {wall:.3f} s = "
        f"{n_tokens / wall:.1f} tokens/s [{card}]")
    res = dict(launches=launches, p50_ms=stats["p50_latency_ms"], tokens_per_s=n_tokens / wall,
               requests_per_s=len(reqs) / wall, outs=outs, calls=rec.calls, steps=rec.steps,
               shapes=shapes)
    first = _best(outs[0])
    answer = first.text[:60] if first.text is not None else first.box
    log(f"  sample answer: {answer!r} score {first.score:.4f}")

    # served answers equal direct hub.inference on the same batches, and
    # each future got the answer to its own record
    mismatches = 0
    where = {}
    for instruction, data, kw, out in rec.calls:
        direct = hub.inference(instruction, data, **kw)
        batch = data if isinstance(data, list) else [data]
        served = out if isinstance(data, list) else [out]
        direct = direct if isinstance(data, list) else [direct]
        for j, (o, r) in enumerate(zip(served, direct, strict=True)):
            o_hyps, r_hyps = (x if isinstance(x, list) else [x] for x in (o, r))
            mismatches += any(not np.array_equal(a.tokens, b.tokens)
                              for a, b in zip(o_hyps, r_hyps, strict=True))
            where[id(o)] = batch[j]
    misrouted = sum(not _same_record(where.get(id(o)), data) for o, (data, _) in zip(outs, reqs))
    log(f"  served vs direct hub.inference on the same batches: {mismatches} mismatches, "
        f"{misrouted} answers routed to the wrong request")
    if mismatches or misrouted:
        raise SystemExit(f"{label}: served answers differ from direct inference")

    if not check_encoder:
        return res
    # encoder output of the first dispatch's records, kernel vs plain attention
    recs = [r for r, _ in reqs[:8]]
    sample = gp.collate([gp(Instruction(tpl, split="test").format(**r)) for r in recs])
    src = slots_to_device([s for s in sample["net_input"]["slots"] if s.is_src], hub.device)
    kernel = f"{shapes[0][2]}_attention_fwd"
    saved = cfg.attn_kernel, cfg.use_flash_attention
    with torch.no_grad():
        before = read_counts().get(kernel, 0)
        enc_kernel = model.net.encode(src).x.float()
        used = read_counts().get(kernel, 0) - before
        cfg.attn_kernel, cfg.use_flash_attention = "xla", False
        try:
            enc_plain = model.net.encode(src).x.float()
        finally:
            cfg.attn_kernel, cfg.use_flash_attention = saved
    rel = ((enc_kernel - enc_plain).norm() / enc_plain.norm()).item()
    mx = (enc_kernel - enc_plain).abs().max().item()
    log(f"  encoder output {kernel} vs plain attention {tuple(enc_kernel.shape)}: "
        f"rel {rel:.3e} (tol {ENC_REL_TOL}), max abs {mx:.3e} (tol {ENC_ABS_TOL}), "
        f"kernel launches {used}")
    if (on_card and used != cfg.encoder.layers) or not rel <= ENC_REL_TOL or not mx <= ENC_ABS_TOL:
        raise SystemExit(f"{label}: encoder output under {kernel} disagrees with plain attention")
    return res


def long_preprocess(d):
    """The text preprocessor with max_src_length and max_tgt_length raised
    to LONG, on the same dictionary."""
    from ofasys_torch.preprocessor.general import GeneralPreprocess
    from ofasys_torch.preprocessor.text import TextPreprocessConfig

    return GeneralPreprocess(d, active=["text", "image"],
                             text_cfg=TextPreprocessConfig(max_src_length=LONG, max_tgt_length=LONG))


def serve_long_and_check(hub, card):
    """serve_long: a hub on the same model whose text lengths are raised to
    LONG, 16 summarization requests with sources of 600-960 bytes."""
    from ofasys_torch import OFASys

    long_hub = OFASys(hub.model, None, hub.global_dict, long_preprocess(hub.global_dict),
                      device=hub.device)
    return serve_and_check(long_hub, card, SUMMARY_TPL, _long_requests(), "serve_long")


def serve_truncated_and_check(hub, card):
    """serve_truncated: one dispatch of 8 requests under the default
    max_src_length = 256: the 300-400 byte sources are cut to 257 tokens."""
    from ofasys_torch.preprocessor.instruction import Instruction

    reqs = _truncated_requests()
    gp = hub.general_preprocess
    src = gp.collate([gp(Instruction(SUMMARY_TPL, split="test").format(**r)) for r, _ in reqs])
    tokens = src["net_input"]["slots"][0].value["inputs"]
    n_tok = int((tokens != hub.global_dict.pad()).sum(1).max())
    log(f"  serve_truncated: encoder input {tokens.shape}, longest {n_tok} tokens")
    if n_tok != gp.name2pre["text"].cfg.max_src_length + 1:
        raise SystemExit("serve_truncated: the sources were not cut to max_src_length + 1")
    return serve_and_check(hub, card, SUMMARY_TPL, reqs, "serve_truncated")


def _report_profile(prof, wall_ms, what, card, share=None):
    """Log and return (a dict) wall, device busy time and idle share,
    launches and the top kernels;
    with ``share`` (a tuple of names), the share of device time of the
    kernels whose name holds one of them. Profiles trace the card alone
    (its kernels and copies): tracing the host's ops as well lengthened the
    profiled wall and took 5-10 s a profile to gather."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    log(f"profile: {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle {100 * (1 - busy_ms / wall_ms):.1f}%, {n_launch} kernel launches [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms, launches=n_launch)
    if share:
        own = [e for e in kernels if any(s in e.key for s in share)]
        own_ms = sum(e.self_device_time_total for e in own) / 1e3
        log(f"  kernels named {' or '.join(f'*{s}*' for s in share)}: {own_ms:.3f} ms in "
            f"{sum(e.count for e in own)} launches, "
            f"{100 * own_ms / max(busy_ms, 1e-9):.1f}% of device time")
        out.update(share_ms=own_ms, share_launches=sum(e.count for e in own))
    return out


def phase_profile(hub, card, share=None, tpl=TPL, reqs=None, what="one dispatch (B=8, beam 5)",
                  opts=None):
    """One dispatch of the serving path (the first 8 requests, beam 5, or
    the generation options ``opts``) under torch.profiler: wall time,
    device busy time and idle share, kernel launches, and the kernels that
    take the most device time (with ``share``, the share of the kernels
    whose name holds one of its names)."""
    from torch.profiler import ProfilerActivity, profile

    recs = [r for r, _ in (reqs or _serve_requests())[:8]]
    _sync(hub.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hub.inference(tpl, recs, **({"max_len_b": MAX_LEN_B} if opts is None else opts))
        _sync(hub.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _report_profile(prof, wall_ms, what, card, share)


def serve_caption_and_check(hub, card, serve_res=None):
    """serve_caption: 16 image→text requests through the server; kernel B1 in
    every dispatch's encoder, the encoder output against plain attention;
    p50 and tokens/s beside serve's (``serve_res``)."""
    res = serve_and_check(hub, card, CAPTION_TPL, _caption_requests(), "serve_caption")
    if serve_res is not None:
        log(f"  serve_caption vs serve: p50 {res['p50_ms']} vs {serve_res['p50_ms']} ms, "
            f"{res['tokens_per_s']:.1f} vs {serve_res['tokens_per_s']:.1f} tokens/s [{card}]")
    return res


def serve_asr_and_check(hub, card, serve_res=None):
    """serve_asr: 16 speech→text requests (wav bytes) through the server;
    kernel B1 in every dispatch's encoder (the subsampled frames + the
    prompt's tokens), the encoder output against plain attention, served
    answers against the hub on the same batch composition (a request's
    encoder states depend on its batch's longest wav through the padded
    frames), p50 and tokens/s beside serve's (``serve_res``). First the
    host time of the audio preprocessing per request: wav decode, fbank and
    CMVN, and the whole of GeneralPreprocess for one request."""
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.utils.audio_utils import apply_cmvn, load_wav, logmel_fbank

    reqs = _asr_requests()
    gp = hub.general_preprocess
    parts = {"wav decode": [], "fbank": [], "cmvn": [], "GeneralPreprocess": []}
    frames = []
    for data, _ in reqs:
        t0 = time.perf_counter()
        wav, sr = load_wav(data["wav"])
        t1 = time.perf_counter()
        feats = logmel_fbank(wav, sr)
        t2 = time.perf_counter()
        apply_cmvn(feats)
        t3 = time.perf_counter()
        gp(Instruction(ASR_TPL, split="test").format(**data))
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(dt * 1e3)
        frames.append(feats.shape[0])
    log(f"  serve_asr: {len(reqs)} wavs of {min(frames)}-{max(frames)} fbank frames; host ms per request "
        "(median, max): " + ", ".join(f"{k} {statistics.median(v):.3f}, {max(v):.3f}"
                                        for k, v in parts.items()) + " [host CPU]")
    res = serve_and_check(hub, card, ASR_TPL, reqs, "serve_asr")
    res["preprocess_ms"] = {k: statistics.median(v) for k, v in parts.items()}
    if serve_res is not None:
        log(f"  serve_asr vs serve: p50 {res['p50_ms']} vs {serve_res['p50_ms']} ms, "
            f"{res['tokens_per_s']:.1f} vs {serve_res['tokens_per_s']:.1f} tokens/s [{card}]")
    return res


def motion_sample(gp):
    """serve_motion's batch (the test split: open targets) and the motion
    preprocessor. An open target's width is what the preprocessor learned
    from its data; it may have seen none, so it is set to MOTION_FEAT."""
    from ofasys_torch.preprocessor.instruction import Instruction

    pre = gp.name2pre.get("motion_6d") or gp._build("motion_6d")
    pre.feat_dim = MOTION_FEAT
    sample = gp.collate([gp(Instruction(MOTION_TPL, split="test").format(text=t)) for t in _motion_texts()])
    return sample, pre


def serve_motion_and_check(hub, card):
    """serve_motion: N_MOTION_REQUESTS text→motion requests (open 64 x 135
    targets) in one batch through DiffusionGenerator.generate with its
    defaults (50 DDIM steps of the full-context decoder, the motion
    preprocessor's clamp): kernel B1 in the encoder and in every decoder
    self- and cross-attention of every denoiser pass, launches as
    attention_route expects; the features against the same run on the plain
    attention path from the same initial noise (MOTION_REL_TOL); the wall
    time of the batch. Returns the launch counts and the results."""
    from ofasys_torch.generator import DiffusionGenerator

    gp, model = hub.general_preprocess, hub.model
    cfg = model.cfg
    sample, pre = motion_sample(gp)
    B, Ts, Tt = _task_shapes(sample)
    gen = DiffusionGenerator(model, clamp_fn=pre.clamp)
    L = cfg.decoder.layers
    routes = {"encoder": _route(cfg, B, Ts, Ts), "decoder_full": _route(cfg, B, Tt, Tt),
              "cross": _route(cfg, B, Tt, Ts)}
    log(f"  serve_motion: B={B} encoder T={Ts} target {Tt} x {MOTION_FEAT}, {gen.num_inference_steps} "
        f"DDIM steps of {gen.diffusion.num_steps} ({gen.diffusion.schedule}), eta {gen.eta}; "
        f"routes {routes}")
    expected = dict.fromkeys(KERNELS, 0)
    expected["dense_attention_fwd"] = cfg.encoder.layers * (routes["encoder"] == "dense") \
        + gen.num_inference_steps * L * ((routes["decoder_full"] == "dense") + (routes["cross"] == "dense"))
    on_card = hub.device.type == "cuda"
    gen.generate(sample, seed=SEED)                       # warm-up
    _sync(hub.device)
    reset_counts()
    t0 = time.perf_counter()
    outs = gen.generate(sample, seed=SEED)
    _sync(hub.device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    feats = np.stack([o.feature for o in outs])
    if feats.shape != (B, Tt, MOTION_FEAT) or not np.isfinite(feats).all():
        raise SystemExit(f"serve_motion: bad features {feats.shape}")
    log(f"  serve_motion launches: {({n: c for n, c in launches.items() if c})} (expected "
        f"{({n: c for n, c in expected.items() if c})}: {cfg.encoder.layers} encoder layers + "
        f"{gen.num_inference_steps} steps x {L} layers x 2)")
    if on_card and (launches != expected or "plain" in routes.values()):
        raise SystemExit("serve_motion: B1 did not run in every attention of every denoiser pass")
    log(f"  serve_motion: {B} requests in one batch, {wall * 1e3:.2f} ms wall (each request's "
        f"latency), {B / wall:.2f} requests/s, {wall * 1e3 / gen.num_inference_steps:.3f} ms per "
        f"DDIM step [{card}]")
    saved = cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits
    plain = {}
    try:
        cfg.attn_kernel, cfg.use_flash_attention = "xla", False
        for logits in GRAD_PLAIN_LOGITS:
            cfg.attn_logits = logits
            plain[logits] = np.stack([o.feature for o in gen.generate(sample, seed=SEED)])
    finally:
        cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved
    rels = {lg: float(np.linalg.norm(feats - f) / np.linalg.norm(f)) for lg, f in plain.items()}
    mx = float(np.abs(feats - plain[GRAD_REF_LOGITS]).max())
    log(f"  serve_motion: features under B1 vs plain attention, same initial noise: rel "
        + ", ".join(f"{rel:.3e} (attn_logits={lg!r})" for lg, rel in rels.items())
        + f"; checked against {GRAD_REF_LOGITS!r} (tol {MOTION_REL_TOL}), max abs {mx:.3e}; "
        f"feature rms {float(np.sqrt((feats ** 2).mean())):.3f}")
    if not rels[GRAD_REF_LOGITS] <= MOTION_REL_TOL:
        raise SystemExit("serve_motion: features under B1 disagree with the plain attention path")
    bvh = gp.postprocess(outs, sample)[0].bvh
    log(f"  serve_motion: postprocess -> {type(bvh).__name__} {np.shape(bvh)}")
    return launches, dict(wall_ms=wall * 1e3, requests_per_s=B / wall, rel=rels, max_abs=mx,
                          routes=routes)


def ground_preprocess():
    """The grounding model's dictionary and preprocessors: the byte symbols
    and <mask> (text), the 1,000 <bin>_i (box), then <text>_256 .. 49,999,
    padded to a multiple of 8."""
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text", "image", "box"])
    for i in range(256, 50000):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d, gp


def build_ground_hub(d, gp, device="cuda", arch="base"):
    """The grounding model: ``arch`` at full width with adaptors
    GROUND_ADAPTORS (image_resnet at resnet101), random weights from SEED,
    bf16 compute, built after the preprocessors grew the dictionary."""
    from ofasys_torch import GeneralistModel, OFASys

    t0 = time.perf_counter()
    model = GeneralistModel(arch=arch)
    model.cfg.dropout = 0.0
    model.initialize(d, active_adaptors=GROUND_ADAPTORS, dtype=torch.bfloat16, device=device, seed=SEED)
    hub = OFASys(model, None, d, gp, device=device)
    trunk = model.net.encoder_adaptor.image_resnet
    n_trunk = sum(p.numel() for p in trunk.embed_images.parameters())
    cfg = model.cfg
    log(f"ground: {arch} arch E={cfg.encoder.embed_dim} heads={cfg.encoder.attention_heads} "
        f"layers={cfg.encoder.layers}+{cfg.decoder.layers} vocab={len(d)} adaptors={GROUND_ADAPTORS} "
        f"({trunk.acfg.resnet_type}: {len(trunk.embed_images.block_names)} bottlenecks, {n_trunk} "
        f"trunk parameters) params={sum(p.numel() for p in model.net.parameters())} "
        f"built in {time.perf_counter() - t0:.1f} s")
    return hub


def _ground_requests(bins=None):
    """serve_ground's requests: N_GROUND_REQUESTS 224 x 224 images and
    referring expressions of GROUND_TEXT bytes under the hub's BOX defaults
    (greedy, exactly 4 tokens); with ``bins`` (start, end), the
    N_CONSTRAINED_REQUESTS that follow, with the bins as constraint_range."""
    rng = np.random.default_rng(SEED + 8)
    n = N_GROUND_REQUESTS + N_CONSTRAINED_REQUESTS
    recs = [{"img": a, "text": _text(rng, *GROUND_TEXT)} for a in _images(rng, n)]
    if bins is None:
        return [(r, {}) for r in recs[:N_GROUND_REQUESTS]]
    return [(r, {"constraint_range": f"({bins[0]},{bins[1]})"}) for r in recs[N_GROUND_REQUESTS:]]


def ground_dispatch_shapes(gp):
    """(B, T) of the encoder in each serve_ground dispatch: two of 8, then
    the constrained 4."""
    recs = [r for r, _ in _ground_requests()]
    box = gp.name2pre["box"]
    con = [r for r, _ in _ground_requests((box.bin_start, box.bin_end))]
    return [_encoder_shape(gp, g, REFCOCO_TPL) for g in (recs[:8], recs[8:], con)]


def _trunk_forward(trunk, x):
    """The ResNet's forward, with the RMS of each bottleneck's output."""
    rms = []

    def record(name):
        return lambda module, inputs, out: rms.append((name, out.float().pow(2).mean().sqrt().item()))

    hooks = [getattr(trunk, n).register_forward_hook(record(n)) for n in trunk.block_names]
    try:
        return trunk(x), rms
    finally:
        for h in hooks:
            h.remove()


def trunk_device_ms(trunk, images, backward=False):
    """Device busy ms and launches of one call of the trunk on ``images``
    (and, with ``backward``, its backward to every parameter) under
    torch.profiler, with its three costliest kernels: the trunk's part of
    a profiled dispatch or update, whose cuDNN and cuBLAS kernels cannot be
    told apart from the transformer's by name (1 x 1 convolutions run as
    GEMMs)."""
    from torch.profiler import ProfilerActivity, profile

    params = [p for p in trunk.parameters()]

    def call():
        out = trunk(images.to(torch.bfloat16))
        if backward:
            torch.autograd.grad(out.float().square().mean(), params)

    call()                                                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if backward:
            call()
        else:
            with torch.no_grad():
                call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    return busy, sum(e.count for e in kernels), [(round(e.self_device_time_total / 1e3, 3), e.key[:60])
                                                 for e in top]


def trunk_check(hub, card):
    """image_resnet's trunk on the first serve_ground dispatch's images:
    the output in bf16 (as served) against a copy in fp32 (TF32 off), the
    RMS after each bottleneck (random convolutions with unit statistics
    let it grow block by block), the time of each and, on the card, one
    bf16 call's device time."""
    import copy

    from ofasys_torch.model.resnet import Conv2d
    from ofasys_torch.preprocessor.instruction import Instruction

    gp = hub.general_preprocess
    recs = [r for r, _ in _ground_requests()[:8]]
    sample = gp.collate([gp(Instruction(REFCOCO_TPL, split="test").format(**r)) for r in recs])
    images = torch.from_numpy(sample["net_input"]["slots"][0].value["inputs"]).to(hub.device)
    trunk = hub.model.net.encoder_adaptor.image_resnet.embed_images
    trunk32 = copy.deepcopy(trunk)
    for m in trunk32.modules():
        if isinstance(m, Conv2d):
            m.dtype = torch.float32
    with torch.no_grad():
        out16, rms = _trunk_forward(trunk, images.to(torch.bfloat16))
        out32, _ = _trunk_forward(trunk32, images)
        ms16 = ms32 = None
        if hub.device.type == "cuda":
            ms16 = time_ms(lambda: trunk(images.to(torch.bfloat16)), n=3, repeats=3)
            ms32 = time_ms(lambda: trunk32(images), n=3, repeats=3)
    rel = ((out16.float() - out32).norm() / out32.norm()).item()
    log(f"  image_resnet trunk on {tuple(images.shape)}: output {tuple(out16.shape)}, bf16 vs fp32 "
        f"relative Frobenius {rel:.3e} (tol {TRUNK_REL_TOL}), output rms {rms[-1][1]:.4g}; input rms "
        f"{images.pow(2).mean().sqrt().item():.4g}, rms after each bottleneck: "
        + ", ".join(f"{n} {v:.4g}" for n, v in rms))
    busy = None
    if ms16 is not None:
        busy, n, top = trunk_device_ms(trunk, images)
        log(f"  image_resnet trunk, B={images.shape[0]}: bf16 {ms16:.3f} ms, fp32 {ms32:.3f} ms a call "
            f"(CUDA events, host launches included); one bf16 call profiled: device busy {busy:.3f} ms "
            f"in {n} launches, top {top} [{card}]")
    if not torch.isfinite(out16).all() or not rel <= TRUNK_REL_TOL:
        raise SystemExit("serve_ground: the bf16 trunk disagrees with its fp32 copy")
    del trunk32
    return dict(trunk_rel=rel, trunk_rms=rms[-1][1], trunk_ms_bf16=ms16, trunk_ms_fp32=ms32,
                trunk_busy_ms=busy)


def _selection_log(hub, instruction, data, kw, unconstrained=False, result=None):
    """One inference of the batch with every stable top-k of the generator
    recorded: per call, the indices it kept and, per request row, the
    smallest gap between neighbours among the kept and the first dropped
    real candidates (the margin by which its choice and order were made).
    With ``unconstrained`` also the plain beam's choice of its 2K
    candidates from all K x V (``sg._full_top_k``, not the stable top-k).
    Only the generator's two top-k functions are wrapped; each wrapper
    calls the function it replaces with the arguments as given. ``result``
    (a list) receives the inference's output."""
    from ofasys_torch.generator import sequence_generator as sg

    saved, log_ = (sg._top_k, sg._full_top_k), []

    def recorder(fn):
        def record(x, k):
            vals, idx = fn(x, k)
            v = torch.topk(x, min(k + 1, x.shape[-1]), dim=-1).values
            gap = torch.where(v[..., 1:] > NEG_SCORE, v[..., :-1] - v[..., 1:], float("inf"))
            log_.append((idx.reshape(x.shape[0], -1).cpu(),
                         gap.reshape(x.shape[0], -1).min(dim=-1).values.cpu() if gap.numel() else None))
            return vals, idx
        return record

    sg._top_k = recorder(saved[0])
    if unconstrained:
        sg._full_top_k = recorder(saved[1])
    try:
        out = hub.inference(instruction, data, **kw)
    finally:
        sg._top_k, sg._full_top_k = saved
    if result is not None:
        result.append(out)
    return log_


def _parting_margin(log_a, log_b, row):
    """The margin of the first selection at which two runs of one batch
    chose differently for request ``row`` (the smaller of the two runs'
    margins there); inf if their recorded selections never part."""
    for (ia, ga), (ib, gb) in zip(log_a, log_b):
        if not torch.equal(ia[row], ib[row]):
            return min(float(g[row]) if g is not None else float("inf") for g in (ga, gb))
    return float("inf")


def _final_pick_margins(hub, instruction, data, kw, rows, saved):
    """For requests whose two searches selected alike at every step but
    returned other answers (the pick among finished hypotheses by
    normalized score parted), the margin of that pick: the score gap in one
    run between its best hypothesis and the other run's best, which it also
    finished; inf where neither run finished the other's answer. Both runs
    return their beam's n-best; the attention config ends as ``saved``."""
    cfg = hub.model.cfg
    kw_n = dict(kw, return_n_best=kw.get("beam_size", 5))
    runs = {}
    for name, setting in (("plain", ("xla", False, GRAD_REF_LOGITS)), ("kernel", saved)):
        cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = setting
        out = hub.inference(instruction, data, **kw_n)
        runs[name] = out if isinstance(data, list) else [out]
    out = {}
    for i in rows:
        gaps = []
        for mine, other in ((runs["kernel"][i], runs["plain"][i]), (runs["plain"][i], runs["kernel"][i])):
            match = [h for h in mine if np.array_equal(h.tokens, other[0].tokens)]
            if match:
                gaps.append(float(mine[0].score - match[0].score))
        out[i] = min(gaps) if gaps else float("inf")
    return out


def _tokens_vs_plain(hub, calls, label, tie_tol=0.0, unconstrained=False):
    """Each recorded dispatch again on the plain attention path (fp32
    scores), the same batch composition: the tokens must be equal, or, with
    ``tie_tol``, a request may differ where the two searches first part at
    a selection whose margin (between neighbouring candidates, in either
    run) is at most ``tie_tol``, a near-tie that bf16 rounding can swap.
    ``unconstrained`` (a beam without a trie or constraints): the log also
    holds each step's choice of candidates from the whole vocabulary, and a
    request whose searches never part there may differ where the pick among
    the finished hypotheses does, by at most ``tie_tol``
    (:func:`_final_pick_margins`). Returns the plain path's best
    hypotheses."""
    cfg = hub.model.cfg
    saved = cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits
    n, plain_outs, differ = 0, [], []
    try:
        for instruction, data, kw, out in calls:
            cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = "xla", False, GRAD_REF_LOGITS
            plain = hub.inference(instruction, data, **kw)
            if not isinstance(data, list):
                out, plain = [out], [plain]
            rows = [i for i, (o, r) in enumerate(zip(map(_best, out), map(_best, plain), strict=True))
                    if not np.array_equal(o.tokens, r.tokens)]
            n += len(out)
            plain_outs += list(map(_best, plain))
            if rows and tie_tol:
                log_plain = _selection_log(hub, instruction, data, kw, unconstrained)
                cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved
                log_kernel = _selection_log(hub, instruction, data, kw, unconstrained)
                margins = [_parting_margin(log_kernel, log_plain, i) for i in rows]
                final = [i for i, g in zip(rows, margins) if g == float("inf")]
                if final and unconstrained:
                    picks = _final_pick_margins(hub, instruction, data, kw, final, saved)
                    margins = [picks.get(i, g) for i, g in zip(rows, margins)]
                differ += margins
            else:
                differ += [float("inf")] * len(rows)
    finally:
        cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved
    log(f"  {label}: tokens under the kernels vs the plain attention path (attn_logits={GRAD_REF_LOGITS!r}) on "
        f"the same batches: {len(differ)} of {n} requests differ"
        + (f", their searches parting at selections with margins {[round(g, 5) for g in differ]} "
           f"(near-tie tol {tie_tol})" if differ and tie_tol else ""))
    if any(not g <= tie_tol for g in differ):
        raise SystemExit(f"{label}: tokens under the kernels differ from the plain attention path")
    return plain_outs


def serve_ground_and_check(hub, card, caption_res=None):
    """serve_ground: N_GROUND_REQUESTS refcoco requests through the server
    under the hub's BOX defaults, then N_CONSTRAINED_REQUESTS with the bins
    as constraint range: kernel B1 in every dispatch's encoder, the encoder
    output against plain attention, every request 4 tokens + EOS, a request
    whose 4 tokens are bins decoded to a 4-vector box in [0, 1] (the others
    logged by request: no box; under the range every token a bin and every
    box a 4-vector, a planted empty box caught), tokens against
    the plain attention path, the trunk's bf16 output against fp32, p50 and
    requests/s beside serve_caption's; first the host time of the image +
    box preprocessing a request."""
    from ofasys_torch.preprocessor.instruction import Instruction

    gp = hub.general_preprocess
    box = gp.name2pre["box"]
    reqs = _ground_requests()
    con = _ground_requests((box.bin_start, box.bin_end))
    host = []
    for data, _ in reqs:
        t0 = time.perf_counter()
        gp(Instruction(REFCOCO_TPL, split="test").format(**data))
        host.append((time.perf_counter() - t0) * 1e3)
    shapes = ground_dispatch_shapes(gp)
    log(f"  serve_ground: expressions of {GROUND_TEXT[0]}-{GROUND_TEXT[1]} bytes; planned encoder "
        f"(B, T) {shapes}, routes {[_route(hub.model.cfg, B, T, T) for B, T in shapes]}; host ms a "
        f"request of image + box preprocessing (GeneralPreprocess, test split): median "
        f"{statistics.median(host):.3f}, max {max(host):.3f} [host CPU]")
    res = serve_and_check(hub, card, REFCOCO_TPL, reqs, "serve_ground")
    res_c = serve_and_check(hub, card, REFCOCO_TPL, con, "serve_ground_constrained", check_encoder=False)
    eos = hub.global_dict.eos()
    for label, r, constrained in (("serve_ground", res, False), ("serve_ground_constrained", res_c, True)):
        outs = list(map(_best, r["outs"]))
        faults, nobox = _check_boxes(outs, box, eos, constrained)
        log(f"  {label}: tokens per request {sorted(set(len(o.tokens) for o in outs))}; boxes "
            + "; ".join(np.array2string(np.asarray(o.box), precision=3, separator=",") for o in outs)
            + f"; {len(nobox)} of {len(outs)} answers are not four bin tokens and have no box"
            + (f" (requests {nobox})" if nobox else ""))
        if faults:
            raise SystemExit(f"{label}: {faults[:4]}")
        if constrained:
            # the check catches an empty box under the constraint range
            planted = [dataclasses.replace(o) for o in outs]
            planted[0].box = np.zeros(0, np.float32)
            caught = _check_boxes(planted, box, eos, True)[0]
            log(f"  {label}: an empty box planted in request 0 is caught: {caught}")
            if not caught:
                raise SystemExit(f"{label}: the box check missed a planted empty box")
    _tokens_vs_plain(hub, res["calls"] + res_c["calls"], "serve_ground")
    res.update(trunk_check(hub, card))
    res["preprocess_ms"] = statistics.median(host)
    if caption_res is not None:
        log(f"  serve_ground vs serve_caption: p50 {res['p50_ms']} vs {caption_res['p50_ms']} ms, "
            f"{res['requests_per_s']:.2f} vs {caption_res['requests_per_s']:.2f} requests/s [{card}]")
    res["launches_constrained"] = res_c["launches"]
    return res


def rand_augment_ms(card):
    """RandAugment(2, 9) on the host, ms per 224 x 224 image over
    RAND_AUGMENT_IMAGES images (not applied to the grounding batches: it
    moves pixels under the boxes, and refcoco's recipe does not use it)."""
    from ofasys_torch.utils.vision_helper import RandAugment

    imgs = _images(np.random.default_rng(SEED + 9), RAND_AUGMENT_IMAGES)
    ra = RandAugment(2, 9, rng=np.random.default_rng(SEED))
    np.random.seed(SEED)
    t0 = time.perf_counter()
    outs = [ra(a) for a in imgs]
    ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    if any(o.shape != (IMAGE_SIZE, IMAGE_SIZE, 3) or not np.isfinite(o).all() for o in outs):
        raise SystemExit("RandAugment: bad image")
    log(f"  RandAugment(2, 9): {ms:.3f} ms per {IMAGE_SIZE} x {IMAGE_SIZE} image over {len(imgs)} "
        "images [host CPU]")
    return ms


def ground_train_preprocess_ms(gp, n=16):
    """Host ms a refcoco sample of GeneralPreprocess on the train split
    (the joint flip / resize / object-centred crop and the image resize)."""
    from ofasys_torch.preprocessor.instruction import Instruction

    rng = np.random.default_rng(SEED + 10)
    spec = GROUND_TRAIN_TASKS["refcoco"]
    times = []
    for _ in range(n):
        h, w = (int(x) for x in rng.integers(spec["image"][0], spec["image"][1] + 1, 2))
        r = {"img": rng.integers(0, 256, (h, w, 3)).astype(np.float32), "text": _text(rng, *GROUND_TEXT),
             "region_coord": _region(rng, h, w)}
        t0 = time.perf_counter()
        gp(Instruction(REFCOCO_TPL, split="train").format(**r))
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"  train_ground: host ms a refcoco sample on the train split (joint transforms + resize): "
        f"median {statistics.median(times):.3f}, max {max(times):.3f} [host CPU]")
    return statistics.median(times)


def train_ground_and_check(d, gp, card, batches, mm_res=None):
    """train_ground: N_UPDATES summed refcoco B=48 + vqa B=48 updates, both
    through image_resnet at resnet101 (train_and_check: launches of B1 and
    B2 from the planned shapes, a falling loss, each task's loss, one
    update's gradients against the plain attention path, ResNet leaves
    included), the step time beside train_mm's, the peak device memory,
    one update profiled with the convolutions' share."""
    torch.backends.cudnn.benchmark = False
    log("  train_ground: torch.backends.cudnn.benchmark = False: cuDNN picks each convolution's "
        "algorithm by its heuristics, the same in every run; its backward may still add in another "
        "order from run to run, so gradients are held to limits, not bits")
    pre_ms = ground_train_preprocess_ms(gp)
    model = build_train_model(d, "cuda", adaptors=GROUND_ADAPTORS)
    torch.cuda.reset_peak_memory_stats()
    counts, res, (step, state, dev) = train_and_check(model, gp, card, tasks=GROUND_TRAIN_TASKS,
                                                      batches=batches, label="train_ground")
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["preprocess_train_ms"] = pre_ms
    log(f"  train_ground: peak device memory {res['peak_memory_gib']:.2f} GiB (updates and gradient "
        f"checks) [{card}]")
    if mm_res is not None:
        log(f"  train_ground vs train_mm: step {res['step_ms']:.2f} vs {mm_res['step_ms']:.2f} ms, "
            f"{res['samples_per_s']:.1f} vs {mm_res['samples_per_s']:.1f} samples/s [{card}]")
    busy = phase_profile_train(step, state, dev, card, "one grounding update (refcoco B=48 + vqa "
                               "B=48, image_resnet at resnet101)")["busy_ms"]
    trunk = model.net.encoder_adaptor.image_resnet.embed_images
    parts = [trunk_device_ms(trunk, b["net_input"]["slots"][0].value["inputs"], backward=True)
             for b in dev.values()]
    trunk_busy = sum(p[0] for p in parts)
    res["trunk_busy_ms"], res["update_busy_ms"] = trunk_busy, busy
    log(f"  train_ground: the trunk's forward + backward on each task's 48 images, profiled alone: "
        f"{[round(p[0], 3) for p in parts]} ms busy in {[p[1] for p in parts]} launches, "
        f"{100 * trunk_busy / busy:.1f}% of the profiled update's {busy:.2f} ms; top "
        f"{parts[0][2]} [{card}]")
    del model, step, state, dev
    torch.cuda.empty_cache()
    return counts, res


def train_ground_modal_ffn_and_check(d, gp, card, batches):
    """train_ground_modal_ffn: one update of the grounding step on a third
    model from SEED with modal_ffn=True (experts from the batches' slot
    lists): the encoder's spans and the experts they took, a finite loss,
    the launches, gradients against the plain attention path; then one
    generate of 4 serve_ground requests, whose cached decode steps pass no
    spans and need the plain fc1, which an init from slot lists does not
    build: it raises, as ofasys_tpu's apply does."""
    from ofasys_torch import OFASys
    from ofasys_torch.utils.pytree import slots_to_device

    slot_lists = [b["net_input"]["slots"] for b in batches.values()]
    model = build_train_model(d, "cuda", adaptors=GROUND_ADAPTORS, sample_slots=slot_lists, modal_ffn=True)
    net = model.net
    experts = {side: [n for n, _ in getattr(net, side).layers_0.ffn.named_children()]
               for side in ("encoder", "decoder")}
    with torch.no_grad():
        spans = {n: net.encoder_adaptor(slots_to_device([s for s in b["net_input"]["slots"] if s.is_src],
                                                        net.device)).modal_spans
                 for n, b in batches.items()}
    log(f"  train_ground_modal_ffn: encoder spans (start, end, modal id) {spans}; each layer's "
        f"FeedForward children {experts}")
    counts, res, _ = train_and_check(model, gp, card, batches=batches, label="train_ground_modal_ffn",
                                     n_updates=1)
    hub = OFASys(model, None, d, gp, device=net.device)
    recs = [r for r, _ in _ground_requests()[:4]]
    try:
        hub.inference(REFCOCO_TPL, recs)
    except LookupError as e:
        log(f"  train_ground_modal_ffn: generate of {len(recs)} serve_ground requests raises in its "
            f"first decode step, as ofasys_tpu's apply does: {str(e)[:140]}")
        res["generate"] = "raises (no fc1)"
    else:
        raise SystemExit("train_ground_modal_ffn: generate ran without the plain fc1, which "
                         "ofasys_tpu's tree does not hold")
    del model, hub, net
    torch.cuda.empty_cache()
    return counts, res


def _param_bytes(net):
    """Bytes of the net's parameters and buffers (the int8 tables and their
    scales after quantize())."""
    return sum(t.numel() * t.element_size() for t in list(net.parameters()) + list(net.buffers()))


def serve_int8_and_check(hub, card, serve_res=None):
    """serve_int8: the serve phase's requests on a deep copy of the hub's
    model after ``OFASys.quantize()`` (w8a8). Beyond serve_and_check's
    checks: the tokens of every dispatch equal those of the same quantized
    hub with B7's wrapper replaced, here only, by its plain version (the
    integer product is exact, so only the epilogue could differ); prints the
    parameter bytes before and after, p50 and tokens/s beside serve's
    (``serve_res``) and the share of answers equal to the bf16 hub's, then
    profiles one dispatch."""
    import copy

    from ofasys_torch import OFASys
    from ofasys_torch.ops import int8_matmul, quant

    model = copy.deepcopy(hub.model)
    before = _param_bytes(model.net)
    qhub = OFASys(model, None, hub.global_dict, hub.general_preprocess, device=hub.device).quantize()
    after = _param_bytes(model.net)
    int8_bytes = sum(b.numel() for b in model.net.buffers() if b.dtype == torch.int8)
    log(f"serve_int8: parameter bytes {before} before quantize(), {after} after "
        f"({after / before:.3f}x; int8 tables {int8_bytes} B)")
    # the encoder check against plain attention is left out: with int8
    # projections a rounding difference of the attention moves whole int8
    # steps, which later projections carry on (tests/test_torch_quant.py)
    res = serve_and_check(qhub, card, label="serve_int8", check_encoder=False)

    mismatches = 0
    quant.int8_matmul_fwd = int8_matmul.int8_matmul_reference
    try:
        for instruction, data, kw, out in res["calls"]:
            plain = qhub.inference(instruction, data, **kw)
            for a, b in zip(out if isinstance(data, list) else [out],
                            plain if isinstance(data, list) else [plain], strict=True):
                mismatches += not np.array_equal(a.tokens, b.tokens)
    finally:
        quant.int8_matmul_fwd = int8_matmul.int8_matmul_fwd
    log(f"  serve_int8: tokens under B7 vs its plain version on the card: {mismatches} mismatches")
    if mismatches:
        raise SystemExit("serve_int8: the tokens under B7 differ from those of its plain version")
    if serve_res is not None:
        same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(res["outs"], serve_res["outs"]))
        log(f"  serve_int8 vs serve: p50 {res['p50_ms']} vs {serve_res['p50_ms']} ms, "
            f"{res['tokens_per_s']:.1f} vs {serve_res['tokens_per_s']:.1f} tokens/s; "
            f"{same} of {len(res['outs'])} answers equal to the bf16 hub's (information) [{card}]")
    if hub.device.type == "cuda":
        phase_profile(qhub, card, share=B7_KERNEL_NAMES)
    del qhub, model
    return res


def _ln_hub(hub, impl):
    """A second model of the hub's config with ``ln_impl=impl`` and the
    hub's weights."""
    from ofasys_torch import GeneralistModel, OFASys

    model = GeneralistModel(hub.model.cfg, ln_impl=impl)
    model.initialize(hub.global_dict, active_adaptors=ACTIVE_ADAPTORS, dtype=hub.model.net.dtype,
                     device=hub.device, seed=SEED)
    model.net.load_state_dict(hub.model.net.state_dict())
    return OFASys(model, None, hub.global_dict, hub.general_preprocess, device=hub.device)


def serve_ln_and_check(hub, card):
    """serve_ln: one dispatch of the serve mix (the first 8 beam requests)
    with ln_impl='pallas' (kernel B6-fwd in every stack LayerNorm), and the
    first decode step's logits against the hub's (ln_impl='xla') on the same
    records."""
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.utils.pytree import slots_to_device

    ln_hub = _ln_hub(hub, "pallas")
    res = serve_and_check(ln_hub, card, reqs=_serve_requests()[:8], label="serve_ln")
    gp = hub.general_preprocess
    sample = gp.collate([gp(Instruction(TPL, split="test").format(**r))
                         for r, _ in _serve_requests()[:8]])
    slots = slots_to_device(sample["net_input"]["slots"], hub.device)
    with torch.no_grad():
        got = ln_hub.model.net(slots)[0][:, 0].float()
        ref = hub.model.net(slots)[0][:, 0].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  serve_ln: first-step logits {tuple(got.shape)}, B6 vs ln_impl='xla': rel {rel:.3e} "
        f"(tol {LN_LOGIT_REL_TOL}), max abs {(got - ref).abs().max().item():.3e}")
    if not rel <= LN_LOGIT_REL_TOL:
        raise SystemExit("serve_ln: the logits under B6 disagree with the default LayerNorm")
    del ln_hub
    return res


def train_ln_and_check(d, gp, card, arch="base", tasks=None, batches=None):
    """train_ln: the train phase's updates with ln_impl='pallas', then one
    ln_impl='hybrid' update; the gradients of each against a model with
    ln_impl='xla' and the same parameters. Returns the launch counts and
    results of both runs."""
    device = "cuda" if card != "cpu" else "cpu"
    ref = build_train_model(d, device, arch)
    out = {}
    for impl, label, n in (("pallas", "train_ln", N_UPDATES), ("hybrid", "train_ln_hybrid", 1)):
        model = build_train_model(d, device, arch, ln_impl=impl)
        counts, res, (step, state, dev) = train_and_check(
            model, gp, card, tasks=tasks, batches=batches, label=label, grad_ref=ref, n_updates=n)
        out[label] = (counts, res)
        if impl == "pallas" and card != "cpu":       # B6-bwd's device time in one update
            phase_profile_train(step, state, dev, card, "one train_ln update", share=("ln_bwd",))
        del step, state, dev
        del model
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _dense_bwd_switch(value):
    """OFASYS_DENSE_BWD set to ``value`` (None: unset) inside, restored after."""
    saved = os.environ.get("OFASYS_DENSE_BWD")
    try:
        if value is None:
            os.environ.pop("OFASYS_DENSE_BWD", None)
        else:
            os.environ["OFASYS_DENSE_BWD"] = value
        yield
    finally:
        if saved is None:
            os.environ.pop("OFASYS_DENSE_BWD", None)
        else:
            os.environ["OFASYS_DENSE_BWD"] = saved


def train_rowmajor_and_check(d, gp, card, arch="base", tasks=None, batches=None, mm_res=None):
    """train_rowmajor: train_mm's updates on a model from the same seed with
    OFASYS_DENSE_BWD=rowmajor set for the phase and restored after: kernel
    B2r once per dense attention and B2 not at all (train_and_check's launch
    check reads the switch), a falling loss, one update's gradients against
    the plain attention path; then the same update's gradients under B2r
    against B2's, from the same weights and batches (GRAD_FROB_TOL over all
    leaves: the two kernels round at the same points and differ only in the
    order of their fp32 sums). Prints the step time beside train_mm's
    (``mm_res``). Returns the launch counts and the results."""
    from ofasys_torch.engine.criterion import (
        LabelSmoothedCrossEntropyCriterion,
        LabelSmoothedCrossEntropyCriterionConfig,
    )

    device = "cuda" if card != "cpu" else "cpu"
    model = build_train_model(d, device, arch)
    with _dense_bwd_switch("rowmajor"):
        counts, res, (_, state, dev) = train_and_check(model, gp, card, tasks=tasks, batches=batches,
                                                       label="train_rowmajor")
    crit = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(),
                                              pad_id=model.global_dict.pad())
    names = [n for n, _ in model.net.named_parameters()]
    saved = model.cfg.dropout
    model.cfg.dropout = 0.0
    try:
        reset_counts()
        with _dense_bwd_switch("rowmajor"):
            g_row = _grads(model, crit, state.params, state.step, dev)
        n_row = read_counts()
        reset_counts()
        with _dense_bwd_switch(None):
            g_t = _grads(model, crit, state.params, state.step, dev)
        n_t = read_counts()
    finally:
        model.cfg.dropout = saved
    rel, norm_rel, leaves = _grad_diff(names, g_row, g_t)
    log(f"  train_rowmajor: gradients of one update under B2r ({n_row['dense_attention_bwd_rowmajor']} "
        f"launches, {n_row['dense_attention_bwd']} of B2) vs under B2 ({n_t['dense_attention_bwd']} "
        f"launches, {n_t['dense_attention_bwd_rowmajor']} of B2r), same weights and batches, dropout 0: "
        f"rel {rel:.3e} (tol {GRAD_FROB_TOL}), global norm rel err {norm_rel:.3e}, worst leaves "
        f"{_top_leaves(leaves)}")
    if device == "cuda" and (n_row["dense_attention_bwd"] or n_t["dense_attention_bwd_rowmajor"]
                             or n_row["dense_attention_bwd_rowmajor"] != n_t["dense_attention_bwd"]
                             or not n_row["dense_attention_bwd_rowmajor"]):
        raise SystemExit("train_rowmajor: the switch did not move every dense backward to B2r")
    if not rel <= GRAD_FROB_TOL:
        raise SystemExit("train_rowmajor: gradients under B2r disagree with those under B2")
    res = dict(res, vs_b2_rel=rel, vs_b2_norm_rel=norm_rel)
    if mm_res is not None:
        log(f"train_rowmajor: step {res['step_ms']:.2f} ms, {res['samples_per_s']:.1f} samples/s "
            f"(train_mm: {mm_res['step_ms']:.2f} ms, {mm_res['samples_per_s']:.1f} samples/s) [{card}]")
    return counts, res


# ------------------------------------------------------------- training
_WORDS = ["the", "storm", "moved", "north", "over", "the", "coast", "on", "monday", "and",
          "officials", "said", "that", "schools", "would", "stay", "closed", "for", "two",
          "days", "while", "crews", "repair", "power", "lines", "12", "345", "city"]


def _text(rng, lo, hi):
    n = int(rng.integers(lo, hi + 1))
    s = ""
    while len(s) < n:
        s += rng.choice(_WORDS) + " "
    return s[:n].strip().ljust(n, "x")


def make_train_batches(gp, tasks=None):
    """One collated batch (numpy) per task, from seeded text, images, wavs
    and motion features, through Instruction(template, split="train") ->
    GeneralPreprocess -> collate: span masking runs on the text_infilling
    source, SpecAugment on the asr wavs, a random crop on the motion clips.
    A task's spec names its text columns with their lengths in bytes and,
    under ``image``, the side of the ``img`` column's square images, under
    ``audio`` the seconds of the ``wav`` column's wavs, under ``motion``
    the frames of the ``bvh`` column's (frames, MOTION_FEAT) features, under
    ``code_image`` the side of the ``code`` column's square images (an
    image_vqgan target, encoded to codes by the preprocessor's VQGAN)."""
    from ofasys_torch.preprocessor.instruction import Instruction

    rng = np.random.default_rng(SEED + 1)
    out = {}
    for name, spec in (tasks or TRAIN_TASKS).items():
        columns = [c for c in spec if c not in ("template", "batch", "image", "audio", "motion",
                                                "criterion", "region", "code_image")]
        recs = [{c: _text(rng, *spec[c]) for c in columns} for _ in range(spec["batch"])]
        if isinstance(spec.get("image"), tuple):
            for r in recs:
                h, w = (int(x) for x in rng.integers(spec["image"][0], spec["image"][1] + 1, 2))
                r["img"] = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
                if spec.get("region"):
                    r["region_coord"] = _region(rng, h, w)
        elif "image" in spec:
            for r, a in zip(recs, _images(rng, len(recs), spec["image"])):
                r["img"] = a
        if "code_image" in spec:
            for r, a in zip(recs, _images(rng, len(recs), spec["code_image"])):
                r["code"] = a
        for r in recs:
            if "audio" in spec:
                r["wav"] = _wav_bytes(rng, rng.uniform(*spec["audio"]))
            if "motion" in spec:
                n = int(rng.integers(spec["motion"][0], spec["motion"][1] + 1))
                r["bvh"] = rng.standard_normal((n, MOTION_FEAT)).astype(np.float32)
        out[name] = gp.collate([gp(Instruction(spec["template"], split="train").format(**r))
                                for r in recs])
    return out


def _region(rng, h, w):
    """A seeded box of at least 16 pixels a side inside an h x w image, as
    {"box": [x0, y0, x1, y1], "width": w, "height": h}."""
    bw, bh = rng.uniform(16, 0.6 * w), rng.uniform(16, 0.6 * h)
    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    return {"box": [float(x0), float(y0), float(x0 + bw), float(y0 + bh)],
            "width": float(w), "height": float(h)}


def _task_shapes(batch):
    """(B, encoder tokens, decoder tokens) of a collated batch: a text
    target counts its tokens, a motion target its frames."""
    slots = batch["net_input"]["slots"]
    B, Ts = _encoder_tokens(slots)
    target = [s for s in slots if not s.is_src][-1].value
    Tt = (target["inputs"] if "inputs" in target else target["value"]).shape[1]
    return B, Ts, Tt


def _full_context(batch):
    """The decoder runs without the causal mask (the diffusion target)."""
    from ofasys_torch import ModalityType

    return [s for s in batch["net_input"]["slots"] if not s.is_src][-1].modality == ModalityType.MOTION


def train_shapes(batches):
    """[(label, (B, Tq, Tk), causal)] of the attention calls of one update:
    encoder self, decoder self (causal, folded into the bias; full context
    for a motion target) and cross."""
    shapes = []
    for name, b in batches.items():
        B, Ts, Tt = _task_shapes(b)
        dec = (f"{name}_decoder_full", False) if _full_context(b) else (f"{name}_decoder_causal", True)
        shapes += [(f"{name}_encoder", (B, Ts, Ts), False),
                   (dec[0], (B, Tt, Tt), dec[1]),
                   (f"{name}_cross", (B, Tt, Ts), False)]
    return shapes


def make_criteria(batches, pad, tasks=None, ce_kw=None, global_dict=None):
    """Each task's criterion: label-smoothed CE (its config fields
    ``ce_kw``, e.g. ``chunked_vocab``), or the spec's ``criterion``:
    'speech_to_text' (speech_to_text_loss), 'speech_to_text_ctc' (the same
    with ctc_weight CTC_WEIGHT on text_phone targets), 'diffusion'
    (diffusion_criterion), 'tacotron2' (ofa_tacotron2 with the guided
    attention loss) or 'speech_pretrain' (speech_pretrain_loss at its
    mask_prob of 0.65, projecting onto ``global_dict``'s <phone> rows: with
    none there, as in ofasys_tpu, its KL term is 0 and the teacher's
    encoder still runs)."""
    from ofasys_torch.engine.criterion import (
        DiffusionCriterion,
        DiffusionCriterionConfig,
        LabelSmoothedCrossEntropyCriterion,
        LabelSmoothedCrossEntropyCriterionConfig,
        SpeechPretrainCriterion,
        SpeechPretrainCriterionConfig,
        SpeechToTextCriterion,
        SpeechToTextCriterionConfig,
        Tacotron2Criterion,
        Tacotron2CriterionConfig,
    )

    kinds = {"speech_to_text": (SpeechToTextCriterion, SpeechToTextCriterionConfig, {}),
             "speech_to_text_ctc": (SpeechToTextCriterion, SpeechToTextCriterionConfig,
                                    dict(ctc_weight=CTC_WEIGHT)),
             "diffusion": (DiffusionCriterion, DiffusionCriterionConfig, {}),
             "tacotron2": (Tacotron2Criterion, Tacotron2CriterionConfig,
                           dict(use_guided_attention_loss=True)),
             "speech_pretrain": (SpeechPretrainCriterion, SpeechPretrainCriterionConfig, {}),
             None: (LabelSmoothedCrossEntropyCriterion, LabelSmoothedCrossEntropyCriterionConfig,
                    ce_kw or {})}
    out = {}
    for name in batches:
        kind = (tasks or {}).get(name, {}).get("criterion")
        cls, cfg, kw = kinds[kind]
        out[name] = cls(cfg(**kw), pad_id=pad)
        out[name].global_dict = global_dict
    return out


def _expected_train_launches(batches, cfg, net=None, tasks=None):
    """Launches of each kernel one update should make: every attention call
    (encoder self, decoder self, cross) on the flash route runs B3 and the
    one backward pass that stands for B4-dq, B4-dkv and B5
    (flash_attention_bwd; the part wrappers launch nothing of their own);
    on the dense route B1 and B2
    (``_route``, as MultiheadAttention decides), or B1 and B2r while
    OFASYS_DENSE_BWD=rowmajor is set. A task under speech_pretrain_loss
    (``tasks``) also runs its teacher's encoder, forward only."""
    n = dict.fromkeys(KERNELS, 0)
    dense_bwd = "dense_attention_bwd_rowmajor" if os.environ.get("OFASYS_DENSE_BWD") == "rowmajor" \
        else "dense_attention_bwd"
    for name, b in batches.items():
        B, Ts, Tt = _task_shapes(b)
        calls = [(Ts, Ts, cfg.encoder.layers), (Tt, Tt, cfg.decoder.layers),
                 (Tt, Ts, cfg.decoder.layers)]
        for Tq, Tk, layers in calls:
            route = _route(cfg, B, Tq, Tk, cfg.attention_dropout)
            if route == "dense":
                n["dense_attention_fwd"] += layers
                n[dense_bwd] += layers
            elif route == "flash":
                n["flash_attention_fwd"] += layers
                n["flash_attention_bwd"] += layers
        if (tasks or {}).get(name, {}).get("criterion") == "speech_pretrain":
            route = _route(cfg, B, Ts, Ts)
            if route != "plain":
                n[f"{route}_attention_fwd"] += cfg.encoder.layers
    if cfg.quant_training == "fwd":
        n["int8_matmul_fwd"] += len(batches) * qat_projections(cfg)
    if net is not None:
        # B6 (ln_impl): every stack LayerNorm once per task's forward and
        # backward; B6-fwd only where the forward is fused
        from ofasys_torch.ops.layer_norm import FusedLayerNorm

        lns = [m for m in net.modules() if isinstance(m, FusedLayerNorm)]
        n["layer_norm_fwd"] += len(batches) * sum(m.mode == "fused" for m in lns)
        n["layer_norm_bwd"] += len(batches) * len(lns)
    return n


def qat_projections(cfg):
    """B7 launches of one task's training forward under quant_training='fwd':
    an encoder layer's q/k/v (one fused call under fuse_qkv, else three),
    out, fc1 and fc2; a decoder layer's self q/k/v (1 or 3), out, cross q,
    cross k/v (1 or 2), out, fc1 and fc2. 4 + 7 per layer pair fused."""
    f = cfg.fuse_qkv
    return (cfg.encoder.layers * ((1 if f else 3) + 3)
            + cfg.decoder.layers * ((1 if f else 3) + 1 + 1 + (1 if f else 2) + 1 + 2))


def build_train_model(d, device, arch="base", dtype=torch.bfloat16, ln_impl="xla",
                      adaptors=ACTIVE_ADAPTORS, sample_slots=None, **cfg_kw):
    """The arch at full width with random weights from SEED; dropout keeps
    its default of 0.1, attention dropout its default of 0. ``cfg_kw`` sets
    other config fields (``modal_ffn``, whose experts follow the slot lists
    ``sample_slots``)."""
    from ofasys_torch import GeneralistModel

    t0 = time.perf_counter()
    model = GeneralistModel(arch=arch, ln_impl=ln_impl, **cfg_kw)
    model.initialize(d, active_adaptors=adaptors, dtype=dtype, device=device, seed=SEED,
                     sample_slots=sample_slots)
    cfg = model.cfg
    log(f"train: {arch} arch E={cfg.encoder.embed_dim} ffn={cfg.encoder.ffn_embed_dim} "
        f"heads={cfg.encoder.attention_heads} layers={cfg.encoder.layers}+{cfg.decoder.layers} "
        f"vocab={len(d)} adaptors={adaptors} dropout={cfg.dropout} ln_impl={cfg.ln_impl} "
        f"modal_ffn={cfg.modal_ffn} built in {time.perf_counter() - t0:.1f} s")
    return model


def _grads(model, crit, params, step, batches):
    """One update's raw-summed gradients over every task (no optimizer);
    ``crit`` is one criterion or one per task."""
    from ofasys_torch.engine.train_step import make_grad_step

    total = None
    for i, (name, b) in enumerate(batches.items()):
        c = crit[name] if isinstance(crit, dict) else crit
        g, _, _ = make_grad_step(model, c, fold=i)(params, step, b, SEED)
        total = g if total is None else [a + c for a, c in zip(total, g)]
    return total


def _grad_diff(names, got, ref):
    """|got - ref| / |ref| over all leaves, the relative error of the global
    norm, and {leaf: relative error} for every leaf but the key-side biases
    (NOISE_MODULES)."""
    diff = torch.sqrt(sum(((a - b).float() ** 2).sum() for a, b in zip(got, ref)))
    ref_n = torch.sqrt(sum((b.float() ** 2).sum() for b in ref))
    got_n = torch.sqrt(sum((a.float() ** 2).sum() for a in got))
    leaves = {}
    for name, a, b in zip(names, got, ref):
        path = name.rsplit(".", 2)
        if name.endswith(".bias") and len(path) > 1 and path[-2] in NOISE_MODULES:
            continue
        nb = b.float().norm().item()
        if nb > 0:
            leaves[name] = ((a - b).float().norm() / nb).item()
    return (diff / ref_n).item(), (abs(got_n - ref_n) / ref_n).item(), leaves


def _top_leaves(leaves, n=3):
    return ", ".join(f"{k} {r:.3e}" for k, r in sorted(leaves.items(), key=lambda kv: -kv[1])[:n])


def train_and_check(model, gp, card, tasks=None, batches=None, label="train", grad_batches=None,
                    grad_ref=None, n_updates=N_UPDATES, ce_kw=None):
    """Drive the training path: ``n_updates`` summed multi-task updates
    through make_multitask_train_step, each task under its spec's criterion
    (:func:`make_criteria`), then check what came out; the gradient check
    runs on ``grad_batches`` when given, against the plain attention path
    or, with ``grad_ref``, against that model (another ``ln_impl``) at the
    same parameters. Returns the kernel launch counts of that run, its
    results, and the step, state and batches."""
    from ofasys_torch.configure.configs import OptimizationConfig
    from ofasys_torch.engine.optim import build_optimizer
    from ofasys_torch.engine.train_step import TrainState, make_multitask_train_step
    from ofasys_torch.utils.pytree import sample_to_device

    device, cfg = model.net.device, model.cfg
    batches = batches or make_train_batches(gp, tasks)
    for name, b in batches.items():
        B, Ts, Tt = _task_shapes(b)
        log(f"  task {name}: B={B} encoder T={Ts} decoder T={Tt} target tokens={b['ntokens']}")
    dev = {n: sample_to_device(b, device) for n, b in batches.items()}
    crit = make_criteria(batches, model.global_dict.pad(), tasks, ce_kw, model.global_dict)
    opt = build_optimizer(OptimizationConfig(lr=(TRAIN_LR,)))
    state = TrainState.create(model.net, opt)
    step = make_multitask_train_step(model, crit, opt)
    n_samples = sum(b["nsentences"] for b in batches.values())

    # warm-up update (allocator, cuBLAS handles) outside the measured run
    state, _ = step(state, dev, SEED)
    _sync(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    outs, times = [], []
    for _ in range(n_updates):
        t0 = time.perf_counter()
        state, out = step(state, dev, SEED)
        _sync(device)
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None

    losses, gnorms = [], []
    for out in outs:
        tasks_out = out["tasks"].values()
        losses.append(sum(float(t["loss"]) for t in tasks_out)
                      / sum(float(t["sample_size"]) for t in tasks_out))
        gnorms.append(float(out["gnorm"]))
    per_task = {n: [round(float(o["tasks"][n]["loss"]) / float(o["tasks"][n]["sample_size"]), 4)
                    for o in outs] for n in dev}
    log(f"  {label}: loss per token over the {n_updates} updates: {[round(x, 5) for x in losses]}; "
        f"per task {per_task}; gnorm {[round(x, 4) for x in gnorms]}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        raise SystemExit("a training loss or gnorm is not finite")
    if n_updates > 1 and not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall over {n_updates} updates on repeated batches")
    step_ms = statistics.median(times) * 1e3
    task_logs = {n: {k: [float(o["tasks"][n][k]) for o in outs] for k in outs[0]["tasks"][n]
                     if k in ("ce_loss", "ctc_loss")} for n in dev}
    n_tokens = sum(int(b["ntokens"]) + _task_shapes(b)[0] * _task_shapes(b)[1]
                   for b in batches.values())
    if peak_gib is not None:
        log(f"  {label}: peak device memory over the {n_updates} updates {peak_gib:.3f} GiB [{card}]")
    log(f"  {label}: step time {step_ms:.2f} ms (median of {n_updates}; all "
        f"{[round(t * 1e3, 2) for t in times]}), {n_samples} samples per update = "
        f"{n_samples / (step_ms / 1e3):.1f} samples/s, {n_tokens} source+target tokens per "
        f"update [{card}]")

    per_update = _expected_train_launches(batches, cfg, model.net, tasks)
    expected = {n: n_updates * c for n, c in per_update.items()}
    log(f"  {label}: launches {launches} (expected {expected}; per update {per_update})")
    if device.type == "cuda":
        if launches != expected or not any(expected.values()):
            raise SystemExit(f"{label}: a kernel did not run once per attention call of its route")
    else:
        log("  (CPU rehearsal: the plain versions stand in, no launch is counted)")

    # one update's gradients, kernels vs plain attention, dropout 0
    names = [n for n, _ in model.net.named_parameters()]
    gdev = dev if grad_batches is None else {n: sample_to_device(b, device)
                                             for n, b in grad_batches.items()}
    result = dict(step_ms=step_ms, samples_per_s=n_samples / (step_ms / 1e3), losses=losses,
                  peak_updates_gib=peak_gib, task_logs={n: v for n, v in task_logs.items() if v})
    if grad_ref is not None:
        return launches, {**result, **_grads_vs(model, grad_ref, crit, state, gdev, label)}, \
            (step, state, dev)
    saved = cfg.dropout, cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits
    cfg.dropout = 0.0
    g_plain = {}
    try:
        g_kernel = _grads(model, crit, state.params, state.step, gdev)
        cfg.attn_kernel, cfg.use_flash_attention = "xla", False
        for logits in GRAD_PLAIN_LOGITS:
            cfg.attn_logits = logits
            g_plain[logits] = _grads(model, crit, state.params, state.step, gdev)
    finally:
        cfg.dropout, cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved
    n_grad = sum(b['nsentences'] for b in (grad_batches or batches).values())
    cmp = {logits: _grad_diff(names, g_kernel, g) for logits, g in g_plain.items()}
    for logits, (rel_l, norm_l, leaves) in cmp.items():
        log(f"  {label}: gradients of one update on {n_grad} samples, kernels vs plain attention "
            f"with attn_logits={logits!r} (dropout 0): |g_kernel - g_plain| / |g_plain| {rel_l:.3e}, "
            f"global norm rel err {norm_l:.3e}, worst leaves {_top_leaves(leaves)}")
    worst_c = max(cmp["compute"][2], key=cmp["compute"][2].get)
    _, _, own = _grad_diff(names, g_plain["compute"], g_plain["fp32"])
    log(f"  {label}: plain 'compute' vs plain 'fp32' logits: at {worst_c} {own[worst_c]:.3e}; "
        f"worst leaves {_top_leaves(own)}")
    rel, norm_rel, leaves = cmp[GRAD_REF_LOGITS]
    worst_name = max(leaves, key=leaves.get)
    worst = leaves[worst_name]
    trunk = {k: v for k, v in leaves.items() if ".embed_images." in k}
    if trunk:
        by_kind = {kind: max(((v, k) for k, v in trunk.items() if k.endswith("." + kind)),
                             default=(0.0, "embed_images.none"))
                   for kind in ("kernel", "scale", "bias", "mean", "var")}
        log(f"  {label}: the ResNet trunk's {len(trunk)} leaves against attn_logits="
            f"{GRAD_REF_LOGITS!r}, worst of each kind: "
            + ", ".join(f"{kind} {v:.3e} ({k.split('embed_images.')[1]})" for kind, (v, k) in by_kind.items()))
    log(f"  {label}: checked against attn_logits={GRAD_REF_LOGITS!r}: rel {rel:.3e} "
        f"(tol {GRAD_REL_TOL}), worst leaf {worst_name} {worst:.3e} (tol {LEAF_REL_TOL})")
    if not rel <= GRAD_REL_TOL or not worst <= LEAF_REL_TOL:
        raise SystemExit(f"{label}: gradients under the kernels disagree with the plain attention path")
    return launches, dict(**result, grad_rel=rel, grad_norm_rel=norm_rel,
                          grad_worst_leaf=worst, grad_worst_leaf_name=worst_name,
                          grad_by_logits={lg: dict(rel=r, worst=max(lv.values()),
                                                   worst_leaf=max(lv, key=lv.get))
                                          for lg, (r, _, lv) in cmp.items()}), (step, state, dev)


def _grads_vs(model, ref, crit, state, batches, label):
    """One update's gradients (dropout 0) of ``model`` against ``ref``, a
    model of another ln_impl given the same parameters, both with the
    attention kernels: GRAD_REL_TOL over all leaves, LEAF_REL_TOL per leaf
    (the key-side biases left out, as in the train phase)."""
    names = [n for n, _ in model.net.named_parameters()]
    with torch.no_grad():
        for p, q in zip(ref.net.parameters(), state.params, strict=True):
            p.copy_(q)
    saved = model.cfg.dropout, ref.cfg.dropout
    model.cfg.dropout = ref.cfg.dropout = 0.0
    try:
        got = _grads(model, crit, state.params, state.step, batches)
        want = _grads(ref, crit, list(ref.net.parameters()), state.step, batches)
    finally:
        model.cfg.dropout, ref.cfg.dropout = saved
    rel, norm_rel, leaves = _grad_diff(names, got, want)
    worst_name = max(leaves, key=leaves.get)
    log(f"  {label}: gradients of one update vs ln_impl={ref.cfg.ln_impl!r} at the same parameters "
        f"(dropout 0): rel {rel:.3e} (tol {GRAD_REL_TOL}), global norm rel err {norm_rel:.3e}, "
        f"worst leaves {_top_leaves(leaves)} (tol {LEAF_REL_TOL})")
    if not rel <= GRAD_REL_TOL or not leaves[worst_name] <= LEAF_REL_TOL:
        raise SystemExit(f"{label}: gradients disagree with ln_impl={ref.cfg.ln_impl!r}")
    return dict(grad_rel=rel, grad_norm_rel=norm_rel, grad_worst_leaf=leaves[worst_name],
                grad_worst_leaf_name=worst_name)


def phase_profile_train(step, state, batches, card,
                        what="one training update (text_infilling B=128 + gigaword B=64)",
                        share=None):
    """One training update under torch.profiler (``share`` as in
    :func:`_report_profile`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches, SEED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _report_profile(prof, wall_ms, what, card, share)


# ------------------------------------------- decode extras, training options
def _answer_table(n=N_ANSWERS):
    """``n`` distinct answers of 1-3 words from a seeded vocabulary of 400
    pseudo-words of 2-8 letters."""
    rng = np.random.default_rng(SEED + 9)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    vocab = ["".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(400)]
    answers, seen = [], set()
    while len(answers) < n:
        a = " ".join(rng.choice(vocab, int(rng.integers(1, 4))))
        if a not in seen:
            seen.add(a)
            answers.append(a)
    return answers


def closed_set_preprocess(d):
    """The text preprocessor with an ans2label table of N_ANSWERS answers
    (written as JSON to a temporary file and read back), on dictionary
    ``d``; returns (GeneralPreprocess, answers)."""
    import tempfile

    from ofasys_torch.preprocessor.general import GeneralPreprocess
    from ofasys_torch.preprocessor.text import TextPreprocessConfig

    answers = _answer_table()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ans2label.json")
        with open(path, "w") as f:
            json.dump({a: i for i, a in enumerate(answers)}, f)
        gp = GeneralPreprocess(d, active=["text", "image"],
                               text_cfg=TextPreprocessConfig(ans2label_file=path))
    return gp, answers


def _closed_requests(trie):
    """serve_closed: N_CLOSED_REQUESTS images, beam 5 under the trie."""
    imgs = _images(np.random.default_rng(SEED + 10), N_CLOSED_REQUESTS)
    return [({"img": a}, {"max_len_b": CLOSED_MAX_LEN, "beam_size": 5, "constraint_trie": trie})
            for a in imgs]


def closed_dispatch_shapes(gp):
    """(B, T) of serve_closed's two dispatches of 8."""
    recs = [r for r, _ in _closed_requests(None)]
    return [_encoder_shape(gp, recs[i:i + 8], CLOSED_TPL) for i in range(0, len(recs), 8)]


def serve_closed_and_check(hub, card):
    """serve_closed: the closed-set template (image_classify's,
    task/tasks.py:81) through the server with the text preprocessor's trie
    over N_ANSWERS answers: kernel B1 in every dispatch's encoder (and the
    encoder output against plain attention), every answer one of the table's,
    the tokens equal to the plain attention path's on the same batches but
    where the searches part at a near-tie (CLOSED_TIE_TOL)."""
    from ofasys_torch import OFASys

    t0 = time.perf_counter()
    gp, answers = closed_set_preprocess(hub.global_dict)
    trie = gp.name2pre["text"].constraint_trie
    log(f"serve_closed: ans2label of {len(answers)} answers of 1-3 words (longest "
        f"{max(len(a) for a in answers)} bytes) and its trie in {time.perf_counter() - t0:.2f} s "
        f"[host CPU]")
    chub = OFASys(hub.model, None, hub.global_dict, gp, device=hub.device)
    res = serve_and_check(chub, card, CLOSED_TPL, _closed_requests(trie), "serve_closed")
    table = set(answers)
    outside = [o.text for o in map(_best, res["outs"]) if o.text not in table]
    log(f"  serve_closed: {len(res['outs']) - len(outside)} of {len(res['outs'])} answers in the "
        f"answer set; e.g. {[_best(o).text for o in res['outs'][:4]]}")
    plain = _tokens_vs_plain(chub, res["calls"], "serve_closed", CLOSED_TIE_TOL)
    outside += [o.text for o in plain if o.text not in table]
    if outside:
        raise SystemExit(f"serve_closed: answers outside the closed set: {outside[:4]}")
    return res


def serve_sample_and_check(hub, card, serve_res=None):
    """serve_sample: serve's 16 requests (12 beam 5, 4 greedy) with the
    hub's IMAGE sampling defaults (top-k 256) at seed SEED, then with top-p
    0.9: served answers equal direct inference at the same seed (in
    serve_and_check), another seed changes some tokens, and top-k 1 gives
    greedy search's tokens."""
    base = _serve_requests()

    def with_opts(extra):
        return [(d, {**o, **extra}) for d, o in base]

    res = serve_and_check(hub, card, reqs=with_opts({"sampling": True, "sampling_topk": 256, "seed": SEED}),
                          label="serve_sample", check_encoder=False)
    differ = n = 0
    for instruction, data, kw, out in res["calls"]:
        other = hub.inference(instruction, data, **{**kw, "seed": SEED + 1})
        for a, b in zip(out, other, strict=True):
            n += 1
            differ += not np.array_equal(a.tokens, b.tokens)
    log(f"  serve_sample: seed {SEED + 1} against seed {SEED}: {differ} of {n} requests differ")
    if not differ:
        raise SystemExit("serve_sample: another seed gave the same tokens")
    res_p = serve_and_check(hub, card, reqs=with_opts({"sampling": True, "sampling_topp": 0.9, "seed": SEED}),
                            label="serve_sample_topp", check_encoder=False)
    mism, ties, n = _top1_vs_greedy(hub, res["calls"])
    log(f"  serve_sample: sampling_topk=1 vs greedy search (beam 1) on the same batches: {len(mism)} of "
        f"{n} differ, each first at a step where the bf16 logits tie at the maximum: {ties}")
    if len(mism) != ties:
        raise SystemExit("serve_sample: top-k 1 sampling differs from greedy search off a tie")
    if serve_res is not None:
        log(f"  serve_sample vs serve: p50 {res['p50_ms']} (top-p: {res_p['p50_ms']}) vs "
            f"{serve_res['p50_ms']} ms [{card}]")
    return res, res_p


def _top1_vs_greedy(hub, calls):
    """Each recorded batch under sampling with top-k 1 and under greedy
    search, both at beam 1: the same computation until the sampled token
    differs, which can only happen where the step's log-probs hold their
    maximum more than once (bf16 logits tie), the one place top-k 1 keeps
    several tokens. Returns the differing requests, how many of them first
    differ at such a tie, and the number of requests."""
    from ofasys_torch.generator import search

    orig = search.top_k_top_p_filter
    kept = []

    def record(lp, k, p):
        out = orig(lp, k, p)
        kept.append((out > NEG_SCORE).sum(dim=-1).cpu())
        return out

    mism, ties, n = [], 0, 0
    for instruction, data, kw, _ in calls:
        base = {k: v for k, v in kw.items() if k not in ("sampling", "sampling_topk", "seed", "beam_size")}
        kept.clear()
        search.top_k_top_p_filter = record
        try:
            top1 = hub.inference(instruction, data, **base, beam_size=1, sampling=True, sampling_topk=1)
        finally:
            search.top_k_top_p_filter = orig
        steps = list(kept)
        greedy = hub.inference(instruction, data, **base, beam_size=1)
        for row, (a, b) in enumerate(zip(top1, greedy, strict=True)):
            n += 1
            if np.array_equal(a.tokens, b.tokens):
                continue
            mism.append(row)
            t = next(i for i in range(min(len(a.tokens), len(b.tokens)) + 1)
                     if i >= min(len(a.tokens), len(b.tokens)) or a.tokens[i] != b.tokens[i])
            ties += t < len(steps) and int(steps[t][row]) > 1
    return mism, ties, n


def serve_diverse_and_check(hub, card):
    """serve_diverse: serve's 12 beam requests under diverse_beam (beam 4, 2
    groups) and diverse_siblings (beam 5), N_BEST hypotheses each: served
    against direct inference (serve_and_check) and the count of hypotheses
    that plain beam search's N_BEST on the same batches does not hold."""
    out = {}
    for name, opts in DIVERSE.items():
        reqs = [(d, {**o, **opts, "return_n_best": N_BEST}) for d, o in _serve_requests()[:N_BEAM_REQUESTS]]
        res = serve_and_check(hub, card, reqs=reqs, label=f"serve_{name}", check_encoder=False)
        new = total = 0
        for instruction, data, kw, served in res["calls"]:
            plain_kw = {k: v for k, v in kw.items() if k not in opts or k == "beam_size"}
            plain = hub.inference(instruction, data, **plain_kw)
            for hyps, ref in zip(served, plain, strict=True):
                known = {tuple(h.tokens) for h in ref}
                total += len(hyps)
                new += sum(tuple(h.tokens) not in known for h in hyps)
        log(f"  serve_{name}: {new} of {total} hypotheses are not in plain beam search's "
            f"{N_BEST}-best at beam {opts['beam_size']} (information)")
        res["not_in_plain"] = (new, total)
        out[name] = res
    return out


def _lexical_requests(gp):
    """serve_lexical: N_LEXICAL_REQUESTS gigaword-style sources of
    LEXICAL_SRC bytes, each with 1-3 constraints of 1-3 tokens taken from
    its own source's tokens."""
    rng = np.random.default_rng(SEED + 11)
    text = gp.name2pre["text"]
    recs, cons = [], []
    for src in _sources(rng, rng.integers(LEXICAL_SRC[0], LEXICAL_SRC[1] + 1, N_LEXICAL_REQUESTS)):
        toks = text.encode(src)[1:].tolist()
        c = []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(1, 4))
            i = int(rng.integers(0, len(toks) - n))
            c.append(toks[i:i + n])
        recs.append({"src": src})
        cons.append(c)
    return recs, cons


def lexical_dispatch_shapes(gp):
    recs, _ = _lexical_requests(gp)
    return [_encoder_shape(gp, recs[i:i + 8], SUMMARY_TPL) for i in range(0, len(recs), 8)]


def _contains(seq, sub):
    return any(seq[i:i + len(sub)] == sub for i in range(len(seq) - len(sub) + 1))


def _in_order(seq, cons):
    """Every constraint appears, each after the end of the one before."""
    pos = 0
    for c in cons:
        i = next((j for j in range(pos, len(seq) - len(c) + 1) if seq[j:j + len(c)] == c), None)
        if i is None:
            return False
        pos = i + len(c)
    return True


def serve_lexical_and_check(hub, card):
    """serve_lexical: the lexical search strategy through
    ``SequenceGenerator.generate`` (the constraints ride in the sample) under
    each representation, beam 5, two batches of 8: B1 once per encoder layer
    and batch, every finished hypothesis holds its constraints (in order
    under 'ordered')."""
    from ofasys_torch.generator import SequenceGenerator
    from ofasys_torch.preprocessor.instruction import Instruction

    gp, net = hub.general_preprocess, hub.model.net
    recs, cons = _lexical_requests(gp)
    batches = []
    for i in range(0, len(recs), 8):
        sample = gp.collate([gp(Instruction(SUMMARY_TPL, split="test").format(**r)) for r in recs[i:i + 8]])
        sample["constraints"] = cons[i:i + 8]
        batches.append(sample)
    routes = []
    for b in batches:
        B, T = _encoder_tokens(b["net_input"]["slots"])
        routes.append(_route(net.cfg, B, T, T))
    out = {}
    for rep in REPRESENTATIONS:
        gen = SequenceGenerator(hub.model, hub.global_dict, beam_size=5, max_len_b=LEXICAL_MAX_LEN,
                                search_strategy="lexical", constraint_representation=rep, return_n_best=5)
        gen.generate(batches[0])                                  # warm-up
        _sync(hub.device)
        reset_counts()
        t0 = time.perf_counter()
        hyps = [h for b in batches for h in gen.generate(b)]
        _sync(hub.device)
        wall = time.perf_counter() - t0
        launches = read_counts()
        expected = {k: 0 for k in KERNELS}
        for r in routes:
            if r != "plain":
                expected[f"{r}_attention_fwd"] += net.cfg.encoder.layers
        finished = bad = 0
        for hs, c in zip(hyps, cons, strict=True):
            for h in hs:
                if h.score < NEG_SCORE:
                    continue
                finished += 1
                seq = h.tokens.tolist()
                ok = _in_order(seq, c) if rep == "ordered" else all(_contains(seq, x) for x in c)
                bad += not ok
        log(f"  serve_lexical[{rep}]: {finished} finished hypotheses of {len(recs)} requests x 5, "
            f"{bad} without their constraints{' in order' if rep == 'ordered' else ''}; "
            f"{sum(any(h.score >= NEG_SCORE for h in hs) for hs in hyps)} requests with one; "
            f"{wall * 1e3:.1f} ms for the 2 batches; launches "
            f"{({k: v for k, v in launches.items() if v})} (expected "
            f"{({k: v for k, v in expected.items() if v})}) [{card}]")
        if bad:
            raise SystemExit(f"serve_lexical[{rep}]: a finished hypothesis misses a constraint")
        if hub.device.type == "cuda" and (launches != expected or "plain" in routes):
            raise SystemExit(f"serve_lexical[{rep}]: B1 did not run once per encoder layer and batch")
        out[rep] = dict(launches=launches, finished=finished, wall_ms=wall * 1e3)
    if not sum(r["finished"] for r in out.values()):
        raise SystemExit("serve_lexical: no hypothesis met its constraints in any representation")
    return out


def serve_ensemble_and_check(hub, card, serve_res=None):
    """serve_ensemble: serve's 16 requests through the server on a hub whose
    generator ensembles the serve model with a second base model from seed
    SEED + 1 (``SequenceGenerator([m0, m1])``): B1 in each member's encoder,
    served against direct inference; a one-member ensemble gives the serve
    model's tokens and scores bit for bit; p50 beside serve's."""
    from ofasys_torch import GeneralistModel, OFASys
    from ofasys_torch.generator import SequenceGenerator

    m1 = GeneralistModel(hub.model.cfg)
    m1.initialize(hub.global_dict, active_adaptors=ACTIVE_ADAPTORS, dtype=hub.model.net.dtype,
                  device=hub.device, seed=SEED + 1)

    class EnsembleHub(OFASys):
        def __init__(self, members, *a, **k):
            super().__init__(*a, **k)
            self.members = members

        def build_generator(self, **gen_kwargs):
            return SequenceGenerator(self.members, self.global_dict, **gen_kwargs)

    args = (hub.model, None, hub.global_dict, hub.general_preprocess)
    ehub = EnsembleHub([hub.model, m1], *args, device=hub.device)
    res = serve_and_check(ehub, card, label="serve_ensemble", check_encoder=False, members=2)
    one = EnsembleHub([hub.model], *args, device=hub.device)
    mism = n = 0
    for instruction, data, kw, _ in res["calls"]:
        for a, b in zip(one.inference(instruction, data, **kw), hub.inference(instruction, data, **kw),
                        strict=True):
            n += 1
            mism += not (np.array_equal(a.tokens, b.tokens) and a.score == b.score)
    log(f"  serve_ensemble: a one-member ensemble vs the model alone on the same batches: {mism} of "
        f"{n} differ (tokens or score)")
    if mism:
        raise SystemExit("serve_ensemble: a one-member ensemble is not the model")
    same = sum(np.array_equal(_best(a).tokens, _best(b).tokens) for a, b in zip(res["outs"], serve_res["outs"])) \
        if serve_res is not None else None
    if serve_res is not None:
        log(f"  serve_ensemble vs serve: p50 {res['p50_ms']} vs {serve_res['p50_ms']} ms, "
            f"{res['tokens_per_s']:.1f} vs {serve_res['tokens_per_s']:.1f} tokens/s; {same} of "
            f"{len(res['outs'])} answers equal to the one model's (information) [{card}]")
    del m1, ehub, one
    return res


def _loss_grads(model, crit, params, step, batches):
    """One update's per-token loss (summed over the tasks, over their
    summed sample size) and raw-summed gradients, dropout as the step draws it."""
    from ofasys_torch.engine.train_step import make_grad_step

    total, loss, ss = None, 0.0, 0.0
    for i, (name, b) in enumerate(batches.items()):
        g, size, logs = make_grad_step(model, crit[name], fold=i)(params, step, b, SEED)
        total = g if total is None else [a + c for a, c in zip(total, g)]
        loss += float(logs["loss"])
        ss += float(size)
    return loss / ss, total


def train_qat_and_check(d, gp, card, batches, train_res):
    """train_qat: the train phase's updates with quant_training='fwd' (B7 in
    every training forward projection, ``qat_projections`` per task), the
    loss tracking train's (final < train's final * QAT_LOSS_FACTOR +
    QAT_LOSS_SLACK, ofasys_tpu's own test), one update's gradients against the
    same update with quant_training='none' at the same parameters
    (QAT_GRAD_REL_TOL), step time and one profiled update beside train's."""
    model = build_train_model(d, "cuda" if card != "cpu" else "cpu", quant_training="fwd")
    cfg = model.cfg
    per_task = qat_projections(cfg)
    log(f"  train_qat: B7 launches per task's forward: {cfg.encoder.layers} encoder layers x 4 + "
        f"{cfg.decoder.layers} decoder layers x 7 = {per_task}; {len(batches)} tasks: "
        f"{len(batches) * per_task} an update")
    counts, res, (step, state, dev) = train_and_check(model, gp, card, batches=batches, label="train_qat")
    log(f"  train_qat: B7 launched {counts['int8_matmul_fwd']} times in {N_UPDATES} updates, expected "
        f"{N_UPDATES * len(batches) * per_task}")
    final, ref = res["losses"][-1], train_res["losses"][-1]
    bound = ref * QAT_LOSS_FACTOR + QAT_LOSS_SLACK
    log(f"  train_qat: loss {[round(x, 5) for x in res['losses']]} vs train's "
        f"{[round(x, 5) for x in train_res['losses']]}: final {final:.5f} < {bound:.5f} "
        f"(train's final x {QAT_LOSS_FACTOR} + {QAT_LOSS_SLACK})")
    if not final < bound:
        raise SystemExit("train_qat: the quantized run's loss does not track the bf16 run's")
    crit = make_criteria(batches, d.pad())
    names = [n for n, _ in model.net.named_parameters()]
    saved = cfg.dropout
    cfg.dropout = 0.0
    try:
        lq, gq = _loss_grads(model, crit, state.params, state.step, dev)
        cfg.quant_training = "none"
        ln, gn = _loss_grads(model, crit, state.params, state.step, dev)
    finally:
        cfg.quant_training, cfg.dropout = "fwd", saved
    rel, norm_rel, leaves = _grad_diff(names, gq, gn)
    log(f"  train_qat: one update (dropout 0) at the same parameters, quant_training 'fwd' vs 'none': "
        f"loss {lq:.5f} vs {ln:.5f}, gradients rel {rel:.3e} (tol {QAT_GRAD_REL_TOL}), global norm "
        f"rel err {norm_rel:.3e}, worst leaves {_top_leaves(leaves)}")
    if not rel <= QAT_GRAD_REL_TOL:
        raise SystemExit("train_qat: the quantized update's gradients are too far from the bf16 one's")
    res.update(qat_grad_rel=rel, qat_loss=lq, bf16_loss=ln)
    if card != "cpu":
        res["profile"] = phase_profile_train(step, state, dev, card, "one train_qat update",
                                             share=B7_KERNEL_NAMES)
        log(f"  train_qat vs train: step {res['step_ms']:.2f} vs {train_res['step_ms']:.2f} ms, idle "
            f"{100 * res['profile']['idle']:.1f}% vs {100 * train_res['profile']['idle']:.1f}%, "
            f"{res['profile']['launches']} vs {train_res['profile']['launches']} launches an update, "
            f"peak {res['peak_updates_gib']:.2f} vs {train_res['peak_updates_gib']:.2f} GiB [{card}]")
    del model, step, state, dev
    return counts, res


def train_chunked_and_check(d, gp, card, batches, train_res):
    """train_chunked: the train phase's updates with chunked_vocab=True (the
    (N, V) logits never exist); the loss of one update at the same
    parameters against the unfused criterion's (CHUNKED_LOSS_RTOL) and its
    gradients (GRAD_REL_TOL over all leaves, LEAF_REL_TOL per leaf: both
    sides round the logit gradient to bf16, the fused one also each chunk's
    product); the peak device memory of the updates beside train's."""
    from ofasys_torch.ops.fused_ce import pick_chunks

    model = build_train_model(d, "cuda" if card != "cpu" else "cpu")
    V = model.net.embed_tokens.weight.shape[0]
    log(f"  train_chunked: V = {V}, {pick_chunks(V)} chunks of {V // pick_chunks(V)}")
    counts, res, (step, state, dev) = train_and_check(model, gp, card, batches=batches, label="train_chunked",
                                                      ce_kw={"chunked_vocab": True})
    names = [n for n, _ in model.net.named_parameters()]
    cfg = model.cfg
    saved = cfg.dropout
    cfg.dropout = 0.0
    try:
        lf, gf = _loss_grads(model, make_criteria(batches, d.pad(), ce_kw={"chunked_vocab": True}),
                             state.params, state.step, dev)
        lu, gu = _loss_grads(model, make_criteria(batches, d.pad()), state.params, state.step, dev)
    finally:
        cfg.dropout = saved
    rel, norm_rel, leaves = _grad_diff(names, gf, gu)
    worst = max(leaves, key=leaves.get)
    loss_rel = abs(lf - lu) / abs(lu)
    log(f"  train_chunked: one update (dropout 0), fused vs unfused: loss {lf:.6f} vs {lu:.6f} "
        f"(rel {loss_rel:.2e}, tol {CHUNKED_LOSS_RTOL}), gradients rel {rel:.3e} (tol {GRAD_REL_TOL}), "
        f"global norm rel err {norm_rel:.3e}, worst leaf {worst} {leaves[worst]:.3e} (tol {LEAF_REL_TOL})")
    if not (loss_rel <= CHUNKED_LOSS_RTOL and rel <= GRAD_REL_TOL and leaves[worst] <= LEAF_REL_TOL):
        raise SystemExit("train_chunked: the fused loss or gradients disagree with the unfused ones")
    res.update(loss_rel=loss_rel, chunked_grad_rel=rel, chunked_worst_leaf=leaves[worst])
    if card != "cpu":
        log(f"  train_chunked vs train: peak device memory of the updates {res['peak_updates_gib']:.2f} vs "
            f"{train_res['peak_updates_gib']:.2f} GiB, step {res['step_ms']:.2f} vs "
            f"{train_res['step_ms']:.2f} ms [{card}]")
        res["profile"] = phase_profile_train(step, state, dev, card, "one train_chunked update")
    del model, step, state, dev
    return counts, res


def train_optimizers_and_check(d, gp, card, batches):
    """train_optimizers: one update of train's batches under each of
    OPTIMIZERS from the same initial parameters: a finite loss, parameters
    that moved, and under sgd every moved entry stepped against its gradient."""
    from ofasys_torch.configure.configs import OptimizationConfig
    from ofasys_torch.engine.optim import build_optimizer
    from ofasys_torch.engine.train_step import TrainState, make_multitask_train_step
    from ofasys_torch.utils.pytree import sample_to_device

    model = build_train_model(d, "cuda" if card != "cpu" else "cpu")
    dev = {n: sample_to_device(b, model.net.device) for n, b in batches.items()}
    crit = make_criteria(batches, d.pad())
    init = [p.detach().clone() for p in model.net.parameters()]
    out = {}
    for name in OPTIMIZERS:
        with torch.no_grad():
            for p, q in zip(model.net.parameters(), init):
                p.copy_(q)
        opt = build_optimizer(OptimizationConfig(optimizer=name, lr=(TRAIN_LR,)))
        state = TrainState.create(model.net, opt)
        step = make_multitask_train_step(model, crit, opt)
        g = _grads(model, crit, state.params, state.step, dev) if name == "sgd" else None
        t0 = time.perf_counter()
        state, o = step(state, dev, SEED)
        _sync(model.net.device)
        ms = (time.perf_counter() - t0) * 1e3
        tasks = o["tasks"].values()
        loss = sum(float(t["loss"]) for t in tasks) / sum(float(t["sample_size"]) for t in tasks)
        moved = sum(int((p != q).sum()) for p, q in zip(state.params, init))
        n_par = sum(q.numel() for q in init)
        line = f"  train_optimizers[{name}]: loss {loss:.5f}, {moved} of {n_par} entries moved, {ms:.1f} ms"
        ok = np.isfinite(loss) and moved > 0 and all(torch.isfinite(p).all() for p in state.params)
        if g is not None:
            with torch.no_grad():
                dg = [(p - q) * gg for p, q, gg in zip(state.params, init, g)]
                wrong = sum(int((x > 0).sum()) for x in dg)
                along = sum(float(x.double().sum()) for x in dg)
            line += f"; moved against -g: {wrong}, sum(dp * g) {along:.3e}"
            ok = ok and wrong == 0 and along < 0
        log(line + f" [{card}]")
        if not ok:
            raise SystemExit(f"train_optimizers: {name} gave a bad update")
        out[name] = dict(loss=loss, moved=moved, ms=ms)
        del state, step, opt
    del model, dev
    return out


# ------------------------------- the front door: Task, Trainer.fit, from_pretrained
# train_fit: the train mix from TSV files through Task + Trainer.fit with a
# GPT-2-sized BPE table (256 bytes + 50,000 merges + <|endoftext|>), summed
# mode, a checkpoint every FIT_SAVE_EVERY updates; then a second Trainer
# resumes from checkpoint_1_2 into its own save_dir.
FIT_UPDATES = 4
FIT_SAVE_EVERY = 2
N_MERGES = 50000
FIT_TASKS = {
    "text_infilling": dict(TRAIN_TASKS["text_infilling"], cols="0:text"),
    "gigaword": dict(TRAIN_TASKS["gigaword"], cols="0:src,1:tgt"),
}
TINY_FIT_TASKS = {n: dict(spec, batch=TINY_TRAIN_TASKS[n]["batch"]) for n, spec in FIT_TASKS.items()}
FIT_BATCHES_PER_EPOCH = 2      # rows of each TSV: two batches' worth
SERVE_WORDS = ["the", "model", "serves", "a", "batch", "of", "text", "requests", "on", "one", "card",
               "with", "beam", "search", "and", "greedy", "decoding", "over", "fifty", "thousand",
               "symbols", "quick", "brown", "fox", "jumps", "lazy", "dog", "12", "345", "north"]


def write_bpe_table(root, seed=SEED, n_merges=N_MERGES):
    """A GPT-2-sized byte-level BPE table in ``root`` (encoder.json,
    vocab.bpe), made from ``seed`` in a few seconds: the 256 byte symbols,
    then BPE merges learned on the words of the train and serve texts (so
    that each becomes one token, as common words are in GPT-2's table),
    then seeded merges of two tokens already in the table up to
    ``n_merges``, then <|endoftext|>. Every merge makes a new token."""
    from collections import Counter

    from ofasys_torch.preprocessor.tokenizer.gpt2_bpe import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = [b2u[b] for b in range(256)]
    known = set(vocab)
    merges = []
    words = Counter(tuple(b2u[b] for b in (lead + w).encode())
                    for w in sorted(set(_WORDS) | set(SERVE_WORDS)) for lead in ("", " "))
    while len(merges) < n_merges:
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if a + b not in known:
            merges.append((a, b))
            vocab.append(a + b)
            known.add(a + b)
        nw = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            nw[tuple(out)] += c
        words = nw
    learned = len(merges)
    rng = np.random.default_rng(seed)
    while len(merges) < n_merges:
        a, b = (vocab[int(i)] for i in rng.integers(0, len(vocab), 2))
        if a + b in known or a.startswith("#"):
            continue
        merges.append((a, b))
        vocab.append(a + b)
        known.add(a + b)
    vocab.append("<|endoftext|>")
    enc, bpe = os.path.join(root, "encoder.json"), os.path.join(root, "vocab.bpe")
    with open(enc, "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f, ensure_ascii=False)
    with open(bpe, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return enc, bpe, dict(entries=len(vocab), merges=len(merges), learned=learned)


def fit_fixture(root, tasks=None, seed=SEED):
    """The BPE table and one TSV per task in ``root``: FIT_BATCHES_PER_EPOCH
    batches' worth of rows with the spec's byte lengths (TRAIN_TASKS's)."""
    t0 = time.perf_counter()
    enc, bpe, table = write_bpe_table(root, seed)
    rng = np.random.default_rng(seed + 5)
    specs = {}
    for name, spec in (tasks or FIT_TASKS).items():
        cols = [c.split(":")[1] for c in spec["cols"].split(",")]
        path = os.path.join(root, f"{name}.tsv")
        with open(path, "w", encoding="utf-8") as f:
            for _ in range(FIT_BATCHES_PER_EPOCH * spec["batch"]):
                f.write("\t".join(_text(rng, *spec[c]) for c in cols) + "\n")
        specs[name] = dict(spec, path=path)
    log(f"train_fit: BPE table {table} and {len(specs)} TSV files written in "
        f"{time.perf_counter() - t0:.1f} s [host CPU]")
    return dict(root=root, encoder_json=enc, vocab_bpe=bpe, table=table, tasks=specs)


@contextlib.contextmanager
def gpt2_text(fx):
    """The ConfigStore's text preprocess set to bpe='gpt2' with the
    fixture's table for the block (as a user sets it), restored after."""
    from ofasys_torch.configure import ConfigStore

    cfg = ConfigStore().get("ofasys.preprocess", "text").config
    saved = cfg.bpe, cfg.encoder_json, cfg.vocab_bpe
    store = ConfigStore()
    store.override("ofasys.preprocess.text.bpe", "gpt2")
    store.override("ofasys.preprocess.text.encoder_json", fx["encoder_json"])
    store.override("ofasys.preprocess.text.vocab_bpe", fx["vocab_bpe"])
    try:
        yield
    finally:
        cfg.bpe, cfg.encoder_json, cfg.vocab_bpe = saved


def fit_tasks(fx, url=None):
    """One Task per spec, reading its TSV (load_dataset_from_path), by its
    path or by ``url(path)``."""
    from ofasys_torch import Task

    tasks = []
    for name, spec in fx["tasks"].items():
        t = Task(name=name, instruction=spec["template"])
        t.cfg.dataset.batch_size = spec["batch"]
        t.cfg.dataset.selected_cols = spec["cols"]
        tasks.append(t.load_dataset_from_path(spec["path"] if url is None else url(spec["path"])))
    return tasks


def fit_config(fx, run):
    """The trainer's config: train's dropout (the model's), adamw at
    TRAIN_LR with clipping, summed mode, a checkpoint every FIT_SAVE_EVERY
    updates into ``<root>/<run>``, meters fetched at the same boundary."""
    from ofasys_torch import TrainerConfig

    cfg = TrainerConfig()
    cfg.common.seed = SEED
    cfg.common.log_interval = FIT_SAVE_EVERY
    cfg.optimization.lr = (TRAIN_LR,)
    cfg.optimization.multi_task_mode = "sum"
    cfg.checkpoint.save_dir = os.path.join(fx["root"], run)
    cfg.checkpoint.save_interval_updates = FIT_SAVE_EVERY
    cfg.checkpoint.no_epoch_checkpoints = True
    return cfg


def fit_plan(fx):
    """The dictionary and each update's batches (numpy) of train_fit, made
    on the host as the trainer makes them (its peek, then its streams)."""
    from ofasys_torch import Trainer
    from ofasys_torch.preprocessor.dictionary import Dictionary

    tr = Trainer(fit_config(fx, "plan"), device="cpu")
    tasks = fit_tasks(fx)
    d = Dictionary()
    for t in tasks:
        t.initialize(d)
    d.pad_to_multiple_(128)
    for t in tasks:
        tr._peek_batch(t)
    streams = {t.name: tr._task_batches(t) for t in tasks}
    try:
        updates = [{n: next(s) for n, s in streams.items()} for _ in range(FIT_UPDATES)]
    finally:
        for s in streams.values():
            s.close()
    return d, updates


def fit_train_shapes(updates):
    """The distinct attention calls (label, (B, Tq, Tk), causal) of
    train_fit's updates."""
    seen, out = set(), []
    for u, batches in enumerate(updates):
        for label, shape, causal in train_shapes(batches):
            if (shape, causal) not in seen:
                seen.add((shape, causal))
                out.append((f"fit_{label}_u{u + 1}", shape, causal))
    return out


def _timed_trainer(cfg, device, card, profile_update=None, count_syncs_update=None):
    """A Trainer whose updates are timed by the host clock ending in a
    synchronize (``update_ms``; ``wait_ms``: the time each update waited
    for its batches), that keeps each update's batches and metrics, counts
    the synchronizing ops of update ``count_syncs_update`` (sync debug mode)
    and profiles update ``profile_update`` (both 1-based, within the run)."""
    import warnings

    from ofasys_torch import Trainer
    from torch.profiler import ProfilerActivity, profile

    class TimedTrainer(Trainer):
        def __init__(self):
            super().__init__(cfg, device=device)
            self.update_ms, self.wait_ms, self.batches, self.metrics = [], [], [], []
            self.syncs = None
            self.profile = None

        def setup(self, *a, **k):
            start = super().setup(*a, **k)
            self._iterators = {n: self._timed(n, it) for n, it in self._iterators.items()}
            return start

        def _timed(self, name, it):
            try:
                while True:
                    t0 = time.perf_counter()
                    b = next(it)
                    self.wait_ms[-1] += (time.perf_counter() - t0) * 1e3
                    self.batches[-1][name] = b
                    yield b
            finally:
                it.close()

        def _log_metrics(self, task_name, metrics, ntokens, nsentences=0):
            self.metrics[-1].append((task_name, metrics))
            super()._log_metrics(task_name, metrics, ntokens, nsentences)

        def train_one_update(self):
            self.wait_ms.append(0.0)
            self.batches.append({})
            self.metrics.append([])
            n = len(self.update_ms) + 1
            if n == count_syncs_update and device.type == "cuda":
                where = []

                def record(message, category, filename, lineno, file=None, line=None):
                    if "synchronizing" in str(message):
                        where.append(_caller())

                saved = warnings.showwarning
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = record
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        t0 = time.perf_counter()
                        super().train_one_update()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                        warnings.showwarning = saved
                self.syncs = where
            elif n == profile_update and device.type == "cuda":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    super().train_one_update()
                    _sync(device)
                self.profile = _report_profile(prof, (time.perf_counter() - t0) * 1e3,
                                               "one train_fit update through Trainer.train_one_update",
                                               card)
            else:
                t0 = time.perf_counter()
                super().train_one_update()
            _sync(device)
            self.update_ms.append((time.perf_counter() - t0) * 1e3)

    return TimedTrainer()


def _caller():
    """file:line of the innermost frame of ofasys_torch on the stack."""
    import traceback

    for f in reversed(traceback.extract_stack()):
        if f"{os.sep}ofasys_torch{os.sep}" in f.filename:
            return f"{f.filename.split(os.sep + 'ofasys_torch' + os.sep)[-1]}:{f.lineno}"
    return "outside ofasys_torch"


def _fit_losses(trainer):
    """Loss per target token of each update, over the tasks."""
    out = []
    for ms in trainer.metrics:
        tasks = [m for name, m in ms if name is not None]
        out.append(sum(float(m["loss"]) for m in tasks) / sum(float(m["sample_size"]) for m in tasks))
    return out


def _ckpt_trees_equal(a, b, path=""):
    """[paths where two checkpoint trees differ]."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in _ckpt_trees_equal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [f"{path}: max |diff| {(a - b).abs().max().item():.3e}"]
    return [] if a == b else [f"{path}: {a} vs {b}"]


def preprocess_ms(fx, n=3, tokenizers=None):
    """Host ms to read, preprocess and collate one batch of each task (no
    prefetch thread), on fresh tasks; each task's tokenizer class name is
    appended to ``tokenizers``."""
    from ofasys_torch.preprocessor.dictionary import Dictionary

    tasks = fit_tasks(fx)
    d = Dictionary()
    for t in tasks:
        t.initialize(d)
        if tokenizers is not None:
            tokenizers.append(type(t.general_preprocess.bpe).__name__)
    out = {}
    for t in tasks:
        it = t.get_batch_iterator("train", seed=SEED)
        it.prefetch = 0
        epochs = it.next_epoch_itr()
        times = []
        for _ in range(min(n, FIT_BATCHES_PER_EPOCH)):
            t0 = time.perf_counter()
            next(epochs)
            times.append((time.perf_counter() - t0) * 1e3)
        epochs.close()
        out[t.name] = statistics.median(times)
    return out


def train_fit_and_check(fx, card, device="cuda", arch="base", train_res=None):
    """Phase train_fit (see the module docstring). Returns the launch
    counts of the first run's fit, the results, and what serve_pretrained
    needs (the first trainer, its tasks, the checkpoint paths)."""
    from ofasys_torch import GeneralistModel
    from ofasys_torch.preprocessor.tokenizer.gpt2_bpe import REGEX_BACKEND
    from ofasys_torch.utils import checkpoint_utils as cu

    device = torch.device(device)
    times = {"save_ms": [], "join_ms": [], "load_ms": []}
    orig_save, orig_wait, orig_load = cu.save_checkpoint, cu.wait_for_async_saves, cu.load_checkpoint
    nested = [0]

    def timed_wait():
        t0 = time.perf_counter()
        orig_wait()
        times["join_ms"].append((time.perf_counter() - t0) * 1e3)
        nested[0] += times["join_ms"][-1]

    def timed_save(*a, **k):
        nested[0] = 0.0
        t0 = time.perf_counter()
        orig_save(*a, **k)
        times["save_ms"].append((time.perf_counter() - t0) * 1e3 - nested[0])

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        out = orig_load(*a, **k)
        times["load_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def model():
        m = GeneralistModel(arch=arch)
        if device.type == "cpu":
            m.cfg.attn_kernel = "pallas"
        return m

    cu.save_checkpoint, cu.wait_for_async_saves, cu.load_checkpoint = timed_save, timed_wait, timed_load
    try:
        tasks = fit_tasks(fx)
        first = _timed_trainer(fit_config(fx, "run1"), device, card)
        reset_counts()
        t0 = time.perf_counter()
        first.fit(model(), tasks, max_update=FIT_UPDATES)
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        first_saves = list(times["save_ms"]), list(times["join_ms"])

        cfg2 = fit_config(fx, "run2")
        cfg2.checkpoint.restore_file = os.path.join(fx["root"], "run1", f"checkpoint_1_{FIT_SAVE_EVERY}")
        second = _timed_trainer(cfg2, device, card, count_syncs_update=1, profile_update=2)
        second.fit(model(), fit_tasks(fx), max_update=FIT_UPDATES)
    finally:
        cu.save_checkpoint, cu.wait_for_async_saves, cu.load_checkpoint = orig_save, orig_wait, orig_load

    net = first.model.net
    V = len(first.global_dict)
    log(f"train_fit: {arch} arch, vocabulary {V} ({fx['table']['entries']} BPE symbols, padded to a "
        f"multiple of 128), tokenizer {type(tasks[0].general_preprocess.bpe).__name__} with the "
        f"{REGEX_BACKEND!r} word split, adaptors {net.active_adaptors}, dropout {net.cfg.dropout}")
    if not 50_200 <= V <= 50_400 and arch == "base":
        raise SystemExit(f"train_fit: vocabulary {V}, expected about 50.3k")
    for u, batches in enumerate(first.batches):
        shapes = {n: _task_shapes(b) for n, b in batches.items()}
        log(f"  update {u + 1}: (B, encoder T, decoder T) {shapes}")
    per_update = [_expected_train_launches(b, net.cfg, net) for b in first.batches]
    expected = {k: sum(p[k] for p in per_update) for k in KERNELS}
    log(f"train_fit: launches {launches} in {FIT_UPDATES} updates (expected {expected}; per update "
        f"{[{k: v for k, v in p.items() if v} for p in per_update]})")
    if device.type == "cuda":
        dense = [p["dense_attention_fwd"] for p in per_update] + [p["dense_attention_bwd"] for p in per_update]
        if launches != expected or set(dense) != {36}:
            raise SystemExit("train_fit: B1/B2 did not run once per attention call (36 an update)")
    losses = _fit_losses(first)
    log(f"train_fit: loss per target token {[round(x, 5) for x in losses]}; gnorm "
        f"{[round(float(next(m for n, m in ms if n is None)['gnorm']), 4) for ms in first.metrics]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("train_fit: the loss did not fall")
    upd = statistics.median(first.update_ms[1:])
    train_ms = (train_res or {}).get("step_ms")
    log(f"train_fit: update ms {[round(x, 2) for x in first.update_ms]}, median of updates 2-"
        f"{FIT_UPDATES} {upd:.2f} ms (host clock ending in a synchronize; train's step "
        f"{train_ms if train_ms is None else round(train_ms, 2)} ms in this run, the same batch "
        f"sizes at byte-token lengths) [{card}]; whole fit {fit_s:.1f} s")
    prep = preprocess_ms(fx)
    # an epoch's first batch starts its epoch's prefetch thread: the updates
    # that open an epoch wait for it; the others should not
    opens = [u for u in range(FIT_UPDATES) if u % FIT_BATCHES_PER_EPOCH == 0]
    inside = [w for u, w in enumerate(first.wait_ms) if u not in opens]
    log(f"train_fit: host ms to read, preprocess and collate one batch (no prefetch): "
        f"{ {k: round(v, 2) for k, v in prep.items()} }; the updates waited "
        f"{[round(x, 2) for x in first.wait_ms]} ms for their batches (prefetch thread, depth "
        f"{first.cfg.dataset.num_workers}): hidden inside an epoch: "
        f"{max(inside) < 0.1 * sum(prep.values())}; the updates that open an epoch "
        f"{[u + 1 for u in opens]} wait for its first batches [host CPU]")

    run1, run2 = (os.path.join(fx["root"], r) for r in ("run1", "run2"))
    ck_mid = os.path.join(run1, f"checkpoint_1_{FIT_SAVE_EVERY}")
    nbytes = os.path.getsize(ck_mid)
    log(f"train_fit: checkpoint {nbytes} bytes ({nbytes / 2 ** 30:.3f} GiB: params, adamw moments, "
        f"step); first run's saves {[round(x, 1) for x in first_saves[0]]} ms to return (host copy, "
        f"background write started), joins {[round(x, 1) for x in first_saves[1]]} ms; loads "
        f"{[round(x, 1) for x in times['load_ms']]} ms [{card}]")
    a, meta_a = orig_load(os.path.join(run1, "checkpoint_last"))
    b, meta_b = orig_load(os.path.join(run2, "checkpoint_last"))
    diffs = _ckpt_trees_equal(a, b)
    log(f"train_fit: resumed from checkpoint_1_{FIT_SAVE_EVERY} (second save_dir) to {FIT_UPDATES}: "
        f"params, adamw moments and step against the straight run's checkpoint_last: "
        f"{'bit for bit' if not diffs else diffs[:8]}; resumed losses "
        f"{[round(x, 5) for x in _fit_losses(second)]}")
    if diffs:
        raise SystemExit("train_fit: the resumed run differs from the straight run")
    meters_a, meters_b = ({k: v for k, (cls, v) in m["meters"].items()
                           if cls != "TimeMeter" and k not in ("train_wall", "gb_free")}
                          for m in (meta_a, meta_b))
    restored = meta_a["iterator_states"] == meta_b["iterator_states"] and meters_a == meters_b \
        and meta_a["meters"]["ups"][1]["n"] == meta_b["meters"]["ups"][1]["n"]
    log(f"train_fit: iterator states {meta_b['iterator_states'] and {n: {k: v for k, v in s.items() if k != 'rng'} for n, s in meta_b['iterator_states'].items()}} "
        f"and meters {sorted(meters_b)} equal the straight run's: {restored}")
    if not restored:
        raise SystemExit("train_fit: the meters or the iterator states were not restored")
    syncs = second.syncs
    per = first.host_syncs / FIT_UPDATES
    sites = None if syncs is None else {k: syncs.count(k) for k in sorted(set(syncs))}
    log(f"train_fit: host syncs: {len(syncs) if syncs is not None else 'not counted'} synchronizing "
        f"ops inside one update (sync debug mode, by site: {sites}), plus {first.host_syncs} metric "
        f"fetches in {FIT_UPDATES} updates ({per:.2f} an update)")
    res = dict(update_ms=upd, update_ms_all=first.update_ms, train_step_ms=train_ms, vocab=V,
               losses=losses, checkpoint_bytes=nbytes, save_ms=first_saves[0], join_ms=first_saves[1],
               load_ms=times["load_ms"], preprocess_ms=prep, wait_ms=first.wait_ms,
               syncs_in_update=None if syncs is None else len(syncs), sync_sites=sites,
               metric_fetches=first.host_syncs,
               profile=second.profile, bpe_table=fx["table"], regex=REGEX_BACKEND)
    return launches, res, dict(trainer=first, tasks=tasks, last=os.path.join(run1, "checkpoint_last"),
                               ck_mid=ck_mid)


def _bpe_requests(gp):
    """serve's 16 requests (12 beam 5, 4 greedy) with sources of serve's
    token counts under ``gp``'s tokenizer: words drawn like serve's until
    the source has as many tokens as a serve source has bytes."""
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(SERVE_SRC[0], SERVE_SRC[1] + 1, size=N_BEAM_REQUESTS + N_GREEDY_REQUESTS)
    sizes[N_BEAM_REQUESTS - 4] = sizes[N_BEAM_REQUESTS] = 160
    text = gp.name2pre["text"]
    srcs = []
    for n in sizes:
        s = ""
        while len(text.encode(s)) < n:
            s += rng.choice(SERVE_WORDS) + " "
        srcs.append(s.strip())
    reqs = [({"src": s}, {"max_len_b": MAX_LEN_B}) for s in srcs[:N_BEAM_REQUESTS]]
    return reqs + [({"src": s}, {"max_len_b": MAX_LEN_B, "beam_size": 1}) for s in srcs[N_BEAM_REQUESTS:]]


def serve_pretrained_and_check(fit, card, device="cuda", serve_res=None):
    """Phase serve_pretrained (see the module docstring). Returns the
    launch counts of the single hub's and the ensemble's runs and the results."""
    from ofasys_torch import OFASys

    t0 = time.perf_counter()
    hub = OFASys.from_pretrained(fit["last"], device=device)
    load_s = time.perf_counter() - t0
    if device != "cuda":
        hub.model.cfg.attn_kernel = "pallas"
    reqs = _bpe_requests(hub.general_preprocess)
    log(f"serve_pretrained: OFASys.from_pretrained(checkpoint_last) in {load_s:.2f} s; requests' source "
        f"tokens {[len(hub.general_preprocess.name2pre['text'].encode(r['src'])) for r, _ in reqs]}")
    res = serve_and_check(hub, card, reqs=reqs, label="serve_pretrained")
    ref = OFASys.from_trainer(fit["trainer"], fit["tasks"])
    mismatches = 0
    for instruction, data, kw, out in res["calls"]:
        direct = ref.inference(instruction, data, **kw)
        for o, r in zip(out if isinstance(data, list) else [out],
                        direct if isinstance(data, list) else [direct], strict=True):
            mismatches += not np.array_equal(_best(o).tokens, _best(r).tokens)
    log(f"serve_pretrained: tokens against OFASys.from_trainer(trainer, tasks) on the same batches: "
        f"{mismatches} of {len(reqs)} requests differ")
    if mismatches:
        raise SystemExit("serve_pretrained: from_pretrained's tokens differ from from_trainer's")
    ens = OFASys.from_pretrained([fit["last"], fit["ck_mid"]], device=device)
    if device != "cuda":
        for m in ens._ensemble:
            m.cfg.attn_kernel = "pallas"
    ens_reqs = reqs[8:N_BEAM_REQUESTS]
    ens_res = serve_and_check(ens, card, reqs=ens_reqs, label="serve_pretrained_ensemble", members=2)
    serve_p50 = (serve_res or {}).get("p50_ms")
    log(f"serve_pretrained: p50 {res['p50_ms']} ms, ensemble of 2 on {len(ens_reqs)} requests "
        f"{ens_res['p50_ms']} ms, serve's {serve_p50} ms in this run [{card}]")
    del hub, ens, ref
    return res["launches"], ens_res["launches"], dict(
        p50_ms=res["p50_ms"], tokens_per_s=res["tokens_per_s"], ensemble_p50_ms=ens_res["p50_ms"],
        serve_p50_ms=serve_p50, load_s=load_s, shapes=res["shapes"], ensemble_shapes=ens_res["shapes"])


# -------------- reference checkpoints in, metrics out: import, evaluate, launch
# import_reference: serve_ground's model exported in the reference layout,
# converted by `python -m ofasys_torch.utils.torch_import` and served again.
# evaluate / launch: train_fit's checkpoint and run through the config-file
# entry points (cli.evaluate, launch.main, cli.train).
EVAL_TASKS = {
    "gigaword": dict(rows=128, batch=64, cols="0:src,1:tgt"),
    "sst2": dict(rows=256, batch=64, cols="0:sentence,1:label", sentence=(40, 80)),
}
TINY_EVAL_TASKS = {n: dict(spec, rows=6, batch=4) for n, spec in EVAL_TASKS.items()}
SST2_ANSWERS = ("no", "yes")
EVAL_GENERATION = dict(beam=5, max_len_b=MAX_LEN_B)
# bound of |score under B1 - score under the plain path| for a candidate's
# summed log-probability (bf16 logits, a few tokens): ENC_ABS_TOL's
TRAVERSE_SCORE_ATOL = 0.25


def reference_extras(sd):
    """The keys a reference checkpoint holds beyond the mapped parameters:
    the decoder's copy of the shared token embedding and each BatchNorm's
    ``num_batches_tracked``; ``import_reference_state_dict`` leaves them
    unused."""
    out = dict(sd)
    out["decoder.adaptor.embed_tokens.weight"] = sd["encoder.adaptor.embed_tokens.weight"]
    for k in sd:
        if k.endswith(".running_mean"):
            out[k[: -len("running_mean")] + "num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def _leaves_equal(a, b):
    """(leaves, [flax paths where two nets' parameters differ])."""
    from ofasys_torch.utils.jax_params import export_params
    from ofasys_torch.utils.torch_import import _walk

    fa, fb = dict(_walk(export_params(a))), dict(_walk(export_params(b)))
    if set(fa) != set(fb):
        return len(fa), sorted(set(fa) ^ set(fb))[:8]
    return len(fa), [p for p in fa if not np.array_equal(fa[p], fb[p])]


def import_reference_and_check(hub, card, ground_res=None, device="cuda", arch="base"):
    """Phase import_reference (see the module docstring) on serve_ground's
    hub. Returns the launch counts of the imported hub's serving run and
    the results."""
    from ofasys_torch import OFASys
    from ofasys_torch.utils import torch_import as ti

    root = tempfile.mkdtemp(prefix="ofasys_torch_import_")
    try:
        t0 = time.perf_counter()
        sd = reference_extras(ti.export_reference_state_dict(hub.model))
        pt = os.path.join(root, "reference.pt")
        torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, pt)
        export_s = time.perf_counter() - t0
        nbytes = os.path.getsize(pt)
        vocab = os.path.join(root, "dict.txt")
        hub.global_dict.save(vocab)
        seen = {}
        orig = ti.import_reference_state_dict

        def recording(*a, **k):
            out = orig(*a, **k)
            seen["missing"], seen["unused"] = out[1], out[2]
            return out

        ti.import_reference_state_dict = recording
        t0 = time.perf_counter()
        try:
            ti.main([pt, os.path.join(root, "out"), "--arch", arch, "--adaptors", ",".join(GROUND_ADAPTORS),
                     "--dict", vocab, "--preprocessors", "text,box", "--device", device])
        finally:
            ti.import_reference_state_dict = orig
        convert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        imported = OFASys.from_pretrained(os.path.join(root, "out", "checkpoint_last"), device=device)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    imported.model.cfg.attn_kernel = hub.model.cfg.attn_kernel
    expected_unused = {k for k in sd if k.endswith("num_batches_tracked")} | {"decoder.adaptor.embed_tokens.weight"}
    n_leaves, differ = _leaves_equal(imported.model.net, hub.model.net)
    log(f"import_reference: {len(sd)} reference keys, {nbytes} bytes ({nbytes / 2 ** 30:.3f} GiB) "
        f"exported in {export_s:.2f} s; `python -m ofasys_torch.utils.torch_import` converted it in "
        f"{convert_s:.2f} s (missing {len(seen['missing'])}, unused {len(seen['unused'])}: the decoder's "
        f"embed_tokens copy and {len(expected_unused) - 1} num_batches_tracked); from_pretrained in "
        f"{load_s:.2f} s; {n_leaves} leaves against the source: "
        f"{'bit for bit' if not differ else differ[:8]} [{card}]")
    if (seen["missing"] or set(seen["unused"]) != expected_unused or differ
            or imported.global_dict.symbols != hub.global_dict.symbols):
        raise SystemExit("import_reference: the imported model is not the source's")
    res = serve_and_check(imported, card, REFCOCO_TPL, _ground_requests(), "import_reference")
    boxes_differ = 0
    for instruction, data, kw, out in res["calls"]:
        direct = hub.inference(instruction, data, **kw)
        if not isinstance(data, list):
            out, direct = [out], [direct]
        for o, r in zip(out, direct, strict=True):
            boxes_differ += not (np.array_equal(o.tokens, r.tokens) and np.array_equal(o.box, r.box))
    ground_p50 = (ground_res or {}).get("p50_ms")
    log(f"import_reference: boxes against the source hub on the same batches: {boxes_differ} of "
        f"{len(res['outs'])} requests differ; p50 {res['p50_ms']} ms beside serve_ground's "
        f"{ground_p50} ms in this run [{card}]")
    if boxes_differ:
        raise SystemExit("import_reference: the imported hub's boxes differ from the source hub's")
    released = os.environ.get("OFASYS_MULTITASK_CKPT", "")
    if os.path.isfile(released):
        released_caption(released, card, device)
    else:
        log("import_reference: released checkpoint: not present (OFASYS_MULTITASK_CKPT names no file)")
    del imported
    return res["launches"], dict(reference_bytes=nbytes, export_s=export_s, convert_s=convert_s,
                                 load_s=load_s, p50_ms=res["p50_ms"], serve_ground_p50_ms=ground_p50,
                                 leaves=n_leaves, unused=len(expected_unused))


def released_caption(path, card, device="cuda"):
    """A released reference checkpoint (``multitask_10k.pt``) converted with
    placeholder vocabulary and one greedy caption decoded from a seeded
    image: finite, EOS-terminated."""
    from ofasys_torch import OFASys
    from ofasys_torch.utils import torch_import as ti

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        ti.main([path, out, "--arch", "base", "--adaptors", "text,image_resnet",
                 "--preprocessors", "text,image,box", "--strict", "--device", device])
        hub = OFASys.from_pretrained(os.path.join(out, "checkpoint_last"), device=device)
    o = hub.inference("[IMAGE:img,adaptor=image_resnet] what does the image describe? -> [TEXT:cap]",
                      data={"img": _images(np.random.default_rng(SEED), 1)[0]}, beam_size=1, max_len_b=16)
    log(f"import_reference: released checkpoint {path}: imported and served in "
        f"{time.perf_counter() - t0:.1f} s, greedy caption tokens {o.tokens.tolist()} [{card}]")
    if not (np.isfinite(o.score) and o.tokens.size and o.tokens[-1] == hub.global_dict.eos()):
        raise SystemExit("import_reference: the released checkpoint's caption is not EOS-terminated")


def eval_fixture(fx, tasks=None, arch="base", device="cuda", seed=SEED):
    """The valid TSVs of gigaword (train's byte lengths) and glue sst2
    (labels no/yes), the sst2 answer table, and the JSON config of the two
    tasks (the shape of examples/text_infilling.yaml at ``arch``) that
    cli.evaluate reads, in the fit fixture's root."""
    root = fx["root"]
    rng = np.random.default_rng(seed + 11)
    tasks = tasks or EVAL_TASKS
    paths = {n: os.path.join(root, f"{n}_valid.tsv") for n in tasks}
    with open(paths["gigaword"], "w", encoding="utf-8") as f:
        spec = TRAIN_TASKS["gigaword"]
        for _ in range(tasks["gigaword"]["rows"]):
            f.write(f"{_text(rng, *spec['src'])}\t{_text(rng, *spec['tgt'])}\n")
    with open(paths["sst2"], "w", encoding="utf-8") as f:
        for _ in range(tasks["sst2"]["rows"]):
            f.write(f"{_text(rng, *tasks['sst2']['sentence'])}\t{SST2_ANSWERS[int(rng.integers(0, 2))]}\n")
    answers = os.path.join(root, "sst2_ans2label.json")
    with open(answers, "w") as f:
        json.dump({a: i for i, a in enumerate(SST2_ANSWERS)}, f)

    def dataset(name):
        return {"valid_data": paths[name], "batch_size": tasks[name]["batch"],
                "selected_cols": tasks[name]["cols"], "num_workers": 0}

    model = {"arch": arch} if device == "cuda" else {"arch": arch, "attn_kernel": "pallas"}
    cfg = {"model": model,
           "trainer": {"common": {"dtype": "bfloat16", "seed": SEED}},
           "tasks": {"gigaword": {"task": "gigaword", "instruction": {"template": SUMMARY_TPL},
                                  "dataset": dataset("gigaword"), "generation": dict(EVAL_GENERATION),
                                  "evaluation": {"output_dir": os.path.join(root, "eval_out")}},
                     "sst2": {"task": "glue", "subtask": "sst2", "dataset": dataset("sst2")}}}
    path = os.path.join(root, "evaluate.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return dict(config=path, tsv=paths, answers=answers, tasks=tasks)


@contextlib.contextmanager
def text_store(**fields):
    """The ConfigStore's text preprocess with ``fields`` set for the block
    (as a user sets them), restored after."""
    from ofasys_torch.configure import ConfigStore

    cfg = ConfigStore().get("ofasys.preprocess", "text").config
    saved = {k: getattr(cfg, k) for k in fields}
    for k, v in fields.items():
        setattr(cfg, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)


def _tsv_records(path, cols):
    from ofasys_torch.io.reader.readers import TsvReader

    reader = TsvReader(path, selected_cols=cols).open()
    try:
        return [reader.read(i) for i in range(len(reader))]
    finally:
        reader.close()


def eval_dispatch_shapes(efx, d):
    """(B, T) of the encoder in each evaluate batch of each task."""
    from ofasys_torch import Task
    from ofasys_torch.task.tasks import GlueTask

    out = []
    with text_store(ans2label_file=efx["answers"]):
        for name, spec in efx["tasks"].items():
            tpl = SUMMARY_TPL if name == "gigaword" else GlueTask.SUBTASK_TEMPLATES["sst2"]
            gp = Task(name=name, instruction=tpl).initialize(d).general_preprocess
            recs = _tsv_records(efx["tsv"][name], spec["cols"])
            for i in range(0, len(recs), spec["batch"]):
                out.append((f"evaluate_{name}_batch{i // spec['batch']}",
                            _encoder_shape(gp, recs[i:i + spec["batch"]], tpl)))
    return out


def eval_traverse_calls(efx, d, eval_serve, cfg):
    """[(label, (B, Tq, Tk), causal)] of the decoder attentions that B1 runs
    in evaluate's sst2 candidate passes, one a distinct shape: each
    answer's decoder self attention (causal) and cross attention against
    each batch's encoder, where MultiheadAttention's rule routes them to the
    dense kernel. ``eval_serve`` is eval_dispatch_shapes' list."""
    from ofasys_torch import Task
    from ofasys_torch.task.tasks import GlueTask

    with text_store(ans2label_file=efx["answers"]):
        pre = Task(name="sst2", instruction=GlueTask.SUBTASK_TEMPLATES["sst2"]).initialize(d) \
            .general_preprocess.name2pre["text"]
        lengths = sorted({len(pre.encode(a)) + 1 for a in SST2_ANSWERS})
    calls = {}
    for label, (B, Ts) in eval_serve:
        if not label.startswith("evaluate_sst2_"):
            continue
        for Tt in lengths:
            for kind, (Tq, Tk), causal in (("decoder_causal", (Tt, Tt), True), ("cross", (Tt, Ts), False)):
                if _route(cfg, B, Tq, Tk) == "dense":
                    calls.setdefault((B, Tq, Tk, causal), f"evaluate_sst2_{kind}_{Tq}x{Tk}")
    return [(label, (B, Tq, Tk), causal) for (B, Tq, Tk, causal), label in calls.items()]


@contextlib.contextmanager
def recording_evaluate():
    """Task.inference, TraverseTask.answer_scores and both evaluates
    recorded while the block runs: each generation batch's outputs and
    kernel launches, each traverse batch's scores and launches, each
    task's evaluate seconds."""
    from ofasys_torch.task.base import Task
    from ofasys_torch.task.traverse_task import TraverseTask

    rec = {"generate": [], "traverse": [], "seconds": {}}
    saved = Task.inference, TraverseTask.answer_scores, Task.evaluate, TraverseTask.evaluate

    def inference(self, model, params, sample, **kw):
        before = read_counts()
        out = saved[0](self, model, params, sample, **kw)
        after = read_counts()
        rec["generate"].append(dict(task=self, model=model, sample=sample, outputs=out,
                                    launches={k: after[k] - before[k] for k in after}))
        return out

    def answer_scores(self, model, sample, answers):
        before = read_counts()
        scores = saved[1](self, model, sample, answers)
        after = read_counts()
        rec["traverse"].append(dict(task=self, model=model, sample=sample, answers=answers, scores=scores,
                                    launches={k: after[k] - before[k] for k in after}))
        return scores

    def timed(fn):
        def evaluate(self, *a, **k):
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            rec["seconds"][self.name] = time.perf_counter() - t0
            return out
        return evaluate

    Task.inference, TraverseTask.answer_scores = inference, answer_scores
    Task.evaluate, TraverseTask.evaluate = timed(saved[2]), timed(saved[3])
    try:
        yield rec
    finally:
        Task.inference, TraverseTask.answer_scores, Task.evaluate, TraverseTask.evaluate = saved


def _expected_pass_launches(cfg, B, Ts, Tt):
    """B1 launches of one encoder pass over (B, Ts) and one full decoder
    pass over (B, Tt) against it, by MultiheadAttention's routing rule."""
    enc = cfg.encoder.layers * (_route(cfg, B, Ts, Ts) == "dense")
    dec = cfg.decoder.layers * ((_route(cfg, B, Tt, Tt) == "dense") + (_route(cfg, B, Tt, Ts) == "dense"))
    return enc + dec


@contextlib.contextmanager
def plain_attention(cfg):
    """The model's attention on the plain path with fp32 scores for the block."""
    saved = cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits
    cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = "xla", False, GRAD_REF_LOGITS
    try:
        yield
    finally:
        cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved


def _traverse_ties(kernel, plain):
    """Rows whose pick under the kernel differs from the plain path's, each
    with (plain margin between its top two, the row's largest score
    difference): a tie where the margin is at most twice the difference."""
    out = []
    for b in np.nonzero(kernel.argmax(1) != plain.argmax(1))[0]:
        top2 = np.sort(plain[b])[-2:]
        out.append((int(b), float(top2[1] - top2[0]), float(np.abs(kernel[b] - plain[b]).max())))
    return out


def evaluate_and_check(fx, efx, card, ckpt, device="cuda"):
    """Phase evaluate (see the module docstring). Returns the launch counts
    of the cli.evaluate run, the results, and one traverse batch with its
    task and model for traverse_kernels."""
    import io

    from ofasys_torch import OFASys
    from ofasys_torch.cli import evaluate as cli_evaluate
    from torch.profiler import ProfilerActivity, profile

    buf = io.StringIO()
    with text_store(ans2label_file=efx["answers"]), recording_evaluate() as rec:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_evaluate.main([efx["config"], "--ckpt", ckpt, "--split", "valid", "--device", device])
        wall = time.perf_counter() - t0
        launches = read_counts()
    printed = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"evaluate: cli.evaluate printed {printed} in {wall:.1f} s (model build, checkpoint load and "
        f"both tasks) [{card}]")
    if set(printed) != {"gigaword", "sst2"} or set(printed["gigaword"]) != {"rouge1", "rouge2", "rougeL"} \
            or set(printed["sst2"]) != {"accuracy"} or not all(
                np.isfinite(v) for m in printed.values() for v in m.values()):
        raise SystemExit("evaluate: cli.evaluate did not print both tasks' metrics")
    gen, trav = rec["generate"], rec["traverse"]
    model = gen[0]["model"]
    cfg, on_card = model.cfg, model.net.device.type == "cuda"

    # gigaword: the hypotheses against hub.inference on the same records, batch by batch
    gw = gen[0]["task"]
    hub = OFASys(model, None, gw.global_dict, gw.general_preprocess, device=model.net.device)
    recs = _tsv_records(efx["tsv"]["gigaword"], efx["tasks"]["gigaword"]["cols"])
    kw = dict(beam_size=EVAL_GENERATION["beam"], max_len_b=EVAL_GENERATION["max_len_b"], no_repeat_ngram_size=0)
    B = efx["tasks"]["gigaword"]["batch"]
    with open(os.path.join(fx["root"], "eval_out", "gigaword_valid.json")) as f:
        written = json.load(f)["hyps"]
    hyp_differ, gen_counts = 0, []
    for i, g in enumerate(gen):
        n_valid = g["sample"].get("n_valid", len(g["outputs"]))
        direct = hub.inference(SUMMARY_TPL, [{"src": r["src"]} for r in recs[i * B:i * B + n_valid]], **kw)
        for o, r, w in zip(g["outputs"][:n_valid], direct, written[i * B:i * B + n_valid], strict=True):
            hyp_differ += not (np.array_equal(o[0].tokens, r.tokens) and o[0].text == r.text == w)
        Bs, Ts = _encoder_tokens([s for s in g["sample"]["net_input"]["slots"] if s.is_src])
        gen_counts.append((g["launches"]["dense_attention_fwd"], cfg.encoder.layers * (_route(cfg, Bs, Ts, Ts) == "dense"),
                           (Bs, Ts)))
    log(f"evaluate: gigaword {len(written)} hypotheses against hub.inference on the same records: "
        f"{hyp_differ} differ; B1 per generation batch (launched, expected, encoder (B, T)): {gen_counts}")
    if hyp_differ or len(written) != len(recs):
        raise SystemExit("evaluate: gigaword's hypotheses differ from hub.inference's")

    # sst2: the picks against the plain attention path's scores on the same batches
    ties, max_diff, pass_counts, picks = [], 0.0, [], 0
    for t in trav:
        with plain_attention(cfg):
            plain = t["task"].answer_scores(t["model"], t["sample"], t["answers"])
        max_diff = max(max_diff, float(np.abs(t["scores"] - plain).max()))
        ties += _traverse_ties(t["scores"], plain)
        picks += len(plain)
        Bs, Ts = _encoder_tokens([s for s in t["sample"]["net_input"]["slots"] if s.is_src])
        pre = t["task"].general_preprocess.name2pre["text"]
        per_pass = sum(_expected_pass_launches(cfg, Bs, Ts, len(pre.encode(a)) + 1)
                       for a in t["answers"]) / len(t["answers"])
        pass_counts.append((t["launches"]["dense_attention_fwd"] / len(t["answers"]), per_pass, (Bs, Ts)))
    log(f"evaluate: sst2 picks under B1 against the plain attention path (attn_logits="
        f"{GRAD_REF_LOGITS!r}): {len(ties)} of {picks} differ {ties} (a tie: plain margin <= twice the "
        f"row's score difference); largest score difference {max_diff:.4g} (tol {TRAVERSE_SCORE_ATOL}); "
        f"B1 per candidate pass (launched, expected, encoder (B, T)): {pass_counts} [{card}]")
    if not max_diff <= TRAVERSE_SCORE_ATOL or any(m > 2 * d for _, m, d in ties):
        raise SystemExit("evaluate: sst2's picks under B1 disagree with the plain attention path")
    if on_card and any(a != e for a, e, _ in gen_counts + pass_counts):
        raise SystemExit("evaluate: B1 did not run once per dense attention call")

    rows_per_s = {n: efx["tasks"][n]["rows"] / rec["seconds"][n] for n in efx["tasks"]}
    profile_res = None
    t = trav[0]
    if on_card:
        _sync(model.net.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            t["task"].answer_scores(t["model"], t["sample"], t["answers"])
            _sync(model.net.device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        profile_res = _report_profile(prof, wall_ms, f"one sst2 traverse batch ({len(t['answers'])} candidate "
                                      f"passes, B={len(t['scores'])})", card)
    log(f"evaluate: rows per second {({k: round(v, 2) for k, v in rows_per_s.items()})} (each task's "
        f"Task.evaluate, host clock ending in a synchronize) [{card}]")
    res = dict(metrics=printed, wall_s=wall, rows_per_s=rows_per_s, hyps=len(written), picks=picks,
               ties=ties, max_score_diff=max_diff, gen_launches=gen_counts, pass_launches=pass_counts,
               profile=profile_res)
    return launches, res, dict(task=t["task"], model=t["model"], sample=t["sample"], answers=t["answers"])


def traverse_kernels_and_check(trav, card):
    """Phase traverse_kernels: one sst2 traverse batch's candidate scores
    under B1 against the same scores with B1's plain version
    (dense_attention_fwd_reference) in its place, on the card; within
    TRAVERSE_SCORE_ATOL, the picks equal but at ties."""
    from ofasys_torch.ops import dense_attention as da

    task, model, sample, answers = trav["task"], trav["model"], trav["sample"], trav["answers"]
    before = da.dense_attention_fwd.launches
    kernel = task.answer_scores(model, sample, answers)
    used = da.dense_attention_fwd.launches - before
    orig = da.dense_attention_fwd

    def plain_version(q, k, v, bias, mask, num_heads, scale=1.0, causal=False):
        return da.dense_attention_fwd_reference(q, k, v, bias, mask, num_heads, scale, causal)

    da.dense_attention_fwd = plain_version
    try:
        plain = task.answer_scores(model, sample, answers)
    finally:
        da.dense_attention_fwd = orig
    diff = float(np.abs(kernel - plain).max())
    ties = _traverse_ties(kernel, plain)
    log(f"traverse_kernels: {len(answers)} candidates x B={len(kernel)}: scores under B1 ({used} launches) "
        f"against B1's plain version in its place: largest difference {diff:.4g} (tol "
        f"{TRAVERSE_SCORE_ATOL}), picks differing {ties} [{card}]")
    if not diff <= TRAVERSE_SCORE_ATOL or any(m > 2 * d for _, m, d in ties) \
            or (model.net.device.type == "cuda" and used == 0):
        raise SystemExit("traverse_kernels: B1's scores disagree with its plain version")
    return dict(max_score_diff=diff, ties=ties, launches=used)


def launch_config(fx, run, updates=FIT_UPDATES, arch="base", device="cuda"):
    """train_fit's run written as a config file (JSON): the same tasks,
    TSV files, batch sizes, dropout (the model's default 0.1), adamw at
    TRAIN_LR with clipping, seed and summed mode; ``updates`` updates (the
    length of the polynomial learning-rate schedule), a checkpoint every
    FIT_SAVE_EVERY, into ``<root>/<run>``."""
    tasks = {}
    for name, spec in fx["tasks"].items():
        tasks[name] = {"instruction": {"template": spec["template"]},
                       "dataset": {"train_data": spec["path"], "batch_size": spec["batch"],
                                   "selected_cols": spec["cols"]}}
    model = {"arch": arch} if device == "cuda" else {"arch": arch, "attn_kernel": "pallas"}
    return {"model": model,
            "trainer": {"common": {"seed": SEED, "log_interval": FIT_SAVE_EVERY},
                        "optimization": {"lr": [TRAIN_LR], "multi_task_mode": "sum", "max_update": updates},
                        "checkpoint": {"save_dir": os.path.join(fx["root"], run),
                                       "save_interval_updates": FIT_SAVE_EVERY,
                                       "no_epoch_checkpoints": True}},
            "tasks": tasks}


def _yaml_config_matches(path, data):
    """The same config written as YAML, a parent with the model and trainer
    and a child with ``_include`` and ``${var}`` paths, loads to the same
    dict."""
    import yaml

    from ofasys_torch.launch import load_yaml_config

    root = os.path.dirname(path)
    parent = {k: v for k, v in data.items() if k != "tasks"}
    child = {"_include": "launch_parent.yaml", "env": {"DATA": root}, "tasks": json.loads(
        json.dumps(data["tasks"]).replace(root, "${DATA}"))}
    for name, obj in (("launch_parent.yaml", parent), ("launch_child.yaml", child)):
        with open(os.path.join(root, name), "w") as f:
            yaml.safe_dump(obj, f)
    same = load_yaml_config(os.path.join(root, "launch_child.yaml")) == load_yaml_config(path)
    log(f"launch: pyyaml {yaml.__version__}: the YAML form (_include, ${{DATA}}) loads to the JSON's dict: {same}")
    if not same:
        raise SystemExit("launch: the YAML config loads to another dict than the JSON")


def launch_and_check(fx, fit, card, fit_launches, device="cuda", arch="base"):
    """Phase launch (see the module docstring). Returns the launch counts
    of the launched run and the results."""
    from ofasys_torch import launch
    from ofasys_torch.cli import train as cli_train
    from ofasys_torch.engine.trainer import Trainer
    from ofasys_torch.utils import checkpoint_utils as cu

    data = launch_config(fx, "launch", arch=arch, device=device)
    path = os.path.join(fx["root"], "launch.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    reset_counts()
    t0 = time.perf_counter()
    launch.main([path, "--device", device])
    cu.wait_for_async_saves()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    run = os.path.join(fx["root"], "launch")
    diffs = {}
    metas = {}
    for name, ref in ((f"checkpoint_1_{FIT_SAVE_EVERY}", fit["ck_mid"]), ("checkpoint_last", fit["last"])):
        a, meta_a = cu.load_checkpoint(os.path.join(run, name))
        b, meta_b = cu.load_checkpoint(ref)
        diffs[name] = _ckpt_trees_equal(a, b)
        metas[name] = [{k: v for k, (cls, v) in m["meters"].items()
                        if cls != "TimeMeter" and k not in ("train_wall", "gb_free")} for m in (meta_a, meta_b)]
    per_update = {k: v / FIT_UPDATES for k, v in launches.items() if v}
    log(f"launch: `python -m ofasys_torch.launch launch.json` ({FIT_UPDATES} updates, the schedule's "
        f"length; checkpoints every {FIT_SAVE_EVERY}) in {fit_s:.1f} s; its checkpoints against train_fit's: "
        + "; ".join(f"{n} {'bit for bit' if not d else d[:6]}, meters equal {m[0] == m[1]}"
                    for (n, d), m in zip(diffs.items(), metas.values()))
        + f"; launches {launches} ({per_update} an update; train_fit's {fit_launches}) [{card}]")
    if any(diffs.values()) or any(m[0] != m[1] for m in metas.values()):
        raise SystemExit("launch: the launched run differs from train_fit's")
    if device == "cuda" and (launches != fit_launches or per_update.get("dense_attention_fwd") != 36
                             or per_update.get("dense_attention_bwd") != 36):
        raise SystemExit("launch: B1/B2 did not run 36 times an update")
    _yaml_config_matches(path, data)

    seen = {}
    orig_fit = Trainer.fit

    def recording_fit(self, model, tasks, max_update=None):
        seen["cfg"] = self.cfg
        return orig_fit(self, model, tasks, max_update)

    Trainer.fit = recording_fit
    t0 = time.perf_counter()
    try:
        cli_train.main([path, "--set", "trainer.optimization.max_update=1", "--set",
                        f"trainer.checkpoint.save_dir={os.path.join(fx['root'], 'cli_train')}",
                        "--set", "trainer.checkpoint.no_save=true", "--set", "trainer.optimization.lr=[2.0e-4]",
                        "--device", device])
    finally:
        Trainer.fit = orig_fit
    train_s = time.perf_counter() - t0
    got = seen["cfg"].optimization
    log(f"launch: `python -m ofasys_torch.cli.train launch.json --set trainer.optimization.max_update=1 "
        f"--set trainer.checkpoint.no_save=true --set trainer.optimization.lr=[2.0e-4]` in {train_s:.1f} s: "
        f"TrainerConfig max_update {got.max_update}, lr {got.lr}, no_save {seen['cfg'].checkpoint.no_save}")
    if got.max_update != 1 or got.lr != (2e-4,) or not seen["cfg"].checkpoint.no_save:
        raise SystemExit("launch: cli.train's --set overrides did not reach the TrainerConfig")
    return launches, dict(fit_s=fit_s, per_update=per_update, cli_train_s=train_s)


# ------------------------------------------------------------- slice 16
# serve_speculative: serve's sources as greedy calls (beam 1, no n-gram
# blocking: the calls set_draft routes) one at a time, then one dispatch of
# the first 8, with a tiny-arch draft (random weights from SEED + 7) and
# with the target as its own draft
SPEC_GAMMA = 4
# requests decoded one at a time in each speculative run: the first 4 of
# serve's 16 (the dispatch of 8 takes the first 8)
SPEC_SINGLES = 4
SPEC_OPTS = dict(beam_size=1, no_repeat_ngram_size=0, max_len_b=MAX_LEN_B)
DRAFT_ARCH = "tiny"
# a request's tokens may part from the target-alone run's where the
# target's two choices are within this of each other (the verify step's
# bf16 products round apart from a single step's), as _tokens_vs_plain
# allows serve_closed
SPEC_TIE_TOL = 5e-2
# train_profile: one steady update's idle share from the trainer's trace
PROFILE_UPDATES = (2, 4, 6)
# B1's and B2's device kernels by name in a trace (bf16; the fp32 ones for
# the CPU-free rehearsal names do not occur on the card's bf16 paths)
B1_KERNEL_NAMES = ("dense_attention_fwd_mma_kernel", "dense_attention_fwd_kernel")
B2_KERNEL_NAMES = ("bwd_mma_kernel<false, false>", "bwd_mma_kernel<(bool)0, (bool)0>", "bwd_rows_kernel")
BIN_BLOCK = 512
BIN_BLOCKS = 64


def build_draft_hub(hub, device="cuda", arch=DRAFT_ARCH):
    """A draft for ``hub``: the ``arch`` model (text adaptor, random weights
    from SEED + 7) on the hub's dictionary and preprocessors."""
    from ofasys_torch import GeneralistModel, OFASys

    m = GeneralistModel(arch=arch)
    m.cfg.dropout = 0.0
    m.cfg.attn_kernel = hub.model.cfg.attn_kernel
    m.initialize(hub.global_dict, active_adaptors=("text",), dtype=hub.model.net.dtype, device=device,
                 seed=SEED + 7)
    return OFASys(m, None, hub.global_dict, hub.general_preprocess, device=device)


def _spec_gen(hub):
    """The hub's SpeculativeGenerator (made by its first greedy call)."""
    from ofasys_torch.generator import SpeculativeGenerator

    return next(g for g in hub._generators.values() if isinstance(g, SpeculativeGenerator))


@torch.no_grad()
def _step_logprobs(hub, data, tokens):
    """The target's log-probs at each step of decoding ``tokens`` for one
    record, one single step at a time."""
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.utils.pytree import SlotBatch, slots_to_device

    gp, net, dev = hub.general_preprocess, hub.model.net, hub.device
    slots = gp.collate([gp(Instruction(TPL, split="test").format(**data))])["net_input"]["slots"]
    enc = net.encode(slots_to_device([s for s in slots if s.is_src], dev))
    tgt = SlotBatch.target_slot(slots)
    T_buf = MAX_LEN_B + 2
    dummy = dataclasses.replace(tgt, value={"inputs": torch.zeros((1, T_buf), dtype=torch.long, device=dev)})
    bias, cb, cache = net.decode_prepare([dummy], enc, T_buf)
    prev, out = hub.global_dict.bos(), []
    for step, t in enumerate(tokens):
        logits, _, cache = net.decode_step(torch.full((1, 1), prev, dtype=torch.long, device=dev), step,
                                           enc, bias, cb, cache, tgt)
        out.append(torch.log_softmax(logits[0, -1].float(), dim=-1))
        prev = int(t)
    return torch.stack(out)


def _spec_partings(hub, records, spec, plain):
    """Where a speculative answer differs from the target-alone one: (row,
    position, margin, kind): the target's log-prob gap between the two
    choices at the first differing position ('tie' when within
    SPEC_TIE_TOL), or 'eos' where one of them takes EOS there and the
    beam-1 search's answer scores at least the greedy path's (a beam of one
    keeps its second candidate alive beside a finished one)."""
    eos, out = hub.global_dict.eos(), []
    for i, (data, s, p) in enumerate(zip(records, spec, plain, strict=True)):
        s, p = _best(s), _best(p)
        if np.array_equal(s.tokens, p.tokens):
            continue
        n = min(len(s.tokens), len(p.tokens))
        pos = int(np.nonzero(s.tokens[:n] != p.tokens[:n])[0][0])
        lp = _step_logprobs(hub, data, s.tokens[:pos + 1])[pos]
        margin = abs(float(lp[int(s.tokens[pos])] - lp[int(p.tokens[pos])]))
        if margin <= SPEC_TIE_TOL:
            kind = "tie"
        elif eos in (int(s.tokens[pos]), int(p.tokens[pos])) and p.score >= s.score:
            kind = "eos"
        else:
            kind = "differs"
        out.append((i, pos, margin, kind))
    return out


def _spec_run(spec_hub, plain_hub, records, card, label):
    """Each of the first SPEC_SINGLES records alone through both hubs
    (target-alone, speculative, speculative, target-alone, timed by the
    host clock ending in a synchronize), then one dispatch of the first 8:
    the speculative runs' launch counts (the first speculative pass and the
    dispatch), answers, per-call stats and host syncs, and the p50s."""
    dev = spec_hub.device
    records = records[:SPEC_SINGLES]
    spec_hub.inference(TPL, records[:2], **SPEC_OPTS)          # warm-up, makes the generator
    plain_hub.inference(TPL, records[:2], **SPEC_OPTS)
    gen = _spec_gen(spec_hub)
    gen.rejections = []
    times = {"plain": [], "spec": []}
    answers = {"plain": [], "spec": []}
    stats, syncs = [], []
    launches = None
    for turn, which in enumerate(("plain", "spec", "spec", "plain")):
        hub = spec_hub if which == "spec" else plain_hub
        if turn == 1:
            reset_counts()
        for data in records:
            _sync(dev)
            t0 = time.perf_counter()
            out = hub.inference(TPL, data, **SPEC_OPTS)
            _sync(dev)
            times[which].append((time.perf_counter() - t0) * 1e3)
            if turn in (0, 1):
                answers[which].append(out)
            if turn == 1:
                stats.append(dict(gen.last_stats))
                syncs.append(gen.last_host_syncs)
        if turn == 1:
            single = read_counts()
    reset_counts()
    batch_spec = spec_hub.inference(TPL, records[:8], **SPEC_OPTS)
    _sync(dev)
    batched = read_counts()
    batch_stats, batch_syncs = dict(gen.last_stats), gen.last_host_syncs
    batch_plain = plain_hub.inference(TPL, records[:8], **SPEC_OPTS)
    launches = {k: single[k] + batched[k] for k in KERNELS}
    iters = [s["target_steps"] - 1 for s in stats]
    per_verify = [(n - 2) / it for n, it in zip(syncs, iters) if it]
    res = dict(
        launches=launches, single_launches=single, batch_launches=batched,
        p50_ms=statistics.median(times["spec"]), plain_p50_ms=statistics.median(times["plain"]),
        target_steps=sum(s["target_steps"] for s in stats), tokens=sum(s["tokens"] for s in stats),
        tokens_per_verify=statistics.mean(s["tokens_per_verify"] for s in stats if s["target_steps"] > 1),
        mean_accepted=statistics.mean(s["mean_accepted"] for s in stats if s["target_steps"] > 1),
        host_syncs_per_verify=max(per_verify) if per_verify else 0.0, batch_stats=batch_stats,
        batch_host_syncs=batch_syncs, rejections=len(gen.rejections),
        rejection_margins=sorted(gen.rejections)[:8])
    partings = _spec_partings(spec_hub, records, answers["spec"], answers["plain"]) \
        + [(f"dispatch row {i}", *rest) for i, *rest in
           _spec_partings(spec_hub, records[:8], batch_spec, batch_plain)]
    res["partings"] = partings
    log(f"  {label}: {len(records)} requests one at a time (gamma {gen.gamma}): target steps "
        f"{res['target_steps']} for {res['tokens']} tokens, tokens per verify "
        f"{res['tokens_per_verify']:.3f}, mean accepted {res['mean_accepted']:.3f} of {gen.gamma}, "
        f"host syncs per verify {res['host_syncs_per_verify']:.2f} (plus the prefill's and the "
        f"readback); dispatch of 8: {batch_stats}, {batch_syncs} host syncs; {res['rejections']} "
        f"rejected proposals; p50 {res['p50_ms']:.2f} ms beside target-alone greedy "
        f"{res['plain_p50_ms']:.2f} ms (same call, B=1) [{card}]")
    log(f"  {label}: answers against target-alone greedy: "
        f"{len(records) + 8 - len(partings)} of {len(records) + 8} equal"
        + (f"; parting (row, position, target margin, kind): {partings}" if partings else ""))
    if any(kind == "differs" for *_, kind in partings):
        raise SystemExit(f"{label}: speculative tokens differ from the target's greedy decode")
    return res


def serve_speculative_and_check(hub, card, serve_res=None):
    """serve_speculative: set_draft with a tiny draft, then the target as
    its own draft (every proposal accepted but at near-ties); B1 in the
    dispatch of 8 in the target's and the draft's encoders, none at B=1."""
    from ofasys_torch import OFASys
    from ofasys_torch.model.transformer import attention_route

    dev = hub.device
    records = [r for r, _ in _serve_requests()]
    draft = build_draft_hub(hub, device=dev)
    plain = OFASys(hub.model, None, hub.global_dict, hub.general_preprocess, device=dev)
    spec = OFASys(hub.model, None, hub.global_dict, hub.general_preprocess, device=dev)
    spec.set_draft(draft, gamma=SPEC_GAMMA)
    dcfg = draft.model.cfg
    B, T = _encoder_shape(hub.general_preprocess, records[:8], TPL)
    routes = {}
    for who, cfg in (("target", hub.model.cfg), ("draft", dcfg)):
        H = cfg.encoder.attention_heads
        routes[who] = {(b, t): attention_route(cfg, dev, b, t, t, H, cfg.encoder.embed_dim // H, 0.0,
                                          bias_shape=(1, H, t, t), mask_shape=(b, 1, 1, t))
                       for b, t in [(B, T)] + [_encoder_shape(hub.general_preprocess, [r], TPL)
                                               for r in records]}
    expected_b1 = sum(cfg.encoder.layers for who, cfg in (("target", hub.model.cfg), ("draft", dcfg))
                      if routes[who][(B, T)] == "dense")
    log(f"serve_speculative: draft {DRAFT_ARCH} arch E={dcfg.encoder.embed_dim} heads="
        f"{dcfg.encoder.attention_heads} layers={dcfg.encoder.layers}+{dcfg.decoder.layers}, gamma "
        f"{SPEC_GAMMA}; encoder routes (B, T) target {routes['target']}, draft {routes['draft']}; "
        f"expected B1 in the dispatch of 8: {expected_b1}")
    res = _spec_run(spec, plain, records, card, "serve_speculative")
    b1 = res["batch_launches"]["dense_attention_fwd"]
    log(f"  serve_speculative: launches at B=1 {({k: v for k, v in res['single_launches'].items() if v})}, "
        f"in the dispatch of 8 {({k: v for k, v in res['batch_launches'].items() if v})} "
        f"(B1 {b1}, expected {expected_b1})")
    if dev.type == "cuda" and (b1 != expected_b1 or expected_b1 == 0
                               or any(v for v in res["single_launches"].values())):
        raise SystemExit("serve_speculative: B1 did not run once per dense encoder layer of the dispatch")
    self_spec = OFASys(hub.model, None, hub.global_dict, hub.general_preprocess, device=dev)
    self_spec.set_draft(plain, gamma=SPEC_GAMMA)
    self_res = _spec_run(self_spec, plain, records, card, "serve_speculative self-draft")
    bad = [m for m in _spec_gen(self_spec).rejections if m > SPEC_TIE_TOL]
    log(f"  serve_speculative self-draft: {self_res['rejections']} rejected proposals, their target "
        f"margins {self_res['rejection_margins']} (near-tie tol {SPEC_TIE_TOL})")
    if bad:
        raise SystemExit(f"serve_speculative: the self-draft was rejected past a near-tie ({bad[:4]})")
    if serve_res is not None:
        log(f"  serve_speculative vs serve: p50 {res['p50_ms']:.2f} ms (B=1 greedy) vs serve's "
            f"{serve_res['p50_ms']} ms (server, beam 5 mix) [{card}]")
    res["self_draft"] = {k: v for k, v in self_res.items() if k not in ("launches",)}
    return res


def _check_boxes(outs, box, eos, constrained):
    """serve_ground's answers: the faults, and the requests whose four
    tokens are not all bins (no 4-vector box). Every answer is 4 tokens +
    EOS; where its four tokens are bins, its box is a 4-vector in [0, 1];
    under the constraint range every answer's are."""
    faults, nobox = [], []
    for i, o in enumerate(outs):
        toks, b = np.asarray(o.tokens), np.asarray(o.box if o.box is not None else [])
        if len(toks) != 5 or toks[-1] != eos:
            faults.append(f"request {i}: {len(toks)} tokens, not 4 + EOS")
            continue
        bins = ((toks[:4] >= box.bin_start) & (toks[:4] < box.bin_end)).all()
        if not bins:
            nobox.append(i)
            if constrained:
                faults.append(f"request {i}: a token outside the constraint range")
        if (bins or constrained) and not (b.shape == (4,) and ((b >= 0) & (b <= 1)).all()):
            faults.append(f"request {i}: box {b!r} is not a 4-vector in [0, 1]")
    return faults, nobox


@contextlib.contextmanager
def _testfs(root):
    """testfs://<path> served from ``root`` by a fetcher that copies the
    file, registered for the block."""
    from ofasys_torch.utils import file_utils

    fetched = []

    def fetch(url, dest):
        fetched.append(url)
        shutil.copyfile(os.path.join(root, url[len("testfs://"):]), dest)

    saved = file_utils._SCHEME_FETCHERS.get("testfs")
    file_utils.register_scheme_fetcher("testfs", fetch)
    try:
        yield fetched
    finally:
        if saved is None:
            file_utils._SCHEME_FETCHERS.pop("testfs", None)
        else:
            file_utils.register_scheme_fetcher("testfs", saved)


def _fit_model(arch, device):
    from ofasys_torch import GeneralistModel

    m = GeneralistModel(arch=arch)
    if torch.device(device).type == "cpu":
        m.cfg.attn_kernel = "pallas"
    return m


def _vs_train_fit(run_dir, fit, label):
    """checkpoint_1_2 and checkpoint_last of ``run_dir`` against train_fit's,
    params, moments and step bit for bit, with the meters."""
    from ofasys_torch.utils import checkpoint_utils as cu

    diffs, meters = {}, {}
    for name, ref in ((f"checkpoint_1_{FIT_SAVE_EVERY}", fit["ck_mid"]), ("checkpoint_last", fit["last"])):
        a, meta_a = cu.load_checkpoint(os.path.join(run_dir, name))
        b, meta_b = cu.load_checkpoint(ref)
        diffs[name] = _ckpt_trees_equal(a, b)
        meters[name] = [{k: v for k, (cls, v) in m["meters"].items()
                         if cls != "TimeMeter" and k not in ("train_wall", "gb_free")} for m in (meta_a, meta_b)]
    same = not any(diffs.values()) and all(m[0] == m[1] for m in meters.values())
    log(f"  {label}: checkpoints against train_fit's: "
        + "; ".join(f"{n} {'bit for bit' if not d else d[:6]}, meters equal {meters[n][0] == meters[n][1]}"
                    for n, d in diffs.items()))
    if not same:
        raise SystemExit(f"{label}: the run differs from train_fit's")


def _count_named(kernels, names):
    return sum(c for k, c in kernels.items() if any(n in k for n in names))


def _pct(x):
    return "not measured" if x is None else f"{100 * x:.1f}%"


def train_profile_and_check(fx, fit, card, fit_res=None, device="cuda", arch="base"):
    """train_profile: train_fit's run with common.profile=True: the trace
    the trainer wrote, read by tools/profile_breakdown with one summary per
    'update <n>' range; B1 and B2 counted in it by kernel name (36 each an
    update), one steady update's idle share from it beside train_fit's
    torch.profiler figure; its checkpoints bit for bit with train_fit's.
    Returns the launch counts, the results and the tool's summary."""
    from ofasys_torch import Trainer
    from ofasys_torch.tools import profile_breakdown
    from ofasys_torch.utils import profiler

    cfg = fit_config(fx, "profile")
    cfg.common.profile = True
    cfg.common.profile_dir = os.path.join(fx["root"], "profile_trace")
    reset_counts()
    t0 = time.perf_counter()
    Trainer(cfg, device=device).fit(_fit_model(arch, device), fit_tasks(fx), max_update=FIT_UPDATES)
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    path = os.path.join(cfg.common.profile_dir, profiler.TRACE_FILE)
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    summary = profile_breakdown.summarize(path, top_n=10, ranges="update ", verbose=False)
    read_s = time.perf_counter() - t0
    updates = {int(name.split()[1]): r for name, r in summary["ranges"].items()}
    b1 = {n: _count_named(u["op_counts"], B1_KERNEL_NAMES) for n, u in updates.items()}
    b2 = {n: _count_named(u["op_counts"], B2_KERNEL_NAMES) for n, u in updates.items()}
    steady = {n: updates[n] for n in PROFILE_UPDATES if n in updates and updates[n]["idle"] is not None}
    idle = statistics.median(u["idle"] for u in steady.values()) if steady else None
    fit_idle = ((fit_res or {}).get("profile") or {}).get("idle")
    log(f"train_profile: Trainer.fit with common.profile=True, {FIT_UPDATES} updates in {fit_s:.1f} s; "
        f"trace {path} ({nbytes} bytes, read by profile_breakdown in {read_s:.1f} s), update ranges "
        f"{sorted(updates)}; per update wall/busy ms, idle, launches: "
        + "; ".join(f"{n}: {u['wall_ms']:.2f}/{u['busy_ms']:.2f}, {_pct(u['idle'])}, {u['launches']}"
                    for n, u in sorted(updates.items()))
        + f"; steady updates {sorted(steady)} median idle {_pct(idle)} (train_fit's one profiled "
        f"update {_pct(fit_idle)}) [{card}]")
    log(f"  train_profile: B1 by kernel name an update {b1}, B2 {b2}; wrapper counts {launches}")
    if torch.device(device).type == "cuda":
        if sorted(updates) != list(range(1, FIT_UPDATES + 1)) or set(b1.values()) != {36} \
                or set(b2.values()) != {36} or launches["dense_attention_fwd"] != 36 * FIT_UPDATES:
            raise SystemExit("train_profile: the trace does not show 36 B1 and 36 B2 in every update")
    _vs_train_fit(os.path.join(fx["root"], "profile"), fit, "train_profile")
    keep = ("wall_ms", "busy_ms", "idle", "launches", "copies")
    return launches, dict(fit_s=fit_s, trace_bytes=nbytes, read_s=read_s, idle_steady=idle,
                          train_fit_idle=fit_idle,
                          updates={n: {k: u[k] for k in keep} for n, u in updates.items()},
                          b1_by_update=b1, b2_by_update=b2), summary


def _encode_all(tok, texts):
    """The ids of every text, and the µs a text of a first (cold word
    caches) and a second (warm) pass."""
    out = []
    for _ in range(2):
        t0 = time.perf_counter()
        ids = [tok.encode(t) for t in texts]
        out.append((time.perf_counter() - t0) * 1e6 / len(texts))
    return ids, out


def host_native_and_check(fx, card, breakdown, profile_res=None, fit_res=None):
    """host_native: the native data plane on train_fit's data. Serve's
    request sources and the TSV texts through NativeGPT2BPE and GPT2BPE on
    train_fit's table (the same ids for every string; µs a string);
    preprocess_ms per task with each encoder (OFASYS_NATIVE_BPE), alternated
    in this call; the TSVs' line index natively and by the numpy scan (the
    same bytes); and profile_breakdown's summary of train_profile's trace
    (``breakdown``) logged: kinds, top ops, the longest gaps with their
    host events, the steady updates' idle beside train_fit's figure."""
    from ofasys_torch.io.reader import file_reader
    from ofasys_torch.preprocessor.tokenizer.gpt2_bpe import GPT2BPE
    from ofasys_torch.preprocessor.tokenizer.native_bpe import NativeGPT2BPE
    from ofasys_torch.tools import profile_breakdown

    texts = [r["src"] for r, _ in _serve_requests()]
    for spec in fx["tasks"].values():
        with open(spec["path"], encoding="utf-8") as f:
            texts += [col for line in f for col in line.rstrip("\n").split("\t")]
    res = dict(strings=len(texts), bytes=sum(len(t.encode()) for t in texts))
    ids, load_ms = {}, {}
    for label, cls in (("native", NativeGPT2BPE), ("python", GPT2BPE)):
        t0 = time.perf_counter()
        tok = cls(fx["encoder_json"], fx["vocab_bpe"])
        load_ms[label] = (time.perf_counter() - t0) * 1e3
        ids[label], res[f"{label}_us"] = _encode_all(tok, texts)
    differ = [i for i, (a, b) in enumerate(zip(ids["native"], ids["python"])) if a != b]
    res.update(ids=sum(map(len, ids["python"])), differ=len(differ), load_ms=load_ms)
    log(f"host_native: {len(texts)} strings ({res['bytes']} bytes, {res['ids']} ids: serve's "
        f"{N_BEAM_REQUESTS + N_GREEDY_REQUESTS} sources and the TSV texts) on the "
        f"{fx['table']['entries']}-entry table: ids of NativeGPT2BPE and GPT2BPE equal for "
        f"{len(texts) - len(differ)} of {len(texts)}; µs a string cold / warm: native "
        f"{res['native_us'][0]:.2f} / {res['native_us'][1]:.2f}, python {res['python_us'][0]:.2f} / "
        f"{res['python_us'][1]:.2f} (python / native {res['python_us'][0] / res['native_us'][0]:.1f}x "
        f"cold, {res['python_us'][1] / res['native_us'][1]:.1f}x warm); table load ms "
        f"{ {k: round(v, 1) for k, v in load_ms.items()} } [host CPU]")
    if differ:
        raise SystemExit(f"host_native: the native ids differ on {len(differ)} strings, e.g. "
                         f"{texts[differ[0]][:80]!r}")

    prep, kinds = {"native": [], "python": []}, {}
    saved = os.environ.get("OFASYS_NATIVE_BPE")
    try:
        for label in ("native", "python", "native", "python"):
            os.environ["OFASYS_NATIVE_BPE"] = "1" if label == "native" else "0"
            seen = []
            prep[label].append(preprocess_ms(fx, tokenizers=seen))
            kinds[label] = sorted(set(seen))
    finally:
        if saved is None:
            os.environ.pop("OFASYS_NATIVE_BPE", None)
        else:
            os.environ["OFASYS_NATIVE_BPE"] = saved
    res["preprocess_ms"] = {label: {t: [round(r[t], 2) for r in runs] for t in runs[0]}
                            for label, runs in prep.items()}
    log(f"host_native: host ms to read, preprocess and collate one batch per task (median of "
        f"{min(3, FIT_BATCHES_PER_EPOCH)}, no prefetch), native and python alternated in this call: "
        f"{res['preprocess_ms']}; tokenizers {kinds} [host CPU]")
    if kinds != {"native": ["NativeGPT2BPE"], "python": ["GPT2BPE"]}:
        raise SystemExit(f"host_native: OFASYS_NATIVE_BPE did not pick the encoder: {kinds}")

    res["index"] = {}
    for name, spec in fx["tasks"].items():
        out, ms = {}, {}
        for label, fn in (("native", file_reader._build_index_native),
                          ("numpy", file_reader._build_index_numpy)):
            dst = os.path.join(fx["root"], f"{name}.{label}.idx")
            t0 = time.perf_counter()
            fn(spec["path"], dst)
            ms[label] = (time.perf_counter() - t0) * 1e3
            with open(dst, "rb") as f:
                out[label] = f.read()
        res["index"][name] = dict(ms, bytes=len(out["native"]), same=out["native"] == out["numpy"],
                                  file_bytes=os.path.getsize(spec["path"]))
    log(f"host_native: line index of train_fit's TSVs, native and numpy (ms, warm reads): "
        f"{res['index']} [host CPU]")
    if not all(r["same"] for r in res["index"].values()):
        raise SystemExit("host_native: the native line index differs from the numpy scan's")

    log("host_native: profile_breakdown of train_profile's trace, all updates:")
    lines = profile_breakdown.format_window(breakdown, 10, "  ")
    ranges = {int(k.split()[1]): r for k, r in breakdown.get("ranges", {}).items()}
    steady = [n for n in PROFILE_UPDATES if n in ranges]
    for n in steady:
        lines += [f"  update {n}:"] + profile_breakdown.format_window(ranges[n], 5, "    ")
    for line in lines:
        log(line)
    idle = {n: ranges[n]["idle"] for n in steady}
    fit_idle = ((fit_res or {}).get("profile") or {}).get("idle")
    log(f"host_native: steady updates' idle share from profile_breakdown (the union of device "
        f"events) {({n: _pct(v) for n, v in idle.items()})}; train_profile's median "
        f"{_pct((profile_res or {}).get('idle_steady'))}; train_fit's one profiled update "
        f"{_pct(fit_idle)} (torch.profiler on the card alone, key_averages summed) [{card}]")
    if breakdown["device"]:
        if not breakdown["gaps"] or not all(k in breakdown["by_kind"] for k in ("B1", "B2")):
            raise SystemExit("host_native: the breakdown shows no gaps or no B1/B2")
    res["breakdown"] = dict(
        wall_ms=breakdown["wall_ms"], busy_ms=breakdown["busy_ms"], idle=breakdown["idle"],
        launches=breakdown["launches"],
        by_kind={k: round(v["ms"], 3) for k, v in breakdown["by_kind"].items()},
        gaps=[dict(ms=round(g["ms"], 3), host=g["stack"][-3:]) for g in breakdown["gaps"]],
        steady_idle=idle, train_fit_idle=fit_idle)
    return res


def train_fetch_and_check(fx, fit, card, device="cuda", arch="base"):
    """train_fetch: train_fit's TSVs read as testfs:// URLs through a
    registered fetcher into a fresh $OFA_CACHE_HOME, bit for bit with
    train_fit at updates 3 and 6, one cache entry per file with its
    sidecar; then a .bin token file read by OssTextBinReader."""
    from ofasys_torch import Trainer
    from ofasys_torch.io.reader.object_store import OssTextBinReader

    saved = os.environ.get("OFA_CACHE_HOME")
    cache = tempfile.mkdtemp(prefix="cache_", dir=fx["root"])
    os.environ["OFA_CACHE_HOME"] = cache
    try:
        with _testfs(fx["root"]) as fetched:
            tasks = fit_tasks(fx, url=lambda p: "testfs://" + os.path.relpath(p, fx["root"]))
            reset_counts()
            t0 = time.perf_counter()
            Trainer(fit_config(fx, "fetch"), device=device).fit(_fit_model(arch, device), tasks,
                                                                 max_update=FIT_UPDATES)
            fit_s = time.perf_counter() - t0
            launches = read_counts()
            rng = np.random.default_rng(SEED + 16)
            ids = rng.integers(0, 50_000, size=BIN_BLOCKS * BIN_BLOCK + 100).astype(np.int32)
            ids.tofile(os.path.join(fx["root"], "lm.bin"))
            reader = OssTextBinReader("testfs://lm.bin", block_tokens=BIN_BLOCK)
            blocks = [reader.read(i) for i in range(len(reader))]
        entries = sorted(os.listdir(cache))
    finally:
        if saved is None:
            os.environ.pop("OFA_CACHE_HOME", None)
        else:
            os.environ["OFA_CACHE_HOME"] = saved
    data = [e for e in entries if not e.endswith((".json", ".lock"))]
    sidecars = {e: json.load(open(os.path.join(cache, e + ".json")))["url"] for e in data
                if os.path.exists(os.path.join(cache, e + ".json"))}
    want = sorted([f"testfs://{os.path.relpath(s['path'], fx['root'])}" for s in fx["tasks"].values()]
                  + ["testfs://lm.bin"])
    bin_ok = len(blocks) == BIN_BLOCKS and all(
        np.array_equal(b, ids[i * BIN_BLOCK:(i + 1) * BIN_BLOCK]) for i, b in enumerate(blocks))
    log(f"train_fetch: {len(tasks)} TSVs as testfs:// URLs, {FIT_UPDATES} updates in {fit_s:.1f} s, "
        f"launches {({k: v for k, v in launches.items() if v})}; fetched {fetched}; cache entries "
        f"{entries}; sidecars {sidecars}; .bin: {len(blocks)} blocks of {BIN_BLOCK} ids equal the "
        f"array's: {bin_ok} [{card}]")
    if sorted(fetched) != want or sorted(sidecars.values()) != want or len(data) != len(want):
        raise SystemExit("train_fetch: not one cache entry and sidecar per fetched file")
    if not bin_ok:
        raise SystemExit("train_fetch: OssTextBinReader's records differ from the .bin array")
    if torch.device(device).type == "cuda" and (launches["dense_attention_fwd"] != 36 * FIT_UPDATES
                                                or launches["dense_attention_bwd"] != 36 * FIT_UPDATES):
        raise SystemExit("train_fetch: B1/B2 did not run 36 times an update")
    _vs_train_fit(os.path.join(fx["root"], "fetch"), fit, "train_fetch")
    return launches, dict(fit_s=fit_s, cache_entries=len(entries), bin_blocks=len(blocks))


def nan_check_and_check(hub, card):
    """nan_check: gradients of one backward through the hub's net (the
    first serve dispatch's records, a sum of the log-partition of every
    logit row) with a NaN planted in one leaf: check_tree names its flax
    path; a NaN planted in one encoder layer's fc1 output: debug_forward
    names that module first."""
    from ofasys_torch.engine import nan_detector
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.utils.pytree import slots_to_device

    gp, net = hub.general_preprocess, hub.model.net
    recs = [r for r, _ in _serve_requests()[:8]]
    sample = gp.collate([gp(Instruction(TPL, split="train").format(**r)) for r in recs])
    slots = slots_to_device(sample["net_input"]["slots"], hub.device)
    t0 = time.perf_counter()
    logits, _ = net(slots)
    logits.float().logsumexp(-1).mean().backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    clean = nan_detector.check_tree(grads, "grads", net=net)
    leaf = f"decoder.layers_{net.cfg.decoder.layers // 2}.self_attn.k_proj.weight"
    grads[leaf][3, 5] = float("nan")
    found = nan_detector.check_tree(grads, "grads", net=net)
    net.zero_grad(set_to_none=True)
    layer = f"encoder.layers_{net.cfg.encoder.layers // 2}.ffn.fc1"

    def plant(_m, _i, out):
        out = out.clone()
        out[0, 0, 0] = float("nan")
        return out

    handle = net.get_submodule(layer).register_forward_hook(plant)
    try:
        bad = nan_detector.debug_forward(hub.model, sample["net_input"]["slots"])
    finally:
        handle.remove()
    clean_fwd = nan_detector.debug_forward(hub.model, sample["net_input"]["slots"])
    want_leaf = leaf.replace(".", "/").replace("/weight", "/kernel")
    log(f"nan_check: E={net.cfg.encoder.embed_dim} gradients of {len(grads)} leaves: clean {clean}; NaN planted in {leaf}: "
        f"check_tree gives {found}; NaN planted in {layer}'s output: debug_forward's first module "
        f"{bad[:1]} of {len(bad)}, none after removing it: {clean_fwd == []} "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")
    if clean or found != [want_leaf] or not bad or bad[0] != layer.replace(".", "/") or clean_fwd:
        raise SystemExit("nan_check: the planted non-finite values were not found where they are")
    return dict(found=found, first=bad[0], n_bad=len(bad))


# --------------------------------------- speech targets, SCST, image codes
# text to speech and audio pretraining: ofasys_tpu's text_to_speech and
# audio_pretraining templates (task/tasks.py:360-370); the TTS targets are
# 16 kHz wavs of 1.0-3.0 s (100-300 fbank frames: the decoder's
# self-attention at T >= 256 takes the flash kernels, its cross-attention
# over the text stays plain), the pretraining sources serve_asr's wavs. The
# speech model adds audio_tgt_fbank to the text, image_vit (SCST's caption
# task) and audio_fbank adaptors; random weights from SEED, dropout 0.1 in
# its training calls, the TTS prenet's dropout 0.5 (on at inference too)
SPEECH_ADAPTORS = ("text", "image_vit", "audio_fbank", "audio_tgt_fbank")
TTS_TPL = "[TEXT:text] -> [AUDIO:wav,adaptor=audio_tgt_fbank]"
PRETRAIN_TPL = "[AUDIO:wav,mask=true] -> [TEXT:text]"
N_TTS_REQUESTS = 8
TTS_MAX_ITER = 256
TTS_TRAIN_TASKS = {"tts": dict(template=TTS_TPL, batch=16, text=(40, 80), audio=(1.0, 3.0),
                               criterion="tacotron2")}
TINY_TTS_TRAIN_TASKS = {"tts": dict(TTS_TRAIN_TASKS["tts"], batch=2, audio=(0.3, 0.5))}
PRETRAIN_TRAIN_TASKS = {"audio_pretrain": dict(template=PRETRAIN_TPL, batch=32, audio=ASR_SECONDS,
                                               text=(26, 30), criterion="speech_pretrain")}
TINY_PRETRAIN_TRAIN_TASKS = {"audio_pretrain": dict(PRETRAIN_TRAIN_TASKS["audio_pretrain"], batch=2,
                                                    audio=(1.0, 1.2))}
# serve_tts: the first decode steps' frames under the kernels against the
# plain attention path with the same prenet dropout draws: the encoder
# states differ by ENC_REL_TOL-sized bf16 rounding (B1 vs bf16 scores), and
# each frame is fp32 Dense and convolutions of them, so the frames differ
# by about as much: relative Frobenius error <= TTS_REL_TOL
TTS_FRAME_STEPS = 8
TTS_REL_TOL = 5e-2
# train_scst: the caption task on image_vit at 224 px, B=16, 5 samples a
# source at top-k 50 (ofasys_tpu's scst_reward_criterion defaults), decoded
# up to MAX_LEN_B tokens, CIDEr-D against 2 seeded references an image
SCST_BATCH = 16
SCST_SAMPLES = 5
SCST_TOPK = 50
# image codes: a second model on a dictionary with the 8,192 <code>_i of the
# image_vqgan preprocessor (taming's gumbel f8 VQGAN at 256 px: 1,024 codes
# an image, random weights from seed 0, run by the preprocessor on the card)
# and adaptors text, image_vit and image_vqgan. image_gen's template
# (task/tasks.py:100) with prompts long enough that a dispatch of two meets
# B1's gate (B * T >= 256), best-of-2 as two sampling beams under the hub's
# IMAGE defaults (top-k 256, exactly 1,024 codes); image_infilling's
# template (task/tasks.py:83), B=8, its targets 1,024 codes and EOS: the
# preprocessor's max_tgt_length raised from 256 to 1,025 (at 256 the text
# group cuts a target to 256 codes, as in ofasys_tpu), so the decoder's
# self-attention runs the flash kernels at T = 1,025 (padded to 1,032) and
# its cross-attention over the 196 patches and prompt stays plain
VQGAN_ADAPTORS = ("text", "image_vit", "image_vqgan")
IMAGE_GEN_TPL = "[TEXT:cap] -> [IMAGE:code,preprocess=image_vqgan,adaptor=image_vqgan]"
IMAGE_INFILL_TPL = ("what is the complete image? [IMAGE:img,mask_ratio=0.5] -> "
                    "[IMAGE:code,preprocess=image_vqgan,adaptor=image_vqgan]")
CODE_IMAGE_SIZE = 256
# serve_image_gen decodes 1,024 codes a candidate one step at a time on the
# host: the code model (image_gen, image_infilling) runs at the base width
# and half its depth
CODE_LAYERS = 3
IMAGE_GEN_PROMPT = (130, 160)
N_IMAGE_GEN_PROMPTS = 2
IMAGE_GEN_BEST_OF = 2
INFILL_TRAIN_TASKS = {"image_infilling": dict(template=IMAGE_INFILL_TPL, batch=8, image=IMAGE_SIZE,
                                              code_image=CODE_IMAGE_SIZE)}
TINY_INFILL_TRAIN_TASKS = {"image_infilling": dict(INFILL_TRAIN_TASKS["image_infilling"], batch=2,
                                                   code_image=32)}


def vqgan_preprocess(device="cuda", code_image_size=CODE_IMAGE_SIZE):
    """The image-code model's dictionary and preprocessors: the byte
    symbols and <mask> (text), the 8,192 <code>_i (image_vqgan), then
    <text>_256 .. 49,999, padded to a multiple of 8; the image_vqgan
    preprocessor at ``code_image_size`` with whole images and EOS as
    targets (max_tgt_length = its codes + 1), its VQGAN on ``device``."""
    from ofasys_torch.configure.config_store import ConfigStore
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    node = ConfigStore().get("ofasys.preprocess", "image_vqgan").config
    saved, node.code_image_size = node.code_image_size, code_image_size
    try:
        d = Dictionary()
        gp = GeneralPreprocess(d, active=["text", "image", "image_vqgan"]).to(device)
    finally:
        node.code_image_size = saved
    pre = gp.name2pre["image_vqgan"]
    pre.cfg.max_tgt_length = pre.tokenizer.codes_per_image + 1      # the codes and EOS
    for i in range(256, 50000):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d, gp


def build_vqgan_model(d, device="cuda", arch="base", dtype=torch.bfloat16, adaptors=VQGAN_ADAPTORS,
                      code_image_size=CODE_IMAGE_SIZE, layers=None):
    """The image-code model (random weights from SEED), its image_vqgan
    adaptor at the preprocessor's code size; ``layers`` cuts both stacks
    to that depth."""
    from ofasys_torch import GeneralistModel
    from ofasys_torch.adaptor.image_vqgan import ImageVqganAdaptorConfig

    t0 = time.perf_counter()
    model = GeneralistModel(arch=arch, **({} if layers is None else
                                          {"encoder.layers": layers, "decoder.layers": layers}))
    model.initialize(d, active_adaptors=adaptors, dtype=dtype, device=device, seed=SEED,
                     adaptor_cfgs={"image_vqgan": ImageVqganAdaptorConfig(code_image_size=code_image_size)})
    cfg = model.cfg
    log(f"image codes: {arch} arch E={cfg.encoder.embed_dim} layers={cfg.encoder.layers}+"
        f"{cfg.decoder.layers} vocab={len(d)} adaptors={adaptors} "
        f"params={sum(p.numel() for p in model.net.parameters())} built in {time.perf_counter() - t0:.1f} s")
    return model


def _tts_requests():
    """serve_tts: the first 8 of serve's sources as texts to speak."""
    return [{"text": r["src"]} for r, _ in _serve_requests()[:N_TTS_REQUESTS]]


def serve_tts_and_check(model, gp, card):
    """serve_tts: text_to_speech through the hub, 8 requests in one
    dispatch: at the default EOS threshold (0.5), then a full decode of
    TTS_MAX_ITER frames (threshold 1.0: no sample stops); every frame
    finite with 80 bins, lengths in [1, TTS_MAX_ITER], a Griffin-Lim
    waveform each; B1 once per encoder layer of each dispatch where its
    route is dense, no other kernel (the decode steps run the KV cache);
    then the first TTS_FRAME_STEPS frames under the kernels against the
    plain attention path with the same prenet draws (TTS_REL_TOL)."""
    from ofasys_torch import OFASys
    from ofasys_torch.generator import AutoRegressiveSpeechGenerator
    from ofasys_torch.preprocessor.instruction import Instruction

    hub = OFASys(model, None, model.global_dict, gp, device=model.net.device)
    data = _tts_requests()
    device, cfg = hub.device, model.cfg
    sample = gp.collate([gp(Instruction(TTS_TPL, split="test").format(**r)) for r in data])
    B, T = _encoder_tokens(sample["net_input"]["slots"])
    route = _route(cfg, B, T, T)
    hub.inference(TTS_TPL, data[:2], max_iter=4)                  # warm-up
    _sync(device)
    reset_counts()
    runs = {}
    for label, opts in (("eos 0.5", {}), ("full", dict(eos_prob_threshold=1.0))):
        t0 = time.perf_counter()
        outs = hub.inference(TTS_TPL, data, max_iter=TTS_MAX_ITER, **opts)
        _sync(device)
        runs[label] = (outs, (time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    for label, (outs, ms) in runs.items():
        lengths = [len(o.feature) for o in outs]
        ok = (len(outs) == len(data)
              and all(o.feature.shape[1] == 80 and np.isfinite(o.feature).all() for o in outs)
              and all(1 <= n <= TTS_MAX_ITER for n in lengths)
              and all(o.waveform is not None and o.waveform.ndim == 1 and np.isfinite(o.waveform).all()
                      for o in outs))
        log(f"  serve_tts ({label}): {len(outs)} requests, encoder B={B} T={T} ({route}), frames "
            f"{lengths}, waveform samples {[len(o.waveform) for o in outs]}, {ms:.1f} ms for the "
            f"dispatch ({ms / max(lengths):.2f} ms a frame step, Griffin-Lim included) [{card}]")
        if not ok:
            raise SystemExit(f"serve_tts ({label}): an output is missing, malformed or not finite")
    if min(len(o.feature) for o in runs["full"][0]) != TTS_MAX_ITER:
        raise SystemExit("serve_tts: at threshold 1.0 a sample stopped before max_iter")
    per = cfg.encoder.layers if route == "dense" else 0
    expected = dict.fromkeys(KERNELS, 0)
    expected["dense_attention_fwd"] = 2 * per
    log(f"  serve_tts: launches {launches} (expected {expected}: B1 once per encoder layer a dispatch)")
    if device.type == "cuda" and (launches != expected or not per):
        raise SystemExit("serve_tts: B1 did not run once per encoder layer of each dispatch")

    gen = AutoRegressiveSpeechGenerator(model, max_iter=TTS_FRAME_STEPS, eos_prob_threshold=1.0)
    kernel, _, _ = gen.decode(sample, seed=SEED)
    saved = cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits
    cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = "xla", False, "fp32"
    try:
        plain, _, _ = gen.decode(sample, seed=SEED)
    finally:
        cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved
    rel = ((kernel - plain).norm() / plain.norm()).item()
    log(f"  serve_tts: the first {TTS_FRAME_STEPS} frames, kernels vs plain attention (fp32 scores, the "
        f"same prenet draws): relative Frobenius error {rel:.3e} (tol {TTS_REL_TOL})")
    if not rel <= TTS_REL_TOL:
        raise SystemExit("serve_tts: the frames under the kernels disagree with the plain attention path")
    return launches, dict(shape=(B, T), route=route, frames_rel=rel,
                          dispatch_ms={k: ms for k, (_, ms) in runs.items()},
                          lengths={k: [len(o.feature) for o in outs] for k, (outs, _) in runs.items()},
                          frames=np.stack([o.feature for o in runs["full"][0]]))


def _scst_batch(gp):
    """train_scst's caption batch (SCST_BATCH images at 224 px) and two
    seeded references an image."""
    spec = dict(template=CAPTION_TPL, batch=SCST_BATCH, image=IMAGE_SIZE, cap=(20, 24))
    batch = make_train_batches(gp, {"caption_scst": spec})["caption_scst"]
    rng = np.random.default_rng(SEED + 17)
    refs = [[_text(rng, 20, 24), _text(rng, 20, 24)] for _ in range(SCST_BATCH)]
    return batch, refs


def train_scst_and_check(model, gp, card):
    """train_scst: one scst_train_step (adamw at TRAIN_LR) on the caption
    batch: SCST_SAMPLES sampled captions a source (top-k SCST_TOPK, one
    dispatch each), CIDEr-D rewards, the policy gradient through one
    teacher-forced pass of the n * B samples; B1 in every sampling
    dispatch's encoder and in each attention call of the pass on the dense
    route, B2 in its backward. Then, on the same samples, the policy loss
    and gradients under the kernels against the plain attention path:
    ofasys_tpu's per-sample CIDEr-D is 0 for every sample (its one-document
    idf), so the check scores the samples with seeded advantages in [-0.5,
    0.5]. Returns the launches, results and the rows of B1 and B2 at the
    pass's shapes (and B2r's beside them)."""
    from ofasys_torch.configure.configs import OptimizationConfig
    from ofasys_torch.engine.criterion import ScstRewardCriterion, ScstRewardCriterionConfig, scst_train_step
    from ofasys_torch.engine.optim import build_optimizer
    from ofasys_torch.engine.train_step import TrainState
    from ofasys_torch.generator import SequenceGenerator
    from ofasys_torch.preprocessor.utils import collate_tokens

    cfg, device = model.cfg, model.net.device
    batch, refs = _scst_batch(gp)
    crit = ScstRewardCriterion(ScstRewardCriterionConfig(scst_n_samples=SCST_SAMPLES,
                                                         sampling_topk=SCST_TOPK),
                               pad_id=model.global_dict.pad())
    crit.setup(SequenceGenerator(model, model.global_dict, beam_size=1, sampling=True,
                                 sampling_topk=SCST_TOPK, max_len_b=MAX_LEN_B), gp.name2pre["text"])
    draws = {}
    sample_and_reward = crit.sample_and_reward

    def keep(*a, **k):
        draws["d"] = sample_and_reward(*a, **k)
        return draws["d"]

    crit.sample_and_reward = keep
    opt = build_optimizer(OptimizationConfig(lr=(TRAIN_LR,)))
    state = TrainState.create(model.net, opt)
    before = [p.detach().clone() for p in state.params]
    _sync(device)
    reset_counts()
    t0 = time.perf_counter()
    state, out = scst_train_step(crit, model, state, opt, batch, refs, seed=SEED)
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    crit.sample_and_reward = sample_and_reward
    tokens, rewards, advantage = draws["d"]
    moved = sum(not torch.equal(a, b) for a, b in zip(before, state.params))
    B, Ts = _encoder_tokens(batch["net_input"]["slots"])
    nB = SCST_SAMPLES * B
    Tt = collate_tokens(tokens, pad_idx=model.global_dict.pad(), pad_to_multiple=8).shape[1]
    log(f"  train_scst: {len(tokens)} samples of {min(map(len, tokens))}-{max(map(len, tokens))} tokens, "
        f"rewards mean {rewards.mean():.4f} (all zero: {not rewards.any()}), loss {out['loss']:.4e}, "
        f"{moved} of {len(before)} leaves moved (adamw's decay), step {step_ms:.1f} ms (sampling "
        f"included) [{card}]")
    if not (np.isfinite(out["loss"]) and np.isfinite(out["reward"]) and moved):
        raise SystemExit("train_scst: the update's loss or reward is not finite, or nothing moved")
    calls = [("scst_sample_encoder", (B, Ts, Ts), False, SCST_SAMPLES, False),
             ("scst_encoder", (nB, Ts, Ts), False, 1, True),
             ("scst_decoder_causal", (nB, Tt, Tt), True, 1, True),
             ("scst_cross", (nB, Tt, Ts), False, 1, True)]
    expected = dict.fromkeys(KERNELS, 0)
    for _, (b, tq, tk), _, times, backward in calls:
        route = _route(cfg, b, tq, tk)
        layers = cfg.encoder.layers
        if route != "plain":
            expected[f"{route}_attention_fwd"] += times * layers
            if backward:
                expected["dense_attention_bwd" if route == "dense" else "flash_attention_bwd"] += layers
    log(f"  train_scst: attention calls (label, (B, Tq, Tk), causal, passes) "
        f"{[(c[0], c[1], c[2], c[3]) for c in calls]}; launches {launches} (expected {expected})")
    if device.type == "cuda" and (launches != expected or not expected["dense_attention_fwd"]):
        raise SystemExit("train_scst: a kernel did not run once per attention call of its route")

    # the policy gradient on the same samples, kernels vs plain attention
    spread = np.random.default_rng(SEED + 18).uniform(-0.5, 0.5, advantage.shape).astype(np.float32)
    names = [n for n, _ in model.net.named_parameters()]

    def grads():
        loss, _ = crit.policy_gradient_loss(model, batch, tokens, spread)
        return loss.detach(), torch.autograd.grad(loss, list(model.net.parameters()), allow_unused=True)

    saved = cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits
    lk, gk = grads()
    cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = "xla", False, GRAD_REF_LOGITS
    try:
        lp, gp_ = grads()
    finally:
        cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved
    zero = [torch.zeros_like(p) for p in model.net.parameters()]
    gk = [z if g is None else g for g, z in zip(gk, zero)]
    gp_ = [z if g is None else g for g, z in zip(gp_, zero)]
    rel, norm_rel, leaves = _grad_diff(names, gk, gp_)
    worst = max(leaves, key=leaves.get)
    loss_rel = abs((lk - lp) / lp).item()
    log(f"  train_scst: policy loss {lk.item():.6e} vs plain {lp.item():.6e} (rel {loss_rel:.3e}); "
        f"gradients rel {rel:.3e} (tol {GRAD_REL_TOL}), global norm rel err {norm_rel:.3e}, worst leaves "
        f"{_top_leaves(leaves)} (tol {LEAF_REL_TOL})")
    if not (rel <= GRAD_REL_TOL and leaves[worst] <= LEAF_REL_TOL and loss_rel <= GRAD_REL_TOL):
        raise SystemExit("train_scst: the policy gradient under the kernels disagrees with the plain path")
    fwd, bwd, row = [], [], []
    for label, (b, tq, tk), causal, _, backward in calls:
        if device.type == "cuda" and _route(cfg, b, tq, tk) == "dense":
            fwd.append(check_fwd(label, (b, tq, tk, 12, 64), causal))
            if backward:
                b2, b2r = check_bwd(label, (b, tq, tk, 12, 64), causal)
                bwd.append(b2)
                row.append(b2r)
    return launches, dict(step_ms=step_ms, loss=out["loss"], reward=out["reward"], grad_rel=rel,
                          grad_worst_leaf=leaves[worst], grad_worst_leaf_name=worst,
                          policy_loss_rel=loss_rel, shapes=[c[1] for c in calls]), (fwd, bwd, row)


def _image_gen_prompts():
    rng = np.random.default_rng(SEED + 19)
    return [{"cap": _text(rng, *IMAGE_GEN_PROMPT)} for _ in range(N_IMAGE_GEN_PROMPTS)]


def serve_image_gen_and_check(model, card):
    """serve_image_gen: Task("image_gen") on the image-code model, 2
    prompts best-of-2 in one dispatch through ImageGenTask.inference: two
    sampling beams a prompt (the hub's IMAGE defaults: top-k 256, exactly
    1,024 codes), every candidate's image in one VQGAN pass, the rerank
    (skipped: no scorer and no CLIP weights, logged); every generated token
    a <code>, every image (256, 256, 3) in [0, 1]; B1 once per encoder
    layer where the dispatch's route is dense."""
    from ofasys_torch.configure.config_store import ConfigStore
    from ofasys_torch.preprocessor.instruction import Instruction

    d, device = model.global_dict, model.net.device
    n_symbols = len(d)
    task = ConfigStore().get("ofasys.task", "image_gen").target_cls()
    task.initialize(d)
    if len(d) != n_symbols:
        raise SystemExit("serve_image_gen: the task's preprocessors grew the model's dictionary")
    gp = task.general_preprocess.to(device)
    pre = gp.name2pre["image_vqgan"]
    n_codes = pre.tokenizer.codes_per_image
    g = task.cfg.generation
    g.max_len_b = g.min_len = n_codes
    g.sampling_topk, g.return_n_best = 256, IMAGE_GEN_BEST_OF
    sample = gp.collate([gp(Instruction(IMAGE_GEN_TPL, split="test").format(**r))
                         for r in _image_gen_prompts()])
    B, T = _encoder_tokens(sample["net_input"]["slots"])
    route = _route(model.cfg, B, T, T)
    _sync(device)
    reset_counts()
    t0 = time.perf_counter()
    outs = task.inference(model, None, sample)
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    t1 = time.perf_counter()
    pre.decode_batch([h.tokens for hyps in outs for h in hyps])
    _sync(device)
    vq_ms = (time.perf_counter() - t1) * 1e3
    ok = len(outs) == N_IMAGE_GEN_PROMPTS
    for hyps in outs:
        ok &= len(hyps) == IMAGE_GEN_BEST_OF
        for h in hyps:
            codes = h.tokens[:-1]
            ok &= (len(codes) == n_codes and h.tokens[-1] == d.eos()
                   and bool(((codes >= pre.code_start) & (codes < pre.code_end)).all())
                   and h.image.shape == (pre.cfg.code_image_size,) * 2 + (3,)
                   and bool(np.isfinite(h.image).all()) and h.image.min() >= 0 and h.image.max() <= 1)
    reranked = any("rerank_score" in (h.extra or {}) for hyps in outs for h in hyps)
    rerank = "applied" if reranked else \
        f"skipped (no scorer; rerank={pre.cfg.rerank!r}, no CLIP weights)"
    log(f"  serve_image_gen: {N_IMAGE_GEN_PROMPTS} prompts x best-of-{IMAGE_GEN_BEST_OF}, encoder B={B} "
        f"T={T} ({route}), {n_codes} codes + EOS a candidate, every token a <code> and every image "
        f"{(pre.cfg.code_image_size,) * 2 + (3,)} in [0, 1]: {ok}; rerank "
        f"{rerank}; "
        f"{wall_ms:.1f} ms for the dispatch ({wall_ms / (n_codes + 1):.2f} ms a decode step), the "
        f"{N_IMAGE_GEN_PROMPTS * IMAGE_GEN_BEST_OF} images' VQGAN decode alone {vq_ms:.1f} ms [{card}]")
    if not ok or reranked:
        raise SystemExit("serve_image_gen: a candidate is malformed, or a rerank ran without a scorer")
    per = model.cfg.encoder.layers if route == "dense" else 0
    expected = dict.fromkeys(KERNELS, 0)
    expected["dense_attention_fwd"] = per
    log(f"  serve_image_gen: launches {launches} (expected {expected})")
    if device.type == "cuda" and (launches != expected or not per):
        raise SystemExit("serve_image_gen: B1 did not run once per encoder layer of the dispatch")
    return launches, dict(shape=(B, T), route=route, wall_ms=wall_ms, vqgan_decode_ms=vq_ms,
                          step_ms=wall_ms / (n_codes + 1))


def infill_batches(gp, card, tasks=None):
    """train_image_infilling's batch, its targets encoded to codes by the
    preprocessor's VQGAN on its device, with the host and VQGAN time."""
    pre = gp.name2pre["image_vqgan"]
    size = pre.cfg.code_image_size
    imgs = np.stack(_images(np.random.default_rng(SEED), 8, size)) / 255.0
    pre.tokenizer.encode(imgs[:1])                         # warm-up
    t0 = time.perf_counter()
    pre.tokenizer.encode(imgs)
    vq_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batches = make_train_batches(gp, tasks or INFILL_TRAIN_TASKS)
    prep_s = time.perf_counter() - t0
    b = next(iter(batches.values()))
    codes = b["target"][b["target"] != gp.global_dict.pad()]
    inside = ((codes >= pre.code_start) & (codes < pre.code_end)) | (codes == gp.global_dict.eos())
    log(f"train_image_infilling batch: {b['nsentences']} samples preprocessed in {prep_s:.2f} s, the "
        f"VQGAN encoding 8 images of {size} px in {vq_ms:.1f} ms on {pre.tokenizer.device}; "
        f"targets {_task_shapes(b)[2]} tokens, every one a <code> or EOS: {bool(inside.all())} [{card}]")
    if not inside.all():
        raise SystemExit("train_image_infilling: a target token is not a <code>")
    return batches, vq_ms


# ----------------------------------------- video, STRUCT and PHONE paths, the heads
VIDEO_ADAPTORS = ("text", "image_vqgan", "video_image_sequence")
VIDEO_CAPTION_TPL = "[VIDEO:video] what does the video describe? -> [TEXT:cap]"
VIDEO_GEN_TPL = "[VIDEO:video] -> [IMAGE:frame,preprocess=image_vqgan,adaptor=image_vqgan]"
VIDEO_CLIP = (12, IMAGE_SIZE)     # frames a clip (sampled to the preprocessor's 8) and their side
N_VIDEO_REQUESTS = 8
VIDEO_TRAIN_TASKS = {"video_caption": dict(template=VIDEO_CAPTION_TPL, batch=8, video=VIDEO_CLIP,
                                           cap=(20, 40)),
                     "video_generation": dict(template=VIDEO_GEN_TPL, batch=4, video=VIDEO_CLIP)}
VIDEO_GRAD_BATCH = 2              # samples a task in the gradient check (plain attention at T ~ 1,600)
TINY_VIDEO_TRAIN_TASKS = {n: dict(spec, batch=2, video=(4, 128)) for n, spec in VIDEO_TRAIN_TASKS.items()}
SPIDER_TPL = ('" [TEXT:question] " ; structured knowledge: '
              '" [STRUCT:database,preprocess=database] " -> [TEXT:query]')
SUDOKU_TPL = '" [STRUCT:puzzle,preprocess=struct] " solve the sudoku. -> [STRUCT:solution,preprocess=struct]'
DART_TPL = 'what is the description of table " [STRUCT:table,preprocess=struct] "? -> [TEXT:text]'
N_SPIDER_ROWS = 16
SPIDER_MAX_LEN = 48
STRUCT_TRAIN_TASKS = {"sudoku": dict(template=SUDOKU_TPL, batch=32),
                      "dart": dict(template=DART_TPL, batch=32, text=(40, 80)),
                      "spider": dict(template=SPIDER_TPL, batch=32)}
TINY_STRUCT_TRAIN_TASKS = {n: dict(spec, batch=2) for n, spec in STRUCT_TRAIN_TASKS.items()}
CTC_WEIGHT = 0.5
ASR_CTC_TPL = "[AUDIO:wav] what is the transcription? -> [TEXT:text,preprocess=text_phone]"
PHONE_TPL = "[PHONE:phone,preprocess=phone] -> [TEXT:text]"
ASR_CTC_TASKS = {"asr_ctc": dict(template=ASR_CTC_TPL, batch=32, text=(20, 40), audio=ASR_SECONDS,
                                 criterion="speech_to_text_ctc")}
TINY_ASR_CTC_TASKS = {"asr_ctc": dict(ASR_CTC_TASKS["asr_ctc"], batch=2, audio=(0.3, 0.5))}
N_PHONE_REQUESTS = 8
HIFIGAN_RATE = 22050              # HiFi-GAN V1's sample rate: 256 samples a frame
HEADS_CPU_ROWS = 2                # vocoded on the CPU too
# the vocoder on the card against the same module on the CPU, both fp32
# (TF32 off): relative Frobenius error of the waveforms
HIFIGAN_REL_TOL = 1e-4
# the pooling head (fp32) on the card against the CPU, on the same encoder output
POOL_ATOL = 1e-4
COWS = ["bessie", "daisy", "mabel", "clover", "buttercup", "rosie", "molly", "penny", "hazel",
        "ginger", "lulu", "maple"]
BREEDS = ["holstein", "jersey", "angus", "hereford", "guernsey"]
SPIDER_QUERIES = [
    ("what is the breed of {name}?", "select breed from cows where name = '{name}'"),
    ("how many cows are older than {n}?", "select count(*) from cows where age > {n}"),
    ("list the names of {breed} cows", "select name from cows where breed = '{breed}'"),
    ("which barn holds {name}?",
     "select t2.id from cows as t1 join barns as t2 on t1.id = t2.cow_id where t1.name = '{name}'"),
    ("how many liters did {name} give?",
     "select sum(t2.liters) from cows as t1 join milk as t2 on t1.id = t2.cow_id where t1.name = '{name}'"),
    ("what is the average age of the cows of each breed?", "select breed, avg(age) from cows group by breed"),
    ("list the cows from the oldest", "select name from cows order by age desc"),
    ("how many barns are large?", "select count(*) from barns where size = 'large'"),
]
# serve_spider's second database: the farm's tables and a cooperative's, so
# that its schema prompt (truncated at the text preprocessor's 256 source
# tokens, as a Spider database with many tables is) takes B3
SPIDER_WIDE_DB = "dairy_cooperative"
SPIDER_WIDE_TABLES = {
    "farmers": ["farmer_id", "first_name", "last_name", "age", "home_county", "years_of_experience",
                "phone_number"],
    "feed_suppliers": ["supplier_id", "company_name", "contact_name", "city", "delivery_day",
                       "price_per_ton"],
    "feed_deliveries": ["delivery_id", "supplier_id", "barn_id", "delivery_date", "tons_delivered",
                        "feed_type"],
    "veterinarians": ["vet_id", "full_name", "clinic_name", "license_year", "specialty"],
    "health_checks": ["check_id", "cow_id", "vet_id", "check_date", "weight_kg", "temperature",
                      "diagnosis"],
    "milk_buyers": ["buyer_id", "buyer_name", "city", "contract_start_year", "price_per_liter"],
    "milk_sales": ["sale_id", "buyer_id", "sale_date", "liters_sold", "total_price"],
    "equipment": ["equipment_id", "equipment_name", "barn_id", "purchase_year", "maintenance_cost"],
}


def _clip(rng, n, size):
    """``n`` uint8-valued float32 (size, size, 3) frames."""
    return rng.integers(0, 256, (n, size, size, 3)).astype(np.float32)


def video_batches(gp, tasks=None):
    """One collated batch per video task from seeded clips through the task
    zoo's ``preprocess`` hook (video_generation: the condition frame, picked
    by the first frame's hash, becomes the target and the frames from it on
    are zeroed) -> Instruction -> GeneralPreprocess -> collate; captions of
    seeded words. A generation target is encoded to VQGAN codes on the
    preprocessor's device."""
    import ofasys_torch.task  # noqa: F401  (registers the task zoo)
    from ofasys_torch.configure.config_store import ConfigStore
    from ofasys_torch.preprocessor.instruction import Instruction

    rng = np.random.default_rng(SEED + 23)
    out = {}
    for name, spec in (tasks or VIDEO_TRAIN_TASKS).items():
        task = ConfigStore().get("ofasys.task", name).target_cls()
        recs = []
        for _ in range(spec["batch"]):
            r = {"video": _clip(rng, *spec["video"])}
            if "cap" in spec:
                r["cap"] = _text(rng, *spec["cap"])
            recs.append(task.preprocess(r, "train"))
        out[name] = gp.collate([gp(Instruction(spec["template"], split="train").format(**r))
                                for r in recs])
    return out


def _video_requests():
    """serve_video: 8 clips with the hub's TEXT defaults (beam 5)."""
    rng = np.random.default_rng(SEED + 29)
    return [({"video": _clip(rng, *VIDEO_CLIP)}, {"max_len_b": MAX_LEN_B}) for _ in range(N_VIDEO_REQUESTS)]


def serve_video_and_check(model, gp, card, serve_res=None):
    """serve_video: 8 video_caption requests (12 frames of 224 px, sampled
    to 8) through the server with beam 5 (serve_and_check: launches, served
    against direct, the encoder output against plain attention); B3 a
    dispatch as attention_route gives it for the encoder's (B, T); the
    tokens against the same hub on the plain attention path (near-ties
    within CLOSED_TIE_TOL, at a step's selection or at the pick among the
    finished hypotheses); the video preprocessor's host ms a request."""
    from ofasys_torch import OFASys
    from ofasys_torch.preprocessor.instruction import Instruction

    hub = OFASys(model, None, model.global_dict, gp, device=model.net.device)
    reqs = _video_requests()
    host_ms = []
    for r, _ in reqs:
        t0 = time.perf_counter()
        gp(Instruction(VIDEO_CAPTION_TPL, split="test").format(**r))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    n_frames = gp.name2pre["video"].cfg.num_frames
    log(f"  serve_video: the video preprocessor's host ms a request ({VIDEO_CLIP[0]} frames of "
        f"{VIDEO_CLIP[1]} px sampled to {n_frames}): {[round(x, 2) for x in host_ms]} [host CPU]")
    res = serve_and_check(hub, card, VIDEO_CAPTION_TPL, reqs, "serve_video")
    per = [(B, T, route, model.cfg.encoder.layers if route == "flash" else 0) for B, T, route in res["shapes"]]
    log(f"  serve_video: B3 a dispatch by attention_route (B, T, route, launches): {per}; counted "
        f"{res['launches']['flash_attention_fwd']}")
    if model.net.device.type == "cuda" and any(route != "flash" for _, _, route, _ in per):
        raise SystemExit("serve_video: the video encoder did not take the flash route")
    _tokens_vs_plain(hub, res["calls"], "serve_video", CLOSED_TIE_TOL, unconstrained=True)
    if serve_res is not None:
        log(f"  serve_video vs serve: p50 {res['p50_ms']} vs {serve_res['p50_ms']} ms [{card}]")
    return res["launches"], dict(p50_ms=res["p50_ms"], tokens_per_s=res["tokens_per_s"],
                                 preprocess_ms=host_ms, shapes=res["shapes"])


def rel_bias_grad_check(spec, card, label):
    """The relative tables' gradient at a layout (``spec``, a BiasSpec):
    BiasSpec's gather with its planned backward against autograd's own
    backward of the plain gather ``tables[:, bucket]``, under one seeded
    upstream gradient, within GATHER_GRAD_RTOL (the zero row, a constant,
    left out); on the card each backward's time."""
    from ofasys_torch.model.transformer import BiasSpec

    tables = spec.tables.detach().float().requires_grad_()
    n, H = tables.shape[0], tables.shape[2]
    T = spec.bucket.shape[0]
    g = torch.randn((n, H, T, T), generator=torch.Generator(tables.device).manual_seed(SEED),
                    device=tables.device)

    def planned():
        bias = BiasSpec(rel_bucket=spec.rel_bucket, tables=tables).stacked()
        return torch.autograd.grad(bias, tables, g)[0]

    def plain():
        bias = tables[:, spec.rel_bucket.index].permute(0, 3, 1, 2)
        return torch.autograd.grad(bias, tables, g)[0]

    got, want = planned(), plain()
    err = float((got[:, 1:] - want[:, 1:]).abs().max() / want[:, 1:].abs().max())
    out = dict(shape=(n, H, T, T), rel_err=err)
    if tables.device.type == "cuda":
        out.update(ms=time_ms(planned, n=3, repeats=3), plain_ms=time_ms(plain, n=3, repeats=3))
    log(f"  {label}: the relative tables' gradient (n_tables, H, T, T) = {out['shape']}, the planned "
        f"backward against the plain gather's: largest error / largest entry {err:.3g} (tol "
        f"{GATHER_GRAD_RTOL})" + (f"; forward + backward {out['ms']:.3f} ms vs the plain gather's "
                                  f"{out['plain_ms']:.3f} ms [{card}]" if "ms" in out else ""))
    if not err <= GATHER_GRAD_RTOL or bool((got[:, 0] != 0).any()):
        raise SystemExit(f"{label}: the relative tables' gradient disagrees with the plain gather's")
    return out


def train_video_and_check(model, gp, card, batches, grad_batches):
    """train_video: 5 summed video_caption (B=8) + video_generation (B=4,
    1,025 VQGAN codes) updates (train_and_check: B3 and the flash backward
    by route, a falling loss, gradients against the plain attention path on
    VIDEO_GRAD_BATCH samples a task); the encoder's bias shape (batch-shared:
    the backward's bias gradient is B5's batch sum), the backward's launch
    plan at the caption encoder, the relative tables' gradient against the
    plain gather's (rel_bias_grad_check), the peak memory; one update
    profiled."""
    from ofasys_torch.ops.flash_attention import backward_plan
    from ofasys_torch.utils.pytree import slots_to_device

    device, cfg = model.net.device, model.cfg
    src = [s for s in batches["video_caption"]["net_input"]["slots"] if s.is_src]
    with torch.no_grad():
        spec = model.net.encoder_adaptor(slots_to_device(src, device)).bias_spec
        bias = spec.layer_bias(0)
    gather = rel_bias_grad_check(spec, card, "train_video")
    del spec
    B, Ts, _ = _task_shapes(batches["video_caption"])
    H = cfg.encoder.attention_heads
    plan = backward_plan(B, H, Ts, Ts, cfg.encoder.embed_dim // H, bias.shape[0] == 1)
    log(f"  train_video: the encoder's attention bias {tuple(bias.shape)} "
        f"({'shared by the batch: B5 sums its gradient' if bias.shape[0] == 1 else 'per sample: ds'}); "
        f"the flash backward's plan at the caption encoder (B={B}, T={Ts}): {plan}")
    del bias
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches, res, (step, state, dev) = train_and_check(model, gp, card, tasks=VIDEO_TRAIN_TASKS,
                                                        batches=batches, label="train_video",
                                                        grad_batches=grad_batches)
    if device.type == "cuda":
        res["profile"] = phase_profile_train(step, state, dev, card,
                                             "one video update (video_caption B=8 + video_generation B=4)")
    del step, state, dev
    per = _expected_train_launches(batches, cfg)
    log(f"  train_video: per update B3 {per['flash_attention_fwd']}, the flash backward "
        f"{per['flash_attention_bwd']}, B1 {per['dense_attention_fwd']}, B2 {per['dense_attention_bwd']}")
    if device.type == "cuda":
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        log(f"  train_video: peak device memory {res['peak_memory_gib']:.3f} GiB (updates and gradient "
            f"checks) [{card}]")
        if not per["flash_attention_fwd"] or not per["flash_attention_bwd"]:
            raise SystemExit("train_video: the video paths did not take the flash route")
    res["backward_plan"] = str(plan)
    res["rel_bias_grad"] = gather
    return launches, res


def spider_db(root, db_id="farm", seed=SEED):
    """``{root}/{db_id}/{db_id}.sqlite`` from ``seed``: cows (id, name,
    breed, age), barns (id, cow_id, size), milk (cow_id, day, liters); for
    SPIDER_WIDE_DB also the SPIDER_WIDE_TABLES, 6 rows each of seeded words
    and numbers."""
    import sqlite3

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, db_id), exist_ok=True)
    path = os.path.join(root, db_id, f"{db_id}.sqlite")
    if os.path.exists(path):                   # built from the same seed already
        return path
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE cows (id INTEGER, name TEXT, breed TEXT, age REAL)")
    conn.execute("CREATE TABLE barns (id INTEGER, cow_id INTEGER, size TEXT)")
    conn.execute("CREATE TABLE milk (cow_id INTEGER, day INTEGER, liters REAL)")
    conn.executemany("INSERT INTO cows VALUES (?, ?, ?, ?)",
                     [(i, c, BREEDS[int(rng.integers(len(BREEDS)))], round(float(rng.uniform(1, 12)), 1))
                      for i, c in enumerate(COWS)])
    conn.executemany("INSERT INTO barns VALUES (?, ?, ?)",
                     [(i, i % len(COWS), ["small", "large"][int(rng.integers(2))]) for i in range(len(COWS))])
    conn.executemany("INSERT INTO milk VALUES (?, ?, ?)",
                     [(int(rng.integers(len(COWS))), d, round(float(rng.uniform(5, 30)), 2)) for d in range(40)])
    for table, cols in (SPIDER_WIDE_TABLES.items() if db_id == SPIDER_WIDE_DB else ()):
        conn.execute(f"CREATE TABLE {table} ({', '.join(cols)})")
        conn.executemany(f"INSERT INTO {table} VALUES ({', '.join('?' * len(cols))})",
                         [tuple(int(rng.integers(100)) if c.endswith(("_id", "year", "age")) else
                                (COWS + BREEDS)[int(rng.integers(len(COWS) + len(BREEDS)))] for c in cols) for _ in range(6)])
    conn.commit()
    conn.close()
    return path


def spider_records(rng, n, db_id="farm"):
    """``n`` Spider rows on the database ``db_id``: a question that names
    cells to link (``name ( bessie )``) and its gold query."""
    out = []
    for i in range(n):
        q, sql = SPIDER_QUERIES[i % len(SPIDER_QUERIES)]
        kw = dict(name=COWS[int(rng.integers(len(COWS)))], breed=BREEDS[int(rng.integers(len(BREEDS)))],
                  n=int(rng.integers(2, 9)))
        out.append({"question": q.format(**kw), "db_id": db_id, "query": sql.format(**kw)})
    return out


def _spider_task(root):
    import ofasys_torch.task  # noqa: F401  (registers the task zoo)
    from ofasys_torch.configure.config_store import ConfigStore

    task = ConfigStore().get("ofasys.task", "spider").target_cls()
    task.cfg.database_path = root
    return task


def _spider_records():
    """serve_spider's records: half on the farm database, half on
    SPIDER_WIDE_DB."""
    rng = np.random.default_rng(SEED + 31)
    half = N_SPIDER_ROWS // 2
    return spider_records(rng, half) + spider_records(rng, N_SPIDER_ROWS - half, SPIDER_WIDE_DB)


def _spider_rows(root):
    """serve_spider's rows on its two databases (built in ``root``), as
    SpiderTask.preprocess gives them to the preprocessors."""
    spider_db(root)
    spider_db(root, SPIDER_WIDE_DB)
    task = _spider_task(root)
    return [task.preprocess(r, "valid") for r in _spider_records()]


def serve_spider_and_check(model, card, root):
    """serve_spider: Task("spider").evaluate over N_SPIDER_ROWS rows on two
    seeded databases (the schema read from the sqlite file, the question's
    cell values linked into it): exact_match, sql_match_acc and
    sql_exec_acc, rows/s; the encoder's route by the schema prompt's length
    (the farm's batch B1, the wide database's B3), its kernel once per
    encoder layer of each batch; sql_exec_acc and
    sql_match_acc recomputed on the host from the hypotheses and references
    the evaluation wrote, and sql_exec_acc of the references against
    themselves 1 (every gold query runs on the database)."""
    from ofasys_torch.metric.base import MetricConfig
    from ofasys_torch.metric.metrics import SqlExecAccMetric, SqlExecMetricConfig, SqlMatchAccMetric

    d, device = model.global_dict, model.net.device
    rows = _spider_rows(root)
    task = _spider_task(root)
    task.cfg.dataset.batch_size = 8
    task.cfg.generation.max_len_b = SPIDER_MAX_LEN
    task.cfg.evaluation.output_dir = os.path.join(root, "eval")
    n_symbols = len(d)
    task.initialize(d)
    if len(d) != n_symbols:
        raise SystemExit("serve_spider: the task's preprocessors grew the model's dictionary")
    recs = _spider_records()
    task.add_dataset(recs, "valid")
    gp = task.general_preprocess
    shapes = [_encoder_shape(gp, rows[i:i + 8], SPIDER_TPL) for i in range(0, len(rows), 8)]
    routes = [(B, T, _route(model.cfg, B, T, T)) for B, T in shapes]
    expected = dict.fromkeys(KERNELS, 0)
    for *_, route in routes:
        if route != "plain":
            expected[f"{route}_attention_fwd"] += model.cfg.encoder.layers
    _sync(device)
    reset_counts()
    t0 = time.perf_counter()
    results = task.evaluate(model, None, split="valid")
    _sync(device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    with open(os.path.join(root, "eval", "spider_valid.json")) as f:
        written = json.load(f)
    hyps, refs = written["hyps"], written["refs"]
    exec_m = SqlExecAccMetric(SqlExecMetricConfig(database_path=root))
    host = {**exec_m.compute(hyps, refs), **SqlMatchAccMetric(MetricConfig()).compute(hyps, refs)}
    gold = exec_m.compute(refs, refs)["sql_exec_acc"]
    lin = gp.name2pre["database"].linearize(rows[0]["database"])
    log(f"  serve_spider: {len(recs)} rows in {wall:.2f} s = {len(recs) / wall:.1f} rows/s; "
        f"exact_match {results['exact_match']}, sql_match_acc {results['sql_match_acc']}, "
        f"sql_exec_acc {results['sql_exec_acc']} (host recompute {host}; the references against "
        f"themselves {gold}) [{card}]")
    log(f"  serve_spider: the schema prompt of row 0 {lin!r}; encoder batches (B, T, route) {routes}; "
        f"launches {launches} (expected {expected}); a hypothesis {hyps[0][:60]!r}")
    if not (host["sql_exec_acc"] == results["sql_exec_acc"]
            and host["sql_match_acc"] == results["sql_match_acc"] and gold == 1.0
            and " ( " in lin):
        raise SystemExit("serve_spider: the SQL metrics disagree with the host, a gold query failed, "
                         "or no cell value was linked")
    if device.type == "cuda" and (launches != expected or not expected["dense_attention_fwd"]
                                  or not expected["flash_attention_fwd"]):
        raise SystemExit("serve_spider: the encoder's kernel did not run once per layer of each batch, "
                         "or no batch took B1 or none B3")
    return launches, dict(rows_per_s=len(recs) / wall, routes=routes,
                          **{k: results[k] for k in ("exact_match", "sql_match_acc", "sql_exec_acc")})


def _sudoku(rng):
    """A solved 9 x 9 grid (a shifted pattern under a seeded digit
    permutation) and its puzzle with about half the cells 0, each as rows
    of space-separated digits joined by ' | '."""
    perm = rng.permutation(9) + 1
    grid = np.asarray([[perm[(3 * (r % 3) + r // 3 + c) % 9] for c in range(9)] for r in range(9)])
    puzzle = np.where(rng.random((9, 9)) < 0.5, 0, grid)

    def lin(g):
        return " | ".join(" ".join(map(str, row)) for row in g)

    return lin(puzzle), lin(grid)


def struct_batches(gp, root, tasks=None):
    """One collated batch per STRUCT task: sudoku grids, dart tables of 3-5
    (subject, predicate, object) triples with seeded descriptions, Spider
    rows through SpiderTask.preprocess on the farm database (schema and
    linked cell values)."""
    from ofasys_torch.preprocessor.instruction import Instruction

    spider_db(root)
    spider = _spider_task(root)
    rng = np.random.default_rng(SEED + 37)
    out = {}
    for name, spec in (tasks or STRUCT_TRAIN_TASKS).items():
        recs = []
        for _ in range(spec["batch"]):
            if name == "sudoku":
                puzzle, solution = _sudoku(rng)
                recs.append({"puzzle": puzzle, "solution": solution})
            elif name == "dart":
                cow = COWS[int(rng.integers(len(COWS)))]
                triples = [[cow, p, v] for p, v in (("breed", BREEDS[int(rng.integers(len(BREEDS)))]),
                                                    ("age", int(rng.integers(1, 12))),
                                                    ("barn", int(rng.integers(12))),
                                                    ("milk", f"{rng.uniform(5, 30):.1f} liters"))
                           ][:int(rng.integers(3, 5))]
                recs.append({"table": triples, "text": _text(rng, *spec["text"])})
            else:
                recs.append(spider.preprocess(spider_records(rng, 1)[0], "train"))
        out[name] = gp.collate([gp(Instruction(spec["template"], split="train").format(**r))
                                for r in recs])
    return out


def ctc_preprocess():
    """The CTC model's dictionary and preprocessors: the byte symbols and
    <mask> (text), the 41 + 2 <phone> rows (text_phone, phone), then
    <text>_256 .. 49,999, padded to a multiple of 128."""
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text", "audio", "text_phone", "phone"])
    for i in range(256, 50000):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(128)
    return d, gp


def train_asr_ctc_and_check(model, gp, card, tasks=None, batches=None):
    """train_asr_ctc: 5 updates of speech_to_text with text_phone targets
    under speech_to_text_loss at ctc_weight CTC_WEIGHT (train_and_check:
    B1/B2 by route, a falling loss, gradients against the plain attention
    path), and ce_loss and ctc_loss each finite and falling."""
    tasks = tasks or ASR_CTC_TASKS
    batches = batches or make_train_batches(gp, tasks)
    b = next(iter(batches.values()))
    et = b["encoder_target"]
    n_phones = (et != model.global_dict.pad()).sum(1) - 1
    log(f"  train_asr_ctc: phone targets {et.shape}, {int(n_phones.min())}-{int(n_phones.max())} phones "
        f"a sample (hermetic g2p), encoder T {_task_shapes(b)[1]}")
    launches, res, _ = train_and_check(model, gp, card, tasks=tasks, batches=batches, label="train_asr_ctc")
    logs = next(iter(res["task_logs"].values()))
    log(f"  train_asr_ctc: ce_loss {[round(x, 4) for x in logs['ce_loss']]}, ctc_loss "
        f"{[round(x, 4) for x in logs['ctc_loss']]}")
    for key in ("ce_loss", "ctc_loss"):
        v = logs[key]
        if not (all(np.isfinite(v)) and v[-1] < v[0]):
            raise SystemExit(f"train_asr_ctc: {key} is not finite or did not fall")
    return launches, res


def serve_phone_and_check(model, gp, card):
    """phone_to_text once: 8 requests of seeded words' phones (hermetic
    g2p) in one dispatch through the hub (beam 5): every answer finite and
    non-empty; B1 (or B3) once per encoder layer as the route gives it."""
    from ofasys_torch import OFASys

    hub = OFASys(model, None, model.global_dict, gp, device=model.net.device)
    rng = np.random.default_rng(SEED + 41)
    t2p = gp.name2pre["text_phone"]
    data = [{"phone": " ".join(t2p.text_to_phones(_text(rng, 20, 40)))} for _ in range(N_PHONE_REQUESTS)]
    B, T = _encoder_shape(gp, data, PHONE_TPL)
    route = _route(model.cfg, B, T, T)
    expected = dict.fromkeys(KERNELS, 0)
    if route != "plain":
        expected[f"{route}_attention_fwd"] = model.cfg.encoder.layers
    _sync(hub.device)
    reset_counts()
    t0 = time.perf_counter()
    outs = hub.inference(PHONE_TPL, data, max_len_b=MAX_LEN_B)
    _sync(hub.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    ok = len(outs) == len(data) and all(np.isfinite(_best(o).score) and _best(o).tokens.size > 0 for o in outs)
    log(f"  serve_phone: {len(data)} phone_to_text requests, encoder B={B} T={T} ({route}), {wall_ms:.1f} ms, "
        f"launches {launches} (expected {expected}); an answer {_best(outs[0]).text[:40]!r} [{card}]")
    if not ok:
        raise SystemExit("serve_phone: an answer is empty or not finite")
    if model.net.device.type == "cuda" and launches != expected:
        raise SystemExit("serve_phone: the encoder's kernel did not run once per layer")
    return launches, dict(wall_ms=wall_ms, shape=(B, T), route=route)


def serve_encoder_output(hub):
    """The encoder output (fp32, on the CPU) and padding mask of serve's
    first dispatch of 8, for the pooling head."""
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.utils.pytree import slots_to_device

    gp = hub.general_preprocess
    sample = gp.collate([gp(Instruction(TPL, split="test").format(**r)) for r, _ in _serve_requests()[:8]])
    src = slots_to_device([s for s in sample["net_input"]["slots"] if s.is_src], hub.device)
    with torch.no_grad():
        enc = hub.model.net.encode(src)
    return enc.x.float().cpu(), enc.padding_mask.cpu()


def heads_and_check(frames, enc, card, device="cuda"):
    """heads: HiFi-GAN V1 (HifiGanVocoder, random weights from SEED, fp32)
    over serve_tts's frames on the card, with its ms a second of audio, and
    the first HEADS_CPU_ROWS against the same module on the CPU
    (HIFIGAN_REL_TOL); the pooling head (fp32, seeded weights) in each mode
    over serve's encoder output on the card against the CPU (POOL_ATOL)."""
    import copy

    from ofasys_torch.model.hifigan import HifiGanVocoder
    from ofasys_torch.model.pooling import OFAPoolingModel, PoolingDecoderConfig

    voc = HifiGanVocoder(seed=SEED, device=device)
    ref = HifiGanVocoder(seed=SEED, device="cpu")
    mel = np.asarray(frames, np.float32)
    voc(mel[:1, :16])                                      # warm-up (cuDNN's algorithm choice)
    _sync(voc.device)
    t0 = time.perf_counter()
    wav = voc(mel)
    _sync(voc.device)
    ms = (time.perf_counter() - t0) * 1e3
    seconds = wav.size / HIFIGAN_RATE
    want = ref(mel[:HEADS_CPU_ROWS])
    rel = float(np.linalg.norm(wav[:HEADS_CPU_ROWS] - want) / np.linalg.norm(want))
    log(f"  heads: HiFi-GAN V1 over serve_tts's frames {mel.shape}: waveforms {wav.shape}, {ms:.1f} ms for "
        f"{seconds:.2f} s of audio at {HIFIGAN_RATE} Hz = {ms / seconds:.2f} ms a second of audio; the first "
        f"{HEADS_CPU_ROWS} against the CPU: rel {rel:.3e} (tol {HIFIGAN_REL_TOL}) [{card}]")
    if not (np.isfinite(wav).all() and rel <= HIFIGAN_REL_TOL and np.linalg.norm(want) > 0):
        raise SystemExit("heads: HiFi-GAN on the card disagrees with the CPU")
    x, mask = enc
    pool = {}
    g = torch.Generator().manual_seed(SEED)
    for mode in ("mean", "max", "first"):
        head = OFAPoolingModel(PoolingDecoderConfig(num_classes=3, pooling=mode), x.shape[-1], torch.float32)
        with torch.no_grad():
            for p in head.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            cpu = head(x, mask)
            on = copy.deepcopy(head).to(device)(x.to(device), mask.to(device)).cpu()
        err = (on - cpu).abs().max().item()
        pool[mode] = err
        if not (torch.isfinite(on).all() and err <= POOL_ATOL):
            raise SystemExit(f"heads: the pooling head ({mode}) on the card disagrees with the CPU")
    log(f"  heads: the pooling head over serve's encoder output {tuple(x.shape)}, card vs CPU max abs "
        f"error by mode {pool} (tol {POOL_ATOL})")
    return dict(vocoder_ms=ms, audio_s=seconds, ms_per_audio_s=ms / seconds, vocoder_rel=rel, pooling_err=pool)


def _kernel_entry(name, launches, main_path, rows, err_key, nominal, card, **extra):
    """One kernel's entry of the ``{"kernels": [...]}`` line: ``launches`` by
    path (the counts of each path's run), the error over every checked
    shape, and the times at the ``nominal`` shape."""
    replaces, source = KERNELS[name]
    row = next(r for r in rows if r["shape"] == nominal)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[main_path],
        "launches_by_path": {p: c for p, c in launches.items() if c},
        "max_abs_err": max(r[err_key] for r in rows),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "nominal_shape": nominal,
        "card": card,
        "shapes": rows,
        **extra,
    }


# ------------------------------------------------------------- parallelism
# remat modes of train_remat; its gradients are held to the run-to-run
# difference of remat='none' itself (0 where the kernels are deterministic)
# and at most REMAT_GRAD_REL_TOL
REMAT_MODES = ("none", "full", "dots")
REMAT_GRAD_REL_TOL = 1e-6
# the MoE slice: 8 experts in every second layer at the base width
MOE = {"moe_experts": 8, "moe_every_n": 2}
N_MOE_UPDATES = 5
# parallel_world: two ranks on the one card over gloo (NCCL refuses two
# ranks on one device); its training updates run the base width at this
# depth (the serving check runs the base hub whole)
WORLD = 2
WORLD_LAYERS = 2
WORLD_THREADS = 4
# OFASys.shard against one-rank serving: the row-parallel out_proj and fc2
# round each half's bf16 GEMM and sum the halves in fp32, where one GEMM
# rounds its own fp32 sum once, and the q/k/v and fc1 halves run other GEMM
# shapes: bf16 roundings differ,
# and a beam selection kept by less than that margin can go either way, as
# between B1 and the plain path (CLOSED_TIE_TOL)
SHARD_TIE_TOL = CLOSED_TIE_TOL
# the updates of parallel_world: (label, ParallelConfig fields, model config,
# which batches). Each rank's gradients of one update (dropout 0) are held
# against the one-process update's at GRAD_REL_TOL / LEAF_REL_TOL. The MoE
# update routes without dropping a token on either side (capacity 8 x the
# even share; the sharded capacity is per rank) and leaves the aux term out
# (it averages per-rank routing statistics).
WORLD_UPDATES = [
    ("data", dict(data=2), {}, "train"),
    ("fsdp", dict(data=1, fsdp=2), {}, "train"),
    ("tensor", dict(data=1, tensor=2), {}, "train"),
    ("sequence", dict(data=1, sequence=2), {"sequence_parallel": True}, "long"),
    ("expert", dict(data=1, expert=2), dict(MOE, moe_capacity_factor=8.0, moe_aux_weight=0.0), "train"),
    ("pipeline", dict(data=1, pipeline=2), {"pipeline_stages": 2, "scan_layers": True}, "train"),
]


def _updates(model, batches, n_updates, label, card):
    """``n_updates`` summed multi-task updates (Adam at TRAIN_LR) on device
    batches; returns (launches, losses, per-task logs, step ms, peak GiB)."""
    from ofasys_torch.configure.configs import OptimizationConfig
    from ofasys_torch.engine.optim import build_optimizer
    from ofasys_torch.engine.train_step import TrainState, make_multitask_train_step
    from ofasys_torch.utils.pytree import sample_to_device

    dev = {n: sample_to_device(b, "cuda") for n, b in batches.items()}
    crit = make_criteria(batches, model.global_dict.pad())
    opt = build_optimizer(OptimizationConfig(lr=(TRAIN_LR,)))
    state = TrainState.create(model.net, opt)
    step = make_multitask_train_step(model, crit, opt)
    state, _ = step(state, dev, SEED)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, times = [], []
    for _ in range(n_updates):
        t0 = time.perf_counter()
        state, out = step(state, dev, SEED)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = read_counts()
    losses = [sum(float(t["loss"]) for t in o["tasks"].values())
              / sum(float(t["sample_size"]) for t in o["tasks"].values()) for o in outs]
    logs = {n: {k: [round(float(o["tasks"][n][k]), 4) for o in outs] for k in ("loss", "moe_aux")
                if k in outs[0]["tasks"][n]} for n in dev}
    return (launches, losses, logs, statistics.median(times) * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def train_remat_and_check(d, card, batches, long_batches):
    """train_remat: one update's gradients of the base two-task update
    (dropout 0.1, one step generator) under remat 'none', 'full' and
    'dots': equal within the run-to-run difference of 'none'; the peak
    memory and the time of a gradient step for each mode, and the launches
    the recompute implies (every attention forward twice, B1 or B3, its
    backward once). Then one train_long gradient step under 'full', B3 and
    the flash backward recomputed."""
    from ofasys_torch.utils.pytree import sample_to_device

    model = build_train_model(d, "cuda", adaptors=("text",))
    names = [n for n, _ in model.net.named_parameters()]
    params = list(model.net.parameters())
    res = {}
    counts = {}
    for label, bs in (("train_remat", batches), ("train_remat_long", long_batches)):
        dev = {n: sample_to_device(b, "cuda") for n, b in bs.items()}
        crit = make_criteria(bs, d.pad())
        per_update = _expected_train_launches(bs, model.cfg, model.net)
        modes = REMAT_MODES if label == "train_remat" else ("none", "full")
        grads = {}
        for mode in modes:
            model.cfg.remat = mode
            grads[mode] = _grads(model, crit, params, 0, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            again = _grads(model, crit, params, 0, dev)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            expected = dict(per_update)
            if mode != "none":
                for k in ("dense_attention_fwd", "flash_attention_fwd"):
                    expected[k] *= 2
            noise = _grad_diff(names, again, grads[mode])[0]
            rel, norm_rel, leaves = _grad_diff(names, grads[mode], grads["none"])
            worst = max(leaves, key=leaves.get)
            log(f"  {label} remat={mode!r}: gradient step {ms:.1f} ms, peak device memory {peak:.3f} GiB, "
                f"launches {({k: v for k, v in launches.items() if v})} (expected "
                f"{({k: v for k, v in expected.items() if v})}); gradients vs 'none' rel {rel:.3e} "
                f"(worst leaf {worst} {leaves[worst]:.3e}), run-to-run {noise:.3e} [{card}]")
            res[f"{label}_{mode}"] = dict(grad_step_ms=ms, peak_gib=peak, grad_rel=rel, run_to_run=noise)
            counts[f"{label}_{mode}"] = launches
            if launches != expected:
                raise SystemExit(f"{label} remat={mode!r}: the recompute did not launch the kernels "
                                 "as expected")
            if mode != "none" and not rel <= max(2 * res[f"{label}_none"]["run_to_run"], REMAT_GRAD_REL_TOL):
                raise SystemExit(f"{label} remat={mode!r}: gradients differ from remat='none'")
            del again
        del grads
        torch.cuda.empty_cache()
    model.cfg.remat = "none"
    del model, params
    torch.cuda.empty_cache()
    return counts, res


def train_moe_and_check(d, card, batches):
    """train_moe: the base width with MOE (8 experts in every second layer):
    N_MOE_UPDATES updates, a falling loss, the load-balance aux term logged
    per task; the attention kernels launched once per call of their route.
    Returns the launches, the results and the model (for serve_moe)."""
    model = build_train_model(d, "cuda", adaptors=ACTIVE_ADAPTORS, **MOE)
    moes = sum(1 for n, _ in model.net.named_parameters() if n.endswith("moe_ffn.moe_w1"))
    launches, losses, logs, ms, peak = _updates(model, batches, N_MOE_UPDATES, "train_moe", card)
    per_update = _expected_train_launches(batches, model.cfg, model.net)
    expected = {k: v * N_MOE_UPDATES for k, v in per_update.items()}
    log(f"  train_moe: {moes} MoE layers of {MOE['moe_experts']} experts; loss per token "
        f"{[round(x, 5) for x in losses]}; per task {logs}; step {ms:.1f} ms, peak {peak:.3f} GiB; "
        f"launches {({k: v for k, v in launches.items() if v})} (expected "
        f"{({k: v for k, v in expected.items() if v})}) [{card}]")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("train_moe: the loss did not fall")
    if not all("moe_aux" in v and all(np.isfinite(v["moe_aux"])) for v in logs.values()):
        raise SystemExit("train_moe: the aux term was not logged")
    if launches != expected:
        raise SystemExit("train_moe: a kernel did not run once per attention call of its route")
    model.net.eval()
    return launches, dict(losses=losses, step_ms=ms, peak_gib=peak, logs=logs), model


def serve_scan_and_check(hub, card, serve_res, root):
    """serve_scan: the base hub's weights saved as a stacked-layout
    checkpoint (``layers_scan/layer/<leaf>``, a leading layer axis) and
    served by ``OFASys.from_pretrained`` into a ``scan_layers`` model: the
    tokens of serve's dispatches equal serve's."""
    from ofasys_torch import OFASys
    from ofasys_torch.configure import to_dict
    from ofasys_torch.utils import checkpoint_utils
    from ofasys_torch.utils.jax_params import export_params

    cfg = hub.model.cfg
    cfg.scan_layers = True
    try:
        tree = export_params(hub.model.net)
        meta = {"model_cfg": to_dict(cfg), "global_dict": hub.global_dict.state_dict(),
                "active_adaptors": list(ACTIVE_ADAPTORS)}
    finally:
        cfg.scan_layers = False
    depth = tree["encoder"]["layers_scan"]["layer"]["self_attn"]["q_proj"]["kernel"].shape[0]
    checkpoint_utils.save_checkpoint(root, "scan", {"params": checkpoint_utils._to_tensors(tree)}, meta)
    del tree
    shub = OFASys.from_pretrained(os.path.join(root, "scan"), dtype=torch.bfloat16)
    assert shub.model.cfg.scan_layers
    reset_counts()
    mismatches = 0
    for instruction, data, kw, out in serve_res["calls"]:
        got = shub.inference(instruction, data, **kw)
        for a, b in zip(out if isinstance(data, list) else [out], got if isinstance(data, list) else [got],
                        strict=True):
            mismatches += not np.array_equal(a.tokens, b.tokens)
    launches = read_counts()
    log(f"  serve_scan: stacked checkpoint ({depth} layers a stack) served through "
        f"{len(serve_res['calls'])} dispatches: {mismatches} token mismatches against serve; launches "
        f"{({k: v for k, v in launches.items() if v})} [{card}]")
    if mismatches or not launches["dense_attention_fwd"]:
        raise SystemExit("serve_scan: the stacked layout does not serve serve's tokens")
    del shub
    torch.cuda.empty_cache()
    return launches


def _rank_launch_expect(rows, cfg, tp):
    """The launches one rank's gradient step should make: B1 and B2, or B3
    and the flash backward, once for each attention call of a layer by
    the route of the rank's rows ``rows`` ({task: (B, Ts, Tt)}) at its
    local heads under tensor = ``tp``."""
    import copy

    local = copy.deepcopy(cfg)
    for stack in (local.encoder, local.decoder):
        stack.attention_heads //= tp
        stack.embed_dim //= tp
    n = dict.fromkeys(KERNELS, 0)
    for B, Ts, Tt in rows.values():
        for Tq, Tk, layers in ((Ts, Ts, local.encoder.layers), (Tt, Tt, local.decoder.layers),
                               (Tt, Ts, local.decoder.layers)):
            route = _route(local, B, Tq, Tk, local.attention_dropout)
            if route != "plain":
                n[f"{route}_attention_fwd"] += layers
                n[f"{route}_attention_bwd"] += layers
    return n


def _ring_launch_expect(rows, cfg, n_seq):
    """The launches of one rank's gradient step under sequence_parallel:
    a self-attention whose length divides by the ring runs n_seq blocks of
    T / n_seq (B3 and the flash backward each, where the block passes the
    flash gate); the cross-attention and a length that does not divide
    take their own route. These are the first rank's counts: in a causal
    ring it holds the first query block, which sees one key block."""
    from ofasys_torch.ops.flash_attention import flash_supported

    n = dict.fromkeys(KERNELS, 0)
    D = cfg.encoder.embed_dim // cfg.encoder.attention_heads
    for B, Ts, Tt in rows.values():
        for Tq, Tk, layers, kind in ((Ts, Ts, cfg.encoder.layers, "self"), (Tt, Tt, cfg.decoder.layers, "causal"),
                                     (Tt, Ts, cfg.decoder.layers, "cross")):
            if kind != "cross" and Tq % n_seq == 0:
                if flash_supported(Tq // n_seq, Tk // n_seq, D, 0.0):
                    blocks = 1 if kind == "causal" else n_seq
                    n["flash_attention_fwd"] += blocks * layers
                    n["flash_attention_bwd"] += blocks * layers
                continue
            route = _route(cfg, B, Tq, Tk)
            if route != "plain":
                n[f"{route}_attention_fwd"] += layers
                n[f"{route}_attention_bwd"] += layers
    return n


_WORLD_REFS = {}


def _rank_update(label, pcfg, cfg_kw, batches):
    """One rank of a parallel_world update: the first rank computes the
    one-process gradients of the base width at WORLD_LAYERS (dropout 0);
    then every rank runs the sharded gradient step (parallel/api.py) on its
    rows and shards, and the first rank holds the gathered gradients
    against the one-process ones."""
    import torch.distributed as dist

    from ofasys_torch import GeneralistModel
    from ofasys_torch.configure.configs import ParallelConfig
    from ofasys_torch.engine.train_step import make_grad_step
    from ofasys_torch.parallel import Layout, build_mesh, make_sharded_grad_step, put_batch, shard_model
    from ofasys_torch.parallel import distributed as PD
    from ofasys_torch.utils.pytree import sample_to_device

    d, _ = base_dictionary()
    rank = dist.get_rank()
    kw = {"dropout": 0.0, "encoder.layers": WORLD_LAYERS, "decoder.layers": WORLD_LAYERS, **cfg_kw}
    crit = make_criteria(batches, d.pad())
    ref = None
    if rank == 0:
        # the one-process gradients, shared by the updates of one model config and batch
        key = (tuple(sorted(kw.items())), tuple((n, _task_shapes(b)) for n, b in batches.items()))
        if key not in _WORLD_REFS:
            _WORLD_REFS.clear()
            m = GeneralistModel(arch="base", **kw)
            m.initialize(d, active_adaptors=("text",), dtype=torch.bfloat16, device="cuda", seed=SEED)
            g = _grads(m, crit, list(m.net.parameters()), 0,
                       {n: sample_to_device(b, "cuda") for n, b in batches.items()})
            _WORLD_REFS[key] = [x.float() for x in g]
            del m, g
        ref = _WORLD_REFS[key]
    mesh = build_mesh(ParallelConfig(**pcfg))
    m = GeneralistModel(arch="base", **kw)
    m.initialize(d, active_adaptors=("text",), dtype=torch.bfloat16, device=mesh.device, seed=SEED,
                 mesh=mesh)
    shard_model(m.net, mesh)
    layout = Layout(m.net, mesh)
    dev = {n: put_batch(b, mesh) for n, b in batches.items()}
    steps = [make_sharded_grad_step(make_grad_step(m, crit[n], fold=i, shard=layout.data_shard), layout)
             for i, n in enumerate(dev)]
    torch.cuda.synchronize()
    PD.STAGED_OPS.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    acc = None
    for gs, b in zip(steps, dev.values()):
        g, _, _ = gs(layout.params, 0, b, SEED)
        acc = g if acc is None else [a + x for a, x in zip(acc, g)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    staged = dict(PD.STAGED_OPS)
    local_rows = {n: _task_shapes(b) for n, b in dev.items()}
    full = layout.full_grads(acc)
    out = dict(rank=rank, launches=launches, grad_ms=ms, staged=staged, local_rows=local_rows,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, param_bytes=layout.param_bytes(),
               heads=m.net.encoder.layers_0.self_attn.num_heads, mesh=mesh.shape)
    if rank == 0:
        names = [n for n, _ in m.net.named_parameters()]
        rel, norm_rel, leaves = _grad_diff(names, [full[n].float() for n in names], ref)
        worst = max(leaves, key=leaves.get)
        out.update(rel=rel, norm_rel=norm_rel, worst_leaf=worst, worst=leaves[worst])
    return out


def _rank_serve(calls, int8):
    """One rank of parallel_world's serving check: the base hub (after
    ``quantize()`` with ``int8``) serves serve's dispatches unsharded on the
    first rank, then sharded with ``OFASys.shard`` over tensor = WORLD on
    every rank, each run recording its beam selections
    (``_selection_log``). A request whose best answer differs passes only
    where its two searches first part at a selection with a margin of at
    most SHARD_TIE_TOL or, where they never part, where the pick among the
    finished hypotheses (both runs' n-best, run for those dispatches) does:
    the row-parallel products are summed in another order than one GEMM's,
    and bf16 rounds the difference."""
    import torch.distributed as dist

    from ofasys_torch.configure.configs import ParallelConfig
    from ofasys_torch.parallel import distributed as PD

    first = dist.get_rank() == 0

    def nbest(hub, instruction, data, kw):
        out = hub.inference(instruction, data, **dict(kw, return_n_best=kw.get("beam_size", 5)))
        return [h if isinstance(h, list) else [h] for h in (out if isinstance(data, list) else [out])]

    def run(hub):
        out = []
        for i, d, kw in calls:
            res = []
            log_ = _selection_log(hub, i, d, kw, unconstrained=True, result=res)
            out.append((log_, [_best(o).tokens for o in _flat(res[0], d)]))
        return out

    hub = build_base_hub()
    if int8:
        hub.quantize()
    ref = run(hub) if first else None
    hub.shard(ParallelConfig(data=1, tensor=WORLD))
    heads = hub.model.net.encoder.layers_0.self_attn.num_heads
    PD.STAGED_OPS.clear()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(hub)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # margins of the differing answers; dispatches whose searches never
    # part there get the n-best of both runs (every rank runs the sharded one)
    margins, final = [], [[]]
    if first:
        for c, ((log_g, tok_g), (log_r, tok_r)) in enumerate(zip(got, ref, strict=True)):
            for row, (a, b) in enumerate(zip(tok_g, tok_r, strict=True)):
                if not np.array_equal(a, b):
                    m = _parting_margin(log_g, log_r, row)
                    margins.append(m)
                    if m == float("inf"):
                        final[0].append((c, row, len(margins) - 1))
    dist.broadcast_object_list(final, src=0)
    calls_needed = sorted({c for c, _, _ in final[0]})
    shard_n = {c: nbest(hub, *calls[c]) for c in calls_needed}
    if first and calls_needed:
        hub = build_base_hub()
        if int8:
            hub.quantize()
        ref_n = {c: nbest(hub, *calls[c]) for c in calls_needed}
        for c, row, k in final[0]:
            g, r = shard_n[c][row], ref_n[c][row]
            gaps = [float(mine[0].score - h.score) for mine, other in ((g, r), (r, g))
                    for h in mine if np.array_equal(h.tokens, other[0].tokens)]
            margins[k] = min(gaps) if gaps else float("inf")
    return dict(launches=launches, margins=margins if first else None, wall_s=wall,
                staged=dict(PD.STAGED_OPS), heads=heads, n=sum(len(t) for _, t in got))


def _flat(out, data):
    return out if isinstance(data, list) else [out]


def _rank_warm():
    """A spawned rank's start: the port imported and the CUDA context made
    on cuda:0."""
    import ofasys_torch.parallel  # noqa: F401

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    return True


def worlds_start():
    """parallel_world's WORLD ranks over gloo and nccl_world's one rank over
    NCCL (parallel.distributed.World), spawned while the kernels build:
    each rank imports the port and makes its CUDA context, then waits for
    its work. Closed when the script exits, whatever happened before."""
    import atexit

    from ofasys_torch.parallel.distributed import World

    worlds = (World(WORLD, backend="gloo", threads=WORLD_THREADS, timeout=600),
              World(1, backend="nccl", threads=WORLD_THREADS, timeout=600))
    for w in worlds:
        w.submit(_rank_warm)
    atexit.register(lambda: [w.close(force=True) for w in worlds])
    return worlds


def parallel_world_and_check(card, batches, long_batches, serve_res, world):
    """parallel_world: WORLD ranks on cuda:0 over gloo (``world``, from
    :func:`worlds_start`). It prints the transport's rule for CUDA
    tensors on gloo and which ops each update staged through the host; runs each
    WORLD_UPDATES update against the one-process update (the ring's
    blocks through B3 and the flash backward, B1/B2 at the tensor rank's
    six heads); and serves serve's dispatches on the tensor-parallel hub in
    bf16 and after quantize() (B7 on the weight shards), tokens equal to
    one-rank serving but at near-ties (SHARD_TIE_TOL). Returns {label:
    launches of the first rank} and the
    results."""
    from ofasys_torch.parallel.distributed import GLOO_CUDA_OPS

    counts, res = {}, {}
    t0 = time.perf_counter()
    with world as w:
        w.collect()
        log(f"parallel_world: {WORLD} ranks on cuda:0 over gloo up (waited {time.perf_counter() - t0:.1f} s)")
        log(f"  the transport's rule for CUDA tensors on gloo: {sorted(GLOO_CUDA_OPS)} direct, every "
            "other op staged through the host")
        for label, pcfg, cfg_kw, which in WORLD_UPDATES:
            t1 = time.perf_counter()
            bs = batches if which == "train" else long_batches
            outs = w.run(_rank_update, label, pcfg, cfg_kw, bs)
            o = outs[0]
            expected = _rank_launch_expect(o["local_rows"], _cfg_of(cfg_kw), pcfg.get("tensor", 1)) \
                if label in ("data", "fsdp", "tensor") else None
            local = o["local_rows"]
            log(f"  parallel_world {label} {pcfg}: rank rows (B, Ts, Tt) {local}, heads a rank "
                f"{o['heads']}; parameter bytes a rank {[x['param_bytes'] for x in outs]}; gradient step "
                f"{[round(x['grad_ms'], 1) for x in outs]} ms, peak "
                f"{[round(x['peak_gib'], 3) for x in outs]} GiB; launches rank 0 "
                f"{({k: v for k, v in o['launches'].items() if v})}; staged through the host (gloo) "
                f"{o['staged']}; vs one process: rel {o['rel']:.3e} (tol {GRAD_REL_TOL}), worst leaf "
                f"{o['worst_leaf']} {o['worst']:.3e} (tol {LEAF_REL_TOL}) [{card}] "
                f"({time.perf_counter() - t1:.1f} s)")
            if not o["rel"] <= GRAD_REL_TOL or not o["worst"] <= LEAF_REL_TOL:
                raise SystemExit(f"parallel_world {label}: gradients differ from the one-process update")
            if label != "sequence" and any(x["launches"] != o["launches"] for x in outs):
                raise SystemExit(f"parallel_world {label}: the ranks launched different kernels")
            if expected is not None and o["launches"] != expected:
                raise SystemExit(f"parallel_world {label}: a rank did not run each attention call's "
                                 f"kernel (expected {({k: v for k, v in expected.items() if v})})")
            if label == "fsdp" and not all(x["param_bytes"] < 0.6 * res["data"]["param_bytes"] for x in outs):
                raise SystemExit("parallel_world fsdp: a rank holds more than its slices of the parameters")
            if label == "tensor" and (o["heads"] != 6 or not o["launches"]["dense_attention_fwd"]
                                      or not o["launches"]["dense_attention_bwd"]):
                raise SystemExit("parallel_world tensor: B1/B2 did not run on the rank's six heads")
            if label == "sequence":
                expected = _ring_launch_expect(local, _cfg_of(cfg_kw), pcfg["sequence"])
                log(f"  parallel_world sequence: expected launches a rank {({k: v for k, v in expected.items() if v})}")
                if o["launches"] != expected or not o["launches"]["flash_attention_fwd"]:
                    raise SystemExit("parallel_world sequence: the ring did not run B3 and the flash "
                                     "backward once for each of its blocks")
            counts[f"parallel_{label}"] = o["launches"]
            res[label] = {k: v for k, v in o.items() if k != "launches"}
        calls = [(i, d, kw) for i, d, kw, _ in serve_res["calls"]]
        for label, int8 in (("serve_shard", False), ("serve_shard_int8", True)):
            t1 = time.perf_counter()
            o = w.run(_rank_serve, calls, int8)[0]
            log(f"  parallel_world {label}: tensor={WORLD} ({o['heads']} heads a rank) served serve's "
                f"{o['n']} requests (selections logged) in {o['wall_s']:.2f} s: "
                f"{len(o['margins'])} answers differ from one-rank serving on the same batches, their "
                f"searches parting at margins {[round(g, 5) for g in o['margins']]} (near-tie tol "
                f"{SHARD_TIE_TOL}); launches rank 0 {({k: v for k, v in o['launches'].items() if v})}; "
                f"staged {o['staged']} [{card}] ({time.perf_counter() - t1:.1f} s)")
            if any(not g <= SHARD_TIE_TOL for g in o["margins"]):
                raise SystemExit(f"parallel_world {label}: sharded tokens differ from one-rank serving")
            kernel = "int8_matmul_fwd" if int8 else "dense_attention_fwd"
            if not o["launches"][kernel]:
                raise SystemExit(f"parallel_world {label}: {kernel} did not run on the shards")
            counts[f"parallel_{label}"] = o["launches"]
            res[label] = {k: v for k, v in o.items() if k != "launches"}
    log(f"parallel_world: {time.perf_counter() - t0:.1f} s")
    return counts, res


def _cfg_of(cfg_kw):
    from ofasys_torch import GeneralistModel

    return GeneralistModel(arch="base", **{"encoder.layers": WORLD_LAYERS, "decoder.layers": WORLD_LAYERS,
                                           **cfg_kw}).cfg


def nccl_world_start(batches, w):
    """nccl_world: a world of one rank over NCCL (``w``, from
    :func:`worlds_start`) handed the data path's sharded gradient step,
    which it runs beside parallel_world; ``nccl_world_and_check`` collects
    it."""
    w.collect()
    w.submit(_rank_update, "nccl", dict(data=1), {}, batches)
    return w, time.perf_counter()


def nccl_world_and_check(card, started):
    """The NCCL rank's gradient step (its reductions on NCCL) against the
    one-process step."""
    w, t0 = started
    try:
        o = w.collect()[0]
    finally:
        w.close()
    log(f"  nccl_world: data path over a one-rank NCCL group (run beside parallel_world): gradient "
        f"step {o['grad_ms']:.1f} ms, launches {({k: v for k, v in o['launches'].items() if v})}, staged "
        f"{o['staged']}; vs one process rel {o['rel']:.3e} [{card}] ({time.perf_counter() - t0:.1f} s)")
    if not o["rel"] <= GRAD_REL_TOL or o["staged"]:
        raise SystemExit("nccl_world: the data path over NCCL disagrees with the one-process update")
    return o["launches"], {k: v for k, v in o.items() if k != "launches"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ofasys_torch  # noqa: F401  (fails where the package is absent)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    name, card = phase_device()
    gloo_world, nccl_world = worlds_start()
    phase_build()
    mark("build")
    hub = build_base_hub()
    cfg, d, base_gp = hub.model.cfg, hub.global_dict, hub.general_preprocess
    train_batches = make_train_batches(hub.general_preprocess)
    long_gp = long_preprocess(d)
    long_batches = make_train_batches(long_gp, LONG_TRAIN_TASKS)
    long_calls = train_shapes(long_batches)
    routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in long_calls}
    log(f"train_long attention routes: {routes}")
    mm_batches = make_train_batches(hub.general_preprocess, MM_TRAIN_TASKS)
    mm_calls = [c for c in train_shapes(mm_batches) if not c[0].startswith("text_infilling")]
    mm_routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in mm_calls}
    log(f"train_mm attention routes (caption, vqa): {mm_routes}")
    caption_serve = planned_dispatch_shapes(hub.general_preprocess, _caption_requests(), CAPTION_TPL)
    asr_serve = planned_dispatch_shapes(hub.general_preprocess, _asr_requests(), ASR_TPL)
    full_batches = make_train_batches(hub.general_preprocess, FULL_TRAIN_TASKS)
    full_calls = [(f"full_{label}", shape, causal) for label, shape, causal in train_shapes(full_batches)
                  if label.startswith(("asr", "motion_t2m"))]
    mB, mTs, mTt = _task_shapes(motion_sample(hub.general_preprocess)[0])
    motion_calls = [("serve_motion_decoder_full", (mB, mTt, mTt), False),
                    ("serve_motion_cross", (mB, mTt, mTs), False)]
    new_routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in full_calls + motion_calls}
    new_routes.update({f"serve_asr_dispatch{i}": _route(cfg, B, T, T) for i, (B, T) in enumerate(asr_serve)})
    new_routes["serve_motion_encoder"] = _route(cfg, mB, mTs, mTs)
    log(f"train_full (asr, motion_t2m), serve_asr and serve_motion attention shapes (B, Tq, Tk) and "
        f"routes: {[(lb, sh) for lb, sh, _ in full_calls + motion_calls]} "
        f"{[(f'serve_asr_dispatch{i}', s) for i, s in enumerate(asr_serve)]} "
        f"serve_motion_encoder {(mB, mTs)}: {new_routes}")
    fit_root = tempfile.mkdtemp(prefix="ofasys_torch_fit_")
    atexit.register(shutil.rmtree, fit_root, True)
    saved_cache = os.environ.get("OFA_CACHE_HOME")
    os.environ["OFA_CACHE_HOME"] = fit_root          # the TSV line indexes
    fx = fit_fixture(fit_root)
    efx = eval_fixture(fx)
    with gpt2_text(fx):
        fit_d, fit_updates = fit_plan(fx)
        from ofasys_torch.preprocessor.general import GeneralPreprocess

        fit_gp = GeneralPreprocess(fit_d, active=["text"])
        pretrained_serve = planned_dispatch_shapes(fit_gp, _bpe_requests(fit_gp), TPL)
        eval_serve = eval_dispatch_shapes(efx, fit_d)
        eval_calls = eval_traverse_calls(efx, fit_d, eval_serve, cfg)
    log(f"evaluate encoder shapes (B, T) and routes: {[(lb, sh, _route(cfg, sh[0], sh[1], sh[1])) for lb, sh in eval_serve]}; "
        f"B1's candidate-pass decoder calls (B, Tq, Tk): {[(lb, sh) for lb, sh, _ in eval_calls]}")
    fit_calls = fit_train_shapes(fit_updates)
    log(f"train_fit attention shapes (B, Tq, Tk) and routes: "
        f"{[(lb, sh, _route(cfg, *sh)) for lb, sh, _ in fit_calls]}; serve_pretrained dispatches "
        f"{pretrained_serve}: {[_route(cfg, B, T, T) for B, T in pretrained_serve]}")
    ground_d, ground_gp = ground_preprocess()
    t0 = time.perf_counter()
    ground_batches = make_train_batches(ground_gp, GROUND_TRAIN_TASKS)
    log(f"train_ground batches: {sum(b['nsentences'] for b in ground_batches.values())} samples "
        f"preprocessed in {time.perf_counter() - t0:.1f} s [host CPU]")
    ground_serve = ground_dispatch_shapes(ground_gp)
    ground_calls = [(f"ground_{label}", shape, causal) for label, shape, causal in train_shapes(ground_batches)]
    ground_routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in ground_calls}
    ground_routes.update({f"serve_ground_dispatch{i}": _route(cfg, B, T, T)
                          for i, (B, T) in enumerate(ground_serve)})
    mm_shapes = {shape: label for label, shape, _ in mm_calls}
    same_as_mm = {label: mm_shapes[shape] for label, shape, _ in ground_calls if shape in mm_shapes}
    log(f"train_ground and serve_ground attention shapes (B, Tq, Tk) and routes: "
        f"{[(lb, sh) for lb, sh, _ in ground_calls]} serve_ground dispatches {ground_serve}: "
        f"{ground_routes}; held at train_mm's rows where the shape is the same: {same_as_mm}")
    # speech targets and image codes: the training batches and serving dispatches of their phases
    tts_batches = make_train_batches(base_gp, TTS_TRAIN_TASKS)
    pretrain_batches = make_train_batches(base_gp, PRETRAIN_TRAIN_TASKS)
    code_d, code_gp = vqgan_preprocess()
    infill, infill_vq_ms = infill_batches(code_gp, card)
    slice_calls = train_shapes(tts_batches) + train_shapes(pretrain_batches) + train_shapes(infill)
    slice_routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in slice_calls}
    slice_serve = [("serve_tts_dispatch", _encoder_shape(base_gp, _tts_requests(), TTS_TPL)),
                   ("serve_image_gen_dispatch", _encoder_shape(code_gp, _image_gen_prompts(), IMAGE_GEN_TPL))]
    log(f"train_tts, train_audio_pretrain and train_image_infilling attention shapes (B, Tq, Tk) and "
        f"routes: {[(lb, sh) for lb, sh, _ in slice_calls]}: {slice_routes}; serve_tts and "
        f"serve_image_gen dispatches {slice_serve}: {[_route(cfg, B, T, T) for _, (B, T) in slice_serve]}")
    # video, STRUCT and PHONE paths: their batches, dispatches and attention calls
    spider_root = tempfile.mkdtemp(prefix="ofasys_torch_spider_")
    atexit.register(shutil.rmtree, spider_root, True)
    video = video_batches(code_gp)
    video_grad = video_batches(code_gp, {n: dict(spec, batch=VIDEO_GRAD_BATCH)
                                         for n, spec in VIDEO_TRAIN_TASKS.items()})
    struct = struct_batches(base_gp, spider_root)
    ctc_d, ctc_gp = ctc_preprocess()
    ctc_batches = make_train_batches(ctc_gp, ASR_CTC_TASKS)
    item11_calls = train_shapes(video) + train_shapes(struct) + train_shapes(ctc_batches)
    item11_routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in item11_calls}
    video_serve = _encoder_shape(code_gp, [r for r, _ in _video_requests()], VIDEO_CAPTION_TPL)
    spider_rows = _spider_rows(spider_root)
    spider_serve = [_encoder_shape(base_gp, spider_rows[i:i + 8], SPIDER_TPL) for i in (0, 8)]
    log(f"train_video, train_struct and train_asr_ctc attention shapes (B, Tq, Tk) and routes: "
        f"{[(lb, sh) for lb, sh, _ in item11_calls]}: {item11_routes}; serve_video dispatch {video_serve}: "
        f"{_route(cfg, *video_serve, video_serve[1])}; serve_spider's batches {spider_serve}: "
        f"{[_route(cfg, B, T, T) for B, T in spider_serve]}")
    closed_serve = closed_dispatch_shapes(hub.general_preprocess)
    lexical_serve = lexical_dispatch_shapes(hub.general_preprocess)
    log(f"serve_closed and serve_lexical dispatches (B, T) and routes: "
        f"{[(sh, _route(cfg, sh[0], sh[1], sh[1])) for sh in closed_serve + lexical_serve]}")
    dispatches = [(f"dispatch{i}", s) for i, s in enumerate(planned_dispatch_shapes())] \
        + [(f"serve_caption_dispatch{i}", s) for i, s in enumerate(caption_serve)] \
        + [(f"serve_asr_dispatch{i}", s) for i, s in enumerate(asr_serve)] \
        + [("serve_motion_encoder", (mB, mTs))] \
        + [(f"serve_ground_dispatch{i}", s) for i, s in enumerate(ground_serve)] \
        + [(f"serve_closed_dispatch{i}", s) for i, s in enumerate(closed_serve)] \
        + [(f"serve_lexical_dispatch{i}", s) for i, s in enumerate(lexical_serve)] \
        + [(f"serve_pretrained_dispatch{i}", s) for i, s in enumerate(pretrained_serve)] \
        + eval_serve + slice_serve + [("serve_spider_batch0", spider_serve[0])]
    fres, bres, rres = phase_kernels(
        dispatches, train_shapes(train_batches) + [c for c in long_calls if routes[c[0]] == "dense"]
        + [c for c in mm_calls if mm_routes[c[0]] == "dense"]
        + [c for c in full_calls if new_routes[c[0]] == "dense"]
        + [c for c in ground_calls if ground_routes[c[0]] == "dense" and c[0] not in same_as_mm]
        + fit_calls + [c for c in slice_calls if slice_routes[c[0]] == "dense"]
        + [c for c in item11_calls if item11_routes[c[0]] == "dense"],
        motion_calls + eval_calls)
    # B1 at the speculative draft's dispatch of 8 (its own heads, D = 64)
    from ofasys_torch import GeneralistModel

    dcfg = GeneralistModel(arch=DRAFT_ARCH).cfg
    sB, sT = planned_dispatch_shapes()[0]
    fres.append(check_fwd("serve_speculative_draft_dispatch",
                          (sB, sT, sT, dcfg.encoder.attention_heads,
                           dcfg.encoder.embed_dim // dcfg.encoder.attention_heads)))
    mark("dense kernels")
    long_serve = planned_dispatch_shapes(long_gp, _long_requests(), SUMMARY_TPL)
    flash_serve = [(f"serve_long_dispatch{i}", s) for i, s in enumerate(long_serve)]
    flash_serve.append(("serve_truncated", planned_dispatch_shapes(
        hub.general_preprocess, _truncated_requests(), SUMMARY_TPL)[0]))
    flash_serve.append(("serve_video_dispatch", video_serve))
    flash_serve.append(("serve_spider_batch1", spider_serve[1]))
    flash_rows = phase_flash_kernels(flash_serve, [c for c in long_calls if routes[c[0]] == "flash"]
                                     + [c for c in slice_calls if slice_routes[c[0]] == "flash"]
                                     + [c for c in item11_calls if item11_routes[c[0]] == "flash"])
    mark("flash kernels")
    int8_rows = phase_int8_kernels(max(B * T for B, T in planned_dispatch_shapes()), len(d), train_batches)
    ln_rows = phase_ln_kernels(train_batches)
    mark("kernels")

    serve_res = serve_and_check(hub, card)
    counts = {"serve": serve_res["launches"]}
    phase_profile(hub, card)
    mark("serve")
    counts["serve_long"] = serve_long_and_check(hub, card)["launches"]
    counts["serve_truncated"] = serve_truncated_and_check(hub, card)["launches"]
    mark("serve_long, serve_truncated")
    counts["serve_int8"] = serve_int8_and_check(hub, card, serve_res)["launches"]
    counts["serve_ln"] = serve_ln_and_check(hub, card)["launches"]
    mark("serve_int8, serve_ln")
    caption_res = serve_caption_and_check(hub, card, serve_res)
    counts["serve_caption"] = caption_res["launches"]
    phase_profile(hub, card, tpl=CAPTION_TPL, reqs=_caption_requests(),
                  what="one caption dispatch (B=8, beam 5)")
    mark("serve_caption")
    asr_res = serve_asr_and_check(hub, card, serve_res)
    counts["serve_asr"] = asr_res["launches"]
    phase_profile(hub, card, tpl=ASR_TPL, reqs=_asr_requests(), what="one asr dispatch (B=8, beam 5)")
    mark("serve_asr")
    counts["serve_motion"], motion_res = serve_motion_and_check(hub, card)
    mark("serve_motion")
    closed_res = serve_closed_and_check(hub, card)
    counts["serve_closed"] = closed_res["launches"]
    mark("serve_closed")
    sample_res, topp_res = serve_sample_and_check(hub, card, serve_res)
    counts["serve_sample"], counts["serve_sample_topp"] = sample_res["launches"], topp_res["launches"]
    mark("serve_sample")
    for strategy, r in serve_diverse_and_check(hub, card).items():
        counts[f"serve_{strategy}"] = r["launches"]
    mark("serve_diverse")
    lexical_res = serve_lexical_and_check(hub, card)
    for rep, r in lexical_res.items():
        counts[f"serve_lexical_{rep}"] = r["launches"]
    mark("serve_lexical")
    ensemble_res = serve_ensemble_and_check(hub, card, serve_res)
    counts["serve_ensemble"] = ensemble_res["launches"]
    mark("serve_ensemble")
    spec_res = serve_speculative_and_check(hub, card, serve_res)
    counts["serve_speculative"] = spec_res["launches"]
    mark("serve_speculative")
    counts["serve_spider"], spider_res = serve_spider_and_check(hub.model, card, spider_root)
    serve_enc = serve_encoder_output(hub)
    mark("serve_spider")
    nan_res = nan_check_and_check(hub, card)
    torch.cuda.empty_cache()
    mark("nan_check")
    scan_root = tempfile.mkdtemp(prefix="ofasys_torch_scan_")
    atexit.register(shutil.rmtree, scan_root, True)
    counts["serve_scan"] = serve_scan_and_check(hub, card, serve_res, scan_root)
    shutil.rmtree(scan_root, ignore_errors=True)
    mark("serve_scan")

    model = build_train_model(d, "cuda")
    counts["train"], train_res, (step, state, dev) = train_and_check(
        model, hub.general_preprocess, card, batches=train_batches)
    train_res["profile"] = phase_profile_train(step, state, dev, card)
    del model, step, state, dev
    torch.cuda.empty_cache()
    mark("train")
    counts["train_qat"], qat_res = train_qat_and_check(d, hub.general_preprocess, card, train_batches, train_res)
    torch.cuda.empty_cache()
    mark("train_qat")
    counts["train_chunked"], chunked_res = train_chunked_and_check(d, hub.general_preprocess, card,
                                                                   train_batches, train_res)
    torch.cuda.empty_cache()
    mark("train_chunked")
    optim_res = train_optimizers_and_check(d, hub.general_preprocess, card, train_batches)
    torch.cuda.empty_cache()
    mark("train_optimizers")

    model = build_train_model(d, "cuda")
    grad_batches = make_train_batches(long_gp, {n: dict(spec, batch=GRAD_CHECK_BATCH)
                                                for n, spec in LONG_TRAIN_TASKS.items()})
    counts["train_long"], long_res, (step, state, dev) = train_and_check(
        model, long_gp, card, batches=long_batches, label="train_long", grad_batches=grad_batches)
    from ofasys_torch.ops import flash_attention as fl

    old = [n for n in FLASH_BWD_ROWS if hasattr(getattr(fl, n), "launches")]
    log(f"train_long: {counts['train_long']['flash_attention_bwd'] // N_UPDATES} launches of the one "
        f"flash backward pass per update; the part wrappers {list(FLASH_BWD_ROWS)} launch no kernel "
        f"of their own (counted: {old})")
    if old:
        raise SystemExit(f"{old} count launches of their own: the one pass is counted once")
    phase_profile_train(step, state, dev, card,
                        "one long training update (text_infilling_long B=16 + gigaword_long B=16)")
    del model, step, state, dev
    torch.cuda.empty_cache()
    mark("train_long")

    ln = train_ln_and_check(d, hub.general_preprocess, card, batches=train_batches)
    for label, (c, res) in ln.items():
        counts[label] = c
        log(f"{label}: step {res['step_ms']:.2f} ms, {res['samples_per_s']:.1f} samples/s "
            f"(train: {train_res['step_ms']:.2f} ms, {train_res['samples_per_s']:.1f} samples/s) [{card}]")
    mark("train_ln")

    model = build_train_model(d, "cuda")
    counts["train_mm"], mm_res, (step, state, dev) = train_and_check(
        model, hub.general_preprocess, card, batches=mm_batches, label="train_mm")
    phase_profile_train(step, state, dev, card,
                        "one three-task update (caption B=64 + text_infilling B=128 + vqa B=48)")
    del model, step, state, dev
    torch.cuda.empty_cache()
    mark("train_mm")
    counts["train_rowmajor"], row_res = train_rowmajor_and_check(
        d, hub.general_preprocess, card, batches=mm_batches, mm_res=mm_res)
    torch.cuda.empty_cache()
    mark("train_rowmajor")

    model = build_train_model(d, "cuda")
    torch.cuda.reset_peak_memory_stats()
    counts["train_full"], full_res, (step, state, dev) = train_and_check(
        model, hub.general_preprocess, card, tasks=FULL_TRAIN_TASKS, batches=full_batches,
        label="train_full")
    full_res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train_full: peak device memory {full_res['peak_memory_gib']:.2f} GiB (updates and "
        f"gradient checks) [{card}]")
    phase_profile_train(step, state, dev, card,
                        "one five-task update (caption B=64 + text_infilling B=128 + asr B=32 + "
                        "vqa B=48 + motion_t2m B=32)")
    del model, step, state, dev
    torch.cuda.empty_cache()

    del hub
    torch.cuda.empty_cache()
    mark("train_full")
    with gpt2_text(fx):
        counts["train_fit"], fit_res, fit = train_fit_and_check(fx, card, train_res=train_res)
        mark("train_fit")
        counts["serve_pretrained"], counts["serve_pretrained_ensemble"], pre_res = \
            serve_pretrained_and_check(fit, card, serve_res=serve_res)
        mark("serve_pretrained")
        del fit["trainer"], fit["tasks"]
        torch.cuda.empty_cache()
        counts["evaluate"], eval_res, trav = evaluate_and_check(fx, efx, card, fit["last"])
        mark("evaluate")
        trav_res = traverse_kernels_and_check(trav, card)
        del trav
        torch.cuda.empty_cache()
        mark("traverse_kernels")
        counts["launch"], launch_res = launch_and_check(fx, fit, card, counts["train_fit"])
        mark("launch")
        counts["train_profile"], profile_res, breakdown = train_profile_and_check(fx, fit, card, fit_res)
        torch.cuda.empty_cache()
        mark("train_profile")
        native_res = host_native_and_check(fx, card, breakdown, profile_res, fit_res)
        del breakdown
        mark("host_native")
        counts["train_fetch"], fetch_res = train_fetch_and_check(fx, fit, card)
        del fit
    torch.cuda.empty_cache()
    shutil.rmtree(fit_root, ignore_errors=True)
    if saved_cache is None:
        os.environ.pop("OFA_CACHE_HOME", None)
    else:
        os.environ["OFA_CACHE_HOME"] = saved_cache
    mark("train_fetch")
    ground_hub = build_ground_hub(ground_d, ground_gp)
    ground_res = serve_ground_and_check(ground_hub, card, caption_res)
    counts["serve_ground"] = ground_res["launches"]
    counts["serve_ground_constrained"] = ground_res["launches_constrained"]
    busy = phase_profile(ground_hub, card, tpl=REFCOCO_TPL, reqs=_ground_requests(),
                         what="one serve_ground dispatch (B=8, greedy, 4 bin tokens)", opts={})["busy_ms"]
    log(f"  serve_ground: the trunk's forward on the dispatch's 8 images, profiled alone: "
        f"{ground_res['trunk_busy_ms']:.3f} ms busy, {100 * ground_res['trunk_busy_ms'] / busy:.1f}% of "
        f"the dispatch's {busy:.2f} ms [{card}]")
    ground_res["dispatch_busy_ms"] = busy
    mark("serve_ground")
    counts["import_reference"], import_res = import_reference_and_check(ground_hub, card, ground_res)
    del ground_hub
    torch.cuda.empty_cache()
    mark("import_reference")
    counts["train_ground"], tg_res = train_ground_and_check(ground_d, ground_gp, card, ground_batches, mm_res)
    tg_res["rand_augment_ms"] = rand_augment_ms(card)
    mark("train_ground")
    counts["train_ground_modal_ffn"], mf_res = train_ground_modal_ffn_and_check(
        ground_d, ground_gp, card, ground_batches)
    torch.cuda.empty_cache()
    mark("train_ground_modal_ffn")

    speech = build_train_model(d, "cuda", adaptors=SPEECH_ADAPTORS)
    counts["serve_tts"], tts_res = serve_tts_and_check(speech, base_gp, card)
    tts_frames = tts_res.pop("frames")
    mark("serve_tts")
    counts["train_tts"], train_tts_res, _ = train_and_check(speech, base_gp, card, tasks=TTS_TRAIN_TASKS,
                                                            batches=tts_batches, label="train_tts")
    torch.cuda.empty_cache()
    mark("train_tts")
    counts["train_audio_pretrain"], pretrain_res, _ = train_and_check(
        speech, base_gp, card, tasks=PRETRAIN_TRAIN_TASKS, batches=pretrain_batches,
        label="train_audio_pretrain")
    torch.cuda.empty_cache()
    mark("train_audio_pretrain")
    counts["train_scst"], scst_res, (sf, sb, sr) = train_scst_and_check(speech, base_gp, card)
    fres, bres, rres = fres + sf, bres + sb, rres + sr
    del speech
    torch.cuda.empty_cache()
    mark("train_scst")
    code_model = build_vqgan_model(code_d, layers=CODE_LAYERS)
    counts["serve_image_gen"], image_gen_res = serve_image_gen_and_check(code_model, card)
    torch.cuda.empty_cache()
    mark("serve_image_gen")
    torch.cuda.reset_peak_memory_stats()
    counts["train_image_infilling"], infill_res, _ = train_and_check(
        code_model, code_gp, card, tasks=INFILL_TRAIN_TASKS, batches=infill, label="train_image_infilling")
    infill_res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    infill_res["vqgan_encode_ms"] = infill_vq_ms
    log(f"train_image_infilling: peak device memory {infill_res['peak_memory_gib']:.2f} GiB (updates and "
        f"gradient checks) [{card}]")
    del code_model
    torch.cuda.empty_cache()
    mark("train_image_infilling")

    video_model = build_vqgan_model(code_d, adaptors=VIDEO_ADAPTORS)
    counts["serve_video"], video_res = serve_video_and_check(video_model, code_gp, card, serve_res)
    mark("serve_video")
    counts["train_video"], train_video_res = train_video_and_check(video_model, code_gp, card, video, video_grad)
    del video_model
    torch.cuda.empty_cache()
    mark("train_video")
    model = build_train_model(d, "cuda")
    counts["train_struct"], struct_res, _ = train_and_check(model, base_gp, card, tasks=STRUCT_TRAIN_TASKS,
                                                            batches=struct, label="train_struct")
    del model
    torch.cuda.empty_cache()
    mark("train_struct")
    model = build_train_model(ctc_d, "cuda", adaptors=("text", "audio_fbank"))
    counts["train_asr_ctc"], ctc_res = train_asr_ctc_and_check(model, ctc_gp, card, batches=ctc_batches)
    counts["serve_phone"], phone_res = serve_phone_and_check(model, ctc_gp, card)
    del model
    torch.cuda.empty_cache()
    mark("train_asr_ctc, serve_phone")
    heads_res = heads_and_check(tts_frames, serve_enc, card)
    mark("heads")

    # parallelism: remat, MoE, and the ranks of parallel_world and nccl_world
    long_grad = make_train_batches(long_gp, {n: dict(spec, batch=GRAD_CHECK_BATCH)
                                             for n, spec in LONG_TRAIN_TASKS.items()})
    remat_counts, remat_res = train_remat_and_check(d, card, train_batches, long_grad)
    counts.update(remat_counts)
    mark("train_remat")
    counts["train_moe"], moe_res, moe_model = train_moe_and_check(d, card, train_batches)
    mark("train_moe")
    from ofasys_torch import OFASys

    moe_hub = OFASys(moe_model, None, d, base_gp)
    moe_serve = serve_and_check(moe_hub, card, label="serve_moe", check_encoder=False)
    counts["serve_moe"] = moe_serve["launches"]
    moe_res["serve_p50_ms"] = moe_serve["p50_ms"]
    del moe_hub, moe_model, moe_serve
    torch.cuda.empty_cache()
    mark("serve_moe")
    seq_gp = long_preprocess(d)
    seq_gp.name2pre["text"].cfg.pad_to_fixed = True
    seq_batches = make_train_batches(seq_gp, {"gigaword_long": LONG_TRAIN_TASKS["gigaword_long"]})
    nccl = nccl_world_start(train_batches, nccl_world)
    world_counts, world_res = parallel_world_and_check(card, train_batches, seq_batches, serve_res,
                                                       gloo_world)
    counts.update(world_counts)
    mark("parallel_world")
    counts["nccl_world"], nccl_res = nccl_world_and_check(card, nccl)
    mark("nccl_world")
    # the kernels at the parallel paths' own shapes: B1/B2 at the tensor
    # rank's six heads, B3 and the flash backward at the ring's blocks
    for label, (B, Ts, Tt) in world_res["tensor"]["local_rows"].items():
        for call, (Tq, Tk), causal in (("encoder", (Ts, Ts), False), ("decoder", (Tt, Tt), True)):
            shape = (B, Tq, Tk, 6, 64)
            if _route(_cfg_of({}), B, Tq, Tk) == "dense":
                fres.append(check_fwd(f"tensor2_{label}_{call}", shape, causal))
                b2, b2r = check_bwd(f"tensor2_{label}_{call}", shape, causal)
                bres.append(b2)
                rres.append(b2r)
    B, Ts, _ = world_res["sequence"]["local_rows"]["gigaword_long"]
    n_seq = next(p["sequence"] for label, p, _, _ in WORLD_UPDATES if label == "sequence")
    for label, causal in (("ring_block", False), ("ring_block_causal_diagonal", True)):
        for kernel, r in check_flash(label, (B, Ts // n_seq, Ts // n_seq, 12, 64), causal).items():
            flash_rows[kernel].append(r)
    mark("parallel kernels")

    def by_path(kernel):
        return {path: c[kernel] for path, c in counts.items()}

    kernels = [
        _kernel_entry("dense_attention_fwd", by_path("dense_attention_fwd"), "train", fres, "err_out",
                      "text_infilling_encoder", card,
                      max_abs_err_lse=max(r["err_lse"] for r in fres)),
        _kernel_entry("dense_attention_bwd", by_path("dense_attention_bwd"), "train", bres, "err",
                      "text_infilling_encoder", card),
        _kernel_entry("dense_attention_bwd_rowmajor", by_path("dense_attention_bwd_rowmajor"),
                      "train_rowmajor", rres, "err", "caption_encoder", card),
        _kernel_entry("flash_attention_fwd", by_path("flash_attention_fwd"), "train_long",
                      flash_rows["flash_attention_fwd"], "err", "gigaword_long_encoder", card,
                      max_abs_err_lse=max(r["err_lse"] for r in flash_rows["flash_attention_fwd"])),
    ] + [
        dict(_kernel_entry("flash_attention_bwd", by_path("flash_attention_bwd"), "train_long",
                           flash_rows["flash_attention_bwd"], err_key, "gigaword_long_encoder",
                           card, port="flash_attention_bwd",
                           ms_covers="the whole backward (dq, dk, dv, bias gradient) in one pass",
                           plain_covers="the whole backward (dq, dk, dv, bias gradient)",
                           library_covers="the whole backward (dq, dk, dv, bias gradient)"),
             name=name, replaces=replaces)
        for name, (replaces, err_key) in FLASH_BWD_ROWS.items()
    ] + [
        _kernel_entry("int8_matmul_fwd", by_path("int8_matmul_fwd"), "serve_int8", int8_rows, "err",
                      "decode_logits", card, bit_equal=all(r["bit_equal"] for r in int8_rows),
                      library_covers="torch._int_mm + the same epilogue"),
    ] + [
        _kernel_entry(k, by_path(k), "train_ln", ln_rows[k], "err", "text_infilling_encoder", card)
        for k in ("layer_norm_fwd", "layer_norm_bwd")
    ]
    log(f"train: {json.dumps(train_res)}")
    log(f"train_long: {json.dumps(long_res)}")
    log(f"train_mm: {json.dumps(mm_res)}")
    log(f"train_rowmajor: {json.dumps(row_res)}")
    log(f"train_full: {json.dumps(full_res)}")
    log(f"serve_asr: {json.dumps({k: v for k, v in asr_res.items() if k in ('p50_ms', 'tokens_per_s', 'preprocess_ms')})}")
    log(f"serve_motion: {json.dumps(motion_res)}")
    log(f"serve_ground: {json.dumps({k: v for k, v in ground_res.items() if k in ('p50_ms', 'requests_per_s', 'tokens_per_s', 'preprocess_ms', 'trunk_rel', 'trunk_rms', 'trunk_ms_bf16', 'trunk_ms_fp32', 'trunk_busy_ms', 'dispatch_busy_ms', 'shapes')})}")
    log(f"train_ground: {json.dumps(tg_res)}")
    log(f"train_ground_modal_ffn: {json.dumps(mf_res)}")
    log(f"train_qat: {json.dumps(qat_res)}")
    log(f"train_chunked: {json.dumps(chunked_res)}")
    log(f"train_optimizers: {json.dumps(optim_res)}")
    log(f"train_fit: {json.dumps(fit_res)}")
    log(f"serve_pretrained: {json.dumps(pre_res)}")
    log(f"import_reference: {json.dumps(import_res)}")
    log(f"evaluate: {json.dumps(eval_res)}")
    log(f"traverse_kernels: {json.dumps(trav_res)}")
    log(f"launch: {json.dumps(launch_res)}")
    log(f"serve_lexical: {json.dumps(lexical_res)}")
    log(f"serve_speculative: {json.dumps({k: v for k, v in spec_res.items() if k != 'launches'})}")
    log(f"nan_check: {json.dumps(nan_res)}")
    log(f"train_profile: {json.dumps(profile_res)}")
    log(f"host_native: {json.dumps(native_res)}")
    log(f"train_fetch: {json.dumps(fetch_res)}")
    for label, res in (("serve_tts", tts_res), ("train_tts", train_tts_res),
                       ("train_audio_pretrain", pretrain_res), ("train_scst", scst_res),
                       ("serve_image_gen", image_gen_res), ("train_image_infilling", infill_res),
                       ("serve_video", video_res), ("train_video", train_video_res),
                       ("serve_spider", spider_res), ("train_struct", struct_res),
                       ("train_asr_ctc", ctc_res), ("serve_phone", phone_res), ("heads", heads_res)):
        log(f"{label}: {json.dumps(res)}")
    log("serve p50 ms: " + json.dumps({k: r["p50_ms"] for k, r in (
        ("serve", serve_res), ("serve_closed", closed_res), ("serve_sample", sample_res),
        ("serve_sample_topp", topp_res), ("serve_ensemble", ensemble_res),
        ("serve_speculative", spec_res), ("serve_video", video_res))}))
    for label, (_, res) in ln.items():
        log(f"{label}: {json.dumps(res)}")
    for label, r in (("train_remat", remat_res), ("train_moe", moe_res), ("parallel_world", world_res),
                     ("nccl_world", nccl_res)):
        log(f"{label}: {json.dumps(r, default=str)}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
