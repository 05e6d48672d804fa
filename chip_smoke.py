"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]
    python3 chip_smoke.py --times [--parent DIR]   # kernel times only

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the twelve kernel sources in parallel, one nvcc each
     (misinfo_tpu_torch/csrc/{int8_ffn,int8_dense,fused_attention,
     layer_norm,fused_ffn,self_attn_step,cross_ffn_step,
     cross_ffn_step_i8cc,layer_step,int4_sims,flash_attention,
     flash_attention_bwd}.cu), and the BPE encoder (csrc/bpe_encoder.cpp)
     with g++ beside them;
  3. K1 (int8 FFN) against its plain PyTorch version on the card through
     misinfo_tpu_torch/ops/kernel_checks.py at the main path's three
     shapes (RoBERTa, CLIP text, CLIP vision; B = 3, the kernel's split
     form) and at RoBERTa b32/S512 (one block per output tile), within 3
     int8 levels of the plain output with the planted faults (a chunk
     left out, the intermediate's scale per row, the next chunk's scale,
     the ragged last tile dropped) outside that band, and bit for bit on
     an integer grid where every scale of x and the weights is 1, at
     M = 37 and 16,384 (both forms); CUDA-event times with the bound and
     torch._int_mm of the two integer products as a yardstick; also at
     the video path's CLIP vision shape (16 videos × 12 frames × 50
     tokens = 9,600 rows);
  4. the engine at full width (RoBERTa-base, CLIP ViT-B/32,
     EfficientNet-B0; seeded random weights, bf16, quant="auto" →
     int8_ffn) with a 2,176-row vault: one analyze() and one mixed
     analyze_batch(), the kernel's launch count per program, the same
     batch with the plain FFN swapped in (scores within 0.05), then the
     single-request latency and b32/S512 verdicts/s, with the kernel and
     with the plain FFN (printed only);
  5. the decode-step kernels K6 (self-attention) and K7 (cross-attention +
     FFN), each with bf16 and with int8 weights, against their plain
     versions at whisper-base shapes (B = 1, 4 and 32; pos = 3 and 447;
     T = 1,500) through misinfo_tpu_torch/ops/decode_checks.py: within
     2^-5·max|y − x| plus one bf16 step per residual rounding (the
     kernels sum in another order than cuBLAS), with keys planted so that
     emulated wrong kernels (rows, one of K6's cache-row chunks or one of
     K7's T chunks left out, the mask one row off) fall outside that
     band, which the check also requires; then at B = 1, 4, 32, K6 at
     pos 32, 224 and 447 and the others at pos 447 / T = 1,500, each
     kernel's CUDA-event ms per call over back-to-back calls, its device
     µs per call (CUDA-event time with the host out of the way: the calls
     enqueued behind a sleeping kernel), the device µs of each of its
     CUDA kernels (torch.profiler, the same head start) and its
     __global__ launches per call by the library's own count (K6 2 with
     its o product folded into the attention launch, at B = 1 and 4, else
     3; K7 5, K8 5, K9 1);
  6. the Whisper transcriber at whisper-base widths (byte tokenizer,
     seeded weights through the JAX-layout bridge, device="cuda"):
     pallas on and quant="kernels" (K6/K7 int8 bodies, the temperature
     ladder's first two rungs: greedy, then best_of 2 at T = 0.2, 3
     decodes; phases 26-29 repeat that config), then quant="embedding"
     (the bf16 bodies, the ladder cut to its greedy rung); each
     transcribes a 20 s
     two-tone-plus-noise WAV (wall time printed), and K6 and K7 must each
     launch once per decoder layer per fused decode step, every launch
     with the weight type of that transcriber's body; then
     WhisperConfig.tiny()'s widths (heads of 16) under the default decode
     config: no fused step (its kernels take heads of 64), no K6/K7
     launch, the transcript and two windows' tokens those of pallas="off"
     on the same int8 weights;
  7. a teacher-forced comparison: the greedy tokens fed through the step
     with the kernels and with their plain versions, per-step logits
     within TF_BAND (argmax agreement printed: with random weights
     near-ties make free-running token equality a coin toss);
  8. merge_into_caption → engine.analyze(merged caption, image), report
     checked; then the encoder's time for one 30 s window and decode ms
     per step with the kernels and with the plain versions (printed
     only);
  9. the int4 vault similarity kernels K10a (bf16 query) and K10b (int8
     query) against their plain versions at 1,048,576 rows × 512 (B = 1,
     8, 32) and at a ragged row count (B = 3) through
     misinfo_tpu_torch/vault/int4_checks.py: K10b bit for bit, K10a within
     (D + 1)·2^-23·Σ|q·nib|·scale with planted faults (a tile, one
     consumer warp's rows, the last slice's high nibbles or the ragged
     edge left out, nibbles swapped or read unsigned, the scale dropped)
     outside that band; CUDA-event times, kernel and plain, and the
     kernels' share of 3.35 TB/s;
 10. the engine at full width with vault_dtype="int4" and a 262,144-row
     vault (seeded random rows; the CLIP image embeddings of six requests
     planted with noise at known rows, the captions' text embeddings as
     their title rows; weights seeded, vision class and position
     embeddings zeroed so that images differ): the first boot quantizes
     and writes <vault>.int4.npz, the second (with CUDA graphs, for phase
     26) loads it (re-quantizing fails the run); on the first, one analyze() and an analyze_batch() of 32 — planted
     requests at top-1 with their title and the gate open, the others at
     0, K10b launched once per visual program; then one video_text
     group of 16 videos × 12 frames (the engine's frame sampler replaced
     by the pool's images; video 0's third frame planted): one program,
     K10b launched 3 times (192 query rows in slices of 64), video 0 at
     its planted row with the gate open, the others shut;
 11. the same vault with vault_dtype float32 (the reference: same top-1,
     sims within 0.05 for the planted requests; the video group's video 0
     at the same top-1), bfloat16 and int8;
     memory_report() and vault_search ms at B = 32 of each (printed);
 12. vault_ivf=True over the f32 vault: the index built on the card
     (time printed) and an analyze_batch that finds every planted row;
 13. reload_vault(drop_first=True) onto the vault with 4,096 rows
     appended, one of them planted: the new row is found;
 14. an int4 engine over phase 4's 2,176-row vault (below 65,536 rows the
     dispatcher runs K10a): K10a launched once per visual program;
 15. (after phase 3) the detector's opt-in kernels against their plain
     versions at the main path's b32/S512 shapes, bf16 and f32, through
     misinfo_tpu_torch/ops/kernel_checks.py: K2 (int8 dense) bit for bit,
     K3 (fused attention), K4 (LayerNorm, driven once on its own: no model
     calls it; also at D = 512, 1,024, 1,280 and at 1,000 and 1,001, its
     general loop) and K5 (fused FFN; also at the Whisper tiny, medium and
     large decode widths) within that module's bands with its planted
     faults outside; CUDA-event times at the RoBERTa shape, with
     the bound and, for K3 and K4, scaled_dot_product_attention and
     layer_norm as the library's time; K3 also timed beside SDPA and its
     plain version at the CLIP text (causal, S = 77) and vision (S = 50)
     shapes; K4 also as medians of per-call times, cold L2, interleaved
     with F.layer_norm on bf16 copies of scale and bias and on the f32
     ones;
 16. (after phase 4) engine I at full width, quant="int8" and
     use_pallas=True (phase 4's weights, vault and b32 requests): one
     analyze() and the b32/S512 batch with exact K2/K1/K3 launch counts
     (144/36/36 for the batch), scores within 0.05 of the plain versions,
     verdicts/s beside the default engine's, params bytes, which must
     equal the bytes of the storages the tree holds (the K-major int8
     kernels stored once) with every int8 kernel's transpose contiguous;
 17. engine II likewise with use_pallas="ffn": K5 36 times per batch;
 18. (after phase 8) one whisper-base greedy decode_transcript(
     pallas_ffn=True) with bf16 weights and the fused steps off: K5 once
     per decoder layer per step, tokens equal to the plain version's,
     teacher-forced logits within FFN_TF_BAND;
 19. (after phase 5) K8, the cross-attention + FFN step over int8 cross
     planes, against its plain version at whisper-base shapes, T = 1,500:
     B = 1 and 4 (V tiles of 512 rows), 8 (256, t_actual 1,400) and 32
     (128), and B = 3 at T = 300, t_actual 280 (one ragged tile), through
     decode_checks.py: within the bf16-plane band plus one level of every
     quantized probability that sits at a rounding boundary, with planted
     faults outside (V scales applied after the quantization, K scales
     dropped, the probabilities' scale per head, tiles of half the size,
     a score chunk or a V piece left out, one chunk left out of the
     softmax's (m, l) merge, each piece's scale over its own rows, a piece
     left out of its tile's s32 sum, the mask one row off); and B = 4 and
     3 again with the last attended row a loud V row, so that the
     kernel's V piece holding it is planted (left out, left out of its
     tile's sum);
 20. K9, the whole-layer step in one cooperative launch, at B = 1, 4, 32
     and pos = 0, 447, and at B = 4, pos 200 (chunks of unequal length):
     output and both caches torch.equal to K6b followed
     by K7b on clones of the same inputs, inside the band of its plain
     version with the faults of both steps outside, and exactly one
     __global__ launch per call by the library's own count;
 21. (after phase 8) whisper-base greedy decode_transcript with int8
     weights and the two fused steps, on bf16 cross planes and with
     cross_int8=True: K8 launched once per decoder layer per step, K7
     never, K6b once per layer per step; teacher-forced logits of the
     kernels and the plain versions within I8CC_TF_BAND; ms per step of
     both decodes;
 22. the same decode with pallas_layer=True: K9 once per layer per step
     (and as many __global__ launches), K6 and K7 never; tokens,
     avg_logprob and the no-speech probability equal to phase 21's
     bf16-plane decode; ms per step of both;
 23. WhisperTranscriber(quant="int8") (the int8 streaming decode: plain
     PyTorch, no decode kernel) on the 20 s WAV with the ladder cut to its
     greedy rung: int8 token embedding, every kernel count unchanged, the
     position-0 logits within 0.06·max|logit| of the unquantized step;
     wall time and ms per step;
 24. (after phase 4) the engine's other entry points on phase 4's engine:
     analyze_batch_async(...)() and analyze_stream over the mixed batch
     equal analyze_batch (every score, in order); analyze_text,
     analyze_image, analyze_consistency, search_vault and fusion_verdict
     answer once each; the host prep of the b32 batch's 32 images (and of
     32 photo-sized ones where cv2 or PIL is installed) with the engine's
     thread pool and with a serial map swapped in (printed only);
 25. (after phase 4) video on phase 4's engine: four 12 s clips at 25 fps,
     640 × 360, written with cv2 and decoded by the engine's sampler (or,
     without cv2 or an mp4 encoder, the sampler replaced by seeded frames;
     the route is printed); a whisper-base transcriber (seeded weights,
     the ladder cut to its greedy rung) transcribes a 12 s WAV with K6/K7
     counted once per layer per step, merge_into_caption must give
     caption + blank line + that transcript; analyze(merged caption,
     clip) launches K1 36 times and analyze(clip) 12 times; a group of 16
     video_text requests (192 frames) one program, K1 36 times, scores
     within 0.05 of the plain FFN's, verdicts and top-1 rows printed; the
     same group with serving.device_resize; device_resize_pair on the
     card against its CPU result on one clip's staged frames (224 × 224
     and zero frames equal, the rest within one level on at most
     ops/resize.py's TIE_SHARE of the pixels); printed: videos/s and host
     prep ms per frame of both routes, the device ms of one V = 16
     program, the largest score difference between the routes.
 26. (after phase 24) CUDA graphs: a default engine (every signature a
     captured graph) beside phase 4's, which runs eagerly
     (cuda_graphs=False, as every engine and transcriber of the other
     phases does, so that their spies and swapped plain versions stay in
     the path): the default warmup()'s signatures, wall seconds and the
     graph pool's bytes, then the b32 full signatures; the b32/S512
     batch, one analyze, the mixed batch and phase 25's group of 16
     video_text requests replayed in the reverse of their capture order
     under torch.cuda's sync debug mode "error", their packed outputs
     torch.equal to the eager engine's and K1's launches per replay equal
     to eager's (36 / 36 / 60 / 36); single-analyze ms, b32 verdicts/s,
     videos/s of the group and the b32 batch's device idle share, eager
     against graphs in turns; reload_vault onto phase 4's vault
     (the warmed signatures re-captured) and the b32 batch torch.equal to
     eager again. The transcriber (after phase 6): warmup((1,)) on a
     default whisper-base transcriber with phase 6's weights and decode
     config, transcribe() of the 20 s clip with the same text as phase 6's
     eager transcriber (wall seconds beside phase 6's), the encoder and a
     greedy and a sampled (T = 0.2) decode torch.equal, greedy ms per step
     in turns.
     The int4 engine (after phase 10's video group): phase 10's second
     boot (CUDA graphs) warmed, the batch of 32 and the video_text group
     replayed under "error", torch.equal to phase 10's eager engine, K10b
     2 and 3 launches per replay;
 27. (after phase 26) the entry points on reference checkpoints, at full
     width: a seeded tree written through the port's
     export_reference_state_dicts and torch.save as the monolithic
     forensics_master_final.pth + clip_detective_best.pth and, in a second
     directory, as the per-branch files; MisinfoForensics booted from each
     (boot seconds printed) with load_report mode monolithic / individual,
     every written leaf applied, none skipped, and analyze_batch of the
     mixed batch equal, float for float, to an engine given the same tree
     as params (a tree of another seed changes it); serve.cli.main with
     --batch-file (the mixed batch as JSONL) and --output run beside the
     monolithic files, its JSON equal to analyze_stream on the booted
     engine; the API (serve(ForensicsAPI(engine), port=0) on 127.0.0.1,
     the engine warmed as CUDA graphs): /healthz names the card and the
     checkpoint mode, /metrics carries verdicts_per_sec, memory and
     host_prep, 64 full requests (text + base64 image) from 8 client
     threads to /analyze with one /analyze_batch and one /predict, every
     verdict equal to the engine's own report for that request, K1's
     ffn_up_kernel records (torch.profiler) over the API calls equal to
     PER_PROGRAM × the programs the batcher dispatched; requests/s and
     p50/p95 latency printed. (After phase 26's transcriber) phase 6's
     whisper-base tree as an HF-layout .pt through
     WhisperTranscriber(checkpoint_dir=...): has_weights, the same config,
     greedy tokens torch.equal to the tree's transcriber, transcribe() of
     the 20 s clip with phase 6's text and K6/K7 counts, merge_into_caption
     → analyze;
 28. (after phase 27) the trainers (misinfo_tpu_torch/train/): one f32
     text step (RoBERTa-base + both heads, B = 2, S = 128, dropout 0) on
     the card and on the CPU from one tree and batch: losses within 1e-4
     relative, gradient norms within 1e-3, each leaf's gradient within
     1e-3 of its largest (the attention key biases, whose exact gradient
     is zero, below 1e-5 of the largest on both); then in bf16 at full
     width on generated rows, each with its step ms (median after the
     first two), tokens/s or images/s, peak memory, first and last loss
     and checkpoint save/load seconds: roberta_detective (200 CSV rows,
     B = 16, 256 tokens, one epoch; its FLOPs and share of the bf16
     peak), cifake_efficientnet and clip_detective (160 seeded 224² PNGs,
     B = 32; the CLIP trainer's frozen leaves torch.equal to their start)
     and fusion_judge (precompute_scores of 64 rows through phase 4's
     engine, K1 launches and ffn_up_kernel records = 36 × its programs,
     then 10 epochs; the engine's tree untouched); the RoBERTa trainer's
     directory boots an engine (load_report native, the text branch
     torch.equal to the trained tree, one analyze) and the CLI with
     --checkpoint (its JSON equal to that engine's analyze). (After phase
     27's transcriber) its HF .pt through checkpoints/convert.py
     --whisper: the directory's transcriber has phase 6's config and
     greedy tokens torch.equal to phase 6's;
 29. (after phase 28) (a) serving's QKV fuse: K2 at the fused widths
     (N = 3D: RoBERTa and CLIP vision 768 → 2,304, CLIP text 512 →
     1,536, b32 rows) bit for bit its plain version and the three unfused
     launches, with CUDA-event ms, device µs (fused and the three unfused
     launches), the plain version, torch._int_mm of the product and the
     bound; phase 4's seeded tree fused and not in quant="int8" engines:
     the mixed batch's and the b32 batch's reports equal (==), K2 72
     launches per full program against 144, K1 36; with use_pallas=True
     K3 36 in both and the scores within 2e-2; a fused int8_ffn engine
     against phase 4's within 2e-2, K1 36; b32 verdicts/s fused against
     unfused in turns (printed only). (c) the data path: a generated
     archive of 600 pages (og tags to seeded 224² PNGs; some pages with
     only <h1>/<img>, a broken image or no title) through
     train/guardian_prep.main (15 workers): the article count for the bs4
     or regex branch, the 80/20 article-level CSVs with one matched and
     one mismatched pair per article, vector_db_seed.json;
     clip_detective.build_vault on the card; an engine on that vault
     ranking an article's own title and image first with the gate open;
     data_prep.prepare_fusion_dataset with generated HC3 and WELFake CSVs;
     fusion_judge.train through that engine (K1 36 × the sweep's
     programs, the engine's tree untouched); harmonize_datasets on a
     generated CIFAKE tree and Fakeddit TSV; rows/s of each step and the
     build's images/s. (b) (after phase 26's transcriber) transcribe() of
     the 20 s clip with MISINFO_TPU_TRANSCRIPT_ISOLATION=0, then 1 twice:
     phase 6's text each time, one pool reused, the worker a spawned
     process with niceness 10 above this one and no CUDA context; the host
     prep's ms inline and in the worker;
 30. serving over a device mesh (core/mesh.py), the one card named once
     per grid position: (a) (after phase 29) make_mesh() → data=1 serves
     the b32 batch with reports == the engine without a mesh (quant
     "none" in both, CUDA graphs in both), and data=2 serves it through
     one CUDA graph per data position with reports == the same mesh run
     eagerly; (d) data=1 × model=2 in f32 parity mode, scores within 1e-3
     of the single-device f32 engine, and quant="int8" within 0.01 of the
     single-device int8 engine, every split product through K2 (K1 not
     launched), K2 held against its plain version on the first input of
     each of the run's shapes (the row-split ones at K + 64) with max abs
     error 0, and the batch's reports == those with K2's plain version in
     its place; (f) the CLI with --mesh data=1 (the engine and
     the transcriber get the mesh) and --mesh data=2 refused by
     make_mesh; (b) (in phase 11) data=2 over phase 10's 262,144-row
     f32 vault row-sharded (vault_shard_min_rows below its rows): an
     analyze_batch of 32 == the replicated mesh engine's, and a
     vault_search at B = 32 torch.equal to vault_search_sharded's; (c) the
     same in int4, K10b launched once per shard per vault program and
     each shard's K10b torch.equal to its plain version; (e) (after phase
     6) a 60 s clip's two windows transcribed under data=2 and without a
     mesh at the full 448 decoder positions, the ladder's decodes (the
     greedy rung, one sampled draw at t 0.2) recorded call by call: each
     decode's tokens torch.equal, or else each position's torch.equal to
     the witness, its windows decoded without a mesh (batch 1, as the
     position decodes them) on the same noise, which shows a difference
     to be the batch size's rounding and not the mesh's; every position
     drawing the unsplit decode's noise; transcribe() texts equal; sharded and replicated vault_search ms and
     verdicts/s of every mesh engine beside the unsharded ones;
 31. training over a device mesh (after phase 30 (a, d, f)): (a) in one
     process over grids naming the card more than once, each step held
     to the single-card step from the same tree and batch: the f32 text
     step (RoBERTa-base, B 4 × 64, dropout off) under data=2 and
     data=1,model=2, loss and every gradient within 1e-5; in bf16 at full
     size the RoBERTa detective step (B 16 × 256) under both, the CLIP
     and EfficientNet-B0 steps (B 32) under data=2, make_full_step under
     data=2,model=2: first loss within 1e-2 relative and the gradients'
     global norm within 5e-2, replicas bit for bit after the steps, step
     ms and peak memory beside the single card's; (b) the CLIP trainer's
     own CLI with --mesh data=2 in two processes on the card
     (init_multihost's JAX_* env path, gloo), which gloo collectives take
     CUDA tensors, the ranks' trees torch.equal, the trained leaves
     within 1e-6 of the same training in one process over the card named
     twice, one checkpoint directory written by rank 0 alone, the engine
     booted from it; (c) --mesh data=2 in one process refused ("mesh 2x1
     != 1 devices"); (d) the RoBERTa detective's own CLI at full width
     (RoBERTa-base, bf16, its recipe) with --mesh data=1,model=2 in two
     processes on the card over gloo, the model group across them: two
     steps of B 16 × 256 and an eval, held to the same training in one
     process over the card named twice: the ranks' trees torch.equal,
     the history's losses within 1e-2 relative, every trained leaf within
     2.1 × the steps' summed learning rate (AdamW moves an element by at
     most about its learning rate a step, so a bf16 rounding apart in a
     gradient moves it by no more), every frozen leaf torch.equal, one
     checkpoint written by rank 0 alone; step ms per rank, the exchanges
     and bytes a step, peak memory. ``--only 31`` runs phase 31 alone;
 32. (after phases 16-17) use_pallas="flash": (a) K11 (flash attention
     over segment ids, csrc/flash_attention.cu) against its plain version
     through ops/kernel_checks.py::check_flash, bf16 and f32, at RoBERTa
     b32/S512 (H = 12, D = 64) on packed rows (ragged requests and a
     padding tail), the padded form and packed causal rows, at S = 128
     (one key tile, JAX's single-step form), B = 8 at S = 2,048 and B = 3
     at S = 384 with H = 5, packed and causal (a unit count that is no
     multiple of the SMs, odd heads): within
     the band of the roundings of acc ± its error bound, with planted
     faults (each key tile left out, the einsum path's kv_seg > 0 rule,
     the alpha rescale dropped, p rounded on the other side of 1/l, the
     causal mask one column late, sm_scale dropped) outside; CUDA-event
     ms and device µs at b32/S512 packed and padded and at S = 2,048
     beside the bound, its plain version and scaled_dot_product_attention
     with the equivalent boolean mask; (b) engine III,
     MisinfoForensics(use_pallas="flash") at full width with quant "auto"
     (K1 on the FFNs) and phase 4's seeded weights and vault: one
     analyze() of a 300-word request, the b32/S512 batch (dense rows) and
     a ragged b32 batch with pack_text=True, each launching K11 12, K3 24
     (CLIP's text and vision, JAX's fall-through below 128 tokens) and K1
     36 times; the batches' scores within 0.05 of K11's plain version and
     of the default engine, verdicts printed; a CUDA-graph engine III
     warmed for the b32 signature, both batches replayed under sync debug
     "error" bit for bit the eager engine's, K11 12 per replay; b32
     verdicts/s beside the default engine's (printed); DetectorConfig.
     tiny() (heads of 16 and 24) under use_pallas=True with int8 and
     "flash": no K3 or K11 launch, scores within 1e-4 of the einsum
     engine's. ``--only 32`` runs phase 32 alone;
 33. (after phase 32) gradients through use_pallas="flash": (a) K11-bwd
     (csrc/flash_attention_bwd.cu: the dK/dV and the dQ kernel) against
     its plain version through ops/kernel_checks.py::check_flash_bwd,
     bf16 and f32, fed the plain forward's residuals, at the training
     step's rows (B 16 × S 256 × H 12 packed), RoBERTa b32/S512 packed,
     padded (its last row all padding) and packed causal, S = 128 and B 3
     × S 384 × H 5 packed causal: within the band of the roundings of
     each f32 sum ± its error bound, with planted faults (each query tile
     left out of dK/dV, each seen key tile out of dQ, di left out, p not
     rounded before dV, sm_scale dropped from ds, the causal mask one
     column late, the einsum path's kv_seg > 0 rule, l from the row
     before) outside; K11's residuals l and m within their band; then
     each kernel's CUDA-event ms and device µs at the training shape, at
     b32/S512 packed and padded and at B 8 × S 2,048 packed beside its
     bound, its plain version and the backward of
     scaled_dot_product_attention, and K11 with and
     without residuals; (b) RoBERTa-base with seeded weights, the packed
     text-head loss (roberta_encode(use_pallas="flash") → CLS slots →
     head_apply → weighted_cross_entropy) on train/datasets.py's
     packed_batches(n_rows=16, n_slots=64) of 256 tokens: step one's
     gradients against the same step with K11's and K11-bwd's plain
     versions swapped in, f32 leaf by leaf within 1e-3 of each leaf's
     largest and bf16 within 2^-4 of the largest gradient; three bf16
     AdamW steps launching K11, dK/dV and dQ 12 times each a step, their
     losses within 1e-2 of the einsum path's, step ms of both. ``--only
     33`` runs phase 33 alone;
 34. (last) the host residue of analyze()'s path: (a) RoBERTa-form BPE
     assets from a seed (seeded_bpe_assets: 50,265 ids, 50,004 merges);
     (b) the native C++ encoder (csrc/bpe_encoder.cpp, built by g++ in
     phase 2) against the Python one on phase 4's b32 texts and on corpus
     texts of that shape, four rows of each with non-ASCII text, at S
     512: ids and masks equal, host ms a batch fresh and again; (c) an
     engine at full width on those assets: its tokenizer the native one,
     the b32 reports equal to the same engine's on the Python encoder,
     eager verdicts/s of both; (d) probe_link() and auto_policy() on the
     card, from_env under MISINFO_TPU_HOST_POLICY=auto applying that
     decision and an explicit MISINFO_TPU_DEVICE_RESIZE=0 winning,
     host_prep_report()'s link; (e) profile_trace around one analyze()
     writes a trace naming K1's ffn_up_kernel, nan_guard raises on a NaN
     made on the card and is silent outside. ``--only 34`` runs it alone;
``--times`` prints only the redesigned kernels' times (K3 at its three
shapes beside SDPA and its plain version; K4's interleaved medians; K6 at
pos 32, 224 and 447, K7, K8 and K9 at B = 1, 4, 32, with each CUDA
kernel's device µs; K1 and K2 at the b32/S512 shapes and one request's
(K1 also at a V = 16 video program's CLIP vision shape, M = 9,600),
beside torch._int_mm of the same integer products; K5 at the towers'
b32/S512 shapes, one RoBERTa request and Whisper decode rows beside
cuBLAS's two bf16 products; K10a/K10b at 1,048,576 rows for B = 1, 8, 32,
64 beside torch._int_mm over unpacked rows; K11 at b32/S512 packed and
padded and at S = 2,048 beside SDPA; K11-bwd's two kernels at the
training shape, b32/S512 packed and padded and B 8 × S 2,048 packed
beside SDPA's backward;
``--kernels`` picks among attention, layer_norm, decode, i8cc_layer,
int8, ffn, int4, flash and flash_bwd, where
i8cc_layer times K8 and K9 alone at B = 1, 4, 32, K9's rows with the
device µs of the two calls it replaces, K6b → K7b, on the same inputs)
as JSON lines, with
whatever misinfo_tpu_torch is first on sys.path: run from another tree's
root with ``python -c "import runpy, sys; sys.argv = ['chip_smoke.py',
'--times']; runpy.run_path(PATH, run_name='__main__')"`` it times that
tree's kernels. ``--parent DIR``
also times the K4, K11 and K11-bwd sources of the tree at DIR,
interleaved with this tree's.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors, times and bounds. ``--profile FILE``
also writes torch.profiler tables of the b32 batch (default engine and
engines I and II) and of one greedy transcript decode to FILE.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import wave
from unittest import mock

import numpy as np
import torch

SHAPES = (("roberta", 3 * 512, 768, 3072, "tanh"),
          ("clip_text", 3 * 77, 512, 2048, "quick"),
          ("clip_vision", 3 * 50, 768, 3072, "quick"),
          ("roberta_b32", 32 * 512, 768, 3072, "tanh"),
          ("clip_vision_video", 16 * 12 * 50, 768, 3072, "quick"))
REPORT_KEYS = {"verdict", "verdict_text", "confidence", "scores",
               "vault_matches", "explanation"}
SCORE_KEYS = {"ai_score", "misinfo_score", "deepfake_score",
              "clip_similarity", "vault_discrepancy", "text_similarity",
              "verdict", "confidence", "fake_probability",
              "real_probability"}
PER_PROGRAM = {"full": 36, "text_only": 12, "visual_only": 12,
               "video": 12, "video_text": 36}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SLEEP_CYCLES = 20_000_000      # ~10 ms of the card's clock: the host's head start


def device_us(fn, calls: int = 50):
    """(device µs per call, CUDA kernels per call) of ``fn``. Device time:
    CUDA events around ``calls`` calls enqueued behind a sleeping kernel,
    so that the card runs them back to back without waiting for the host
    (kernels of a call that start early and overlap count once); None if
    the host took longer to enqueue them than the card slept. Kernels per
    call: torch.profiler's CUDA kernel events over five calls (copies and
    fills not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    t0 = time.perf_counter()
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    us = (start.elapsed_time(end) / calls * 1e3
          if host_ms < slept.elapsed_time(start) else None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    kernels = sum(e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset"))
                  for e in prof.events())
    return us, kernels / 5


def _kernel_label(name: str) -> str:
    """A CUDA kernel's name as the profiler gives it, without its return
    type, namespaces and parameter list."""
    name = name.replace("(anonymous namespace)::", "").replace("dec::", "")
    return name.removeprefix("void ").split("(")[0][:60]


def kernel_split_us(fn, calls: int = 30):
    """Device µs per call of each CUDA kernel of ``fn``, by kernel: the
    profiler's kernel intervals over ``calls`` calls queued behind a
    sleeping kernel (the host kept ahead of the card), each kernel charged
    from the later of its start and the end of the kernel before it to
    its end, so that a kernel launched early is not charged its wait and
    the parts add up to the union of the intervals. The profiler loses
    kernel records now and then on the card's machine, so a kernel is
    charged only where the record before it is that of the kernel that
    precedes it in most calls, and each part is the median over those
    charges. The profiler slows the host's launches, so where the host
    took longer to enqueue the calls than the card slept, the sleep is
    made four times longer and the calls profiled again (twice at most).
    None if the host still took longer, or no part could be charged."""
    from collections import Counter
    from statistics import median
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for cycles in (SLEEP_CYCLES, 4 * SLEEP_CYCLES, 16 * SLEEP_CYCLES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            torch.cuda._sleep(cycles)
            for _ in range(calls):
                fn()
            host_us = (time.perf_counter() - t0) * 1e6
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and not e.name.startswith(("Memcpy", "Memset")))
        spin = ([e for e in events if "spin" in e[2]]
                or [e for e in events if e[1] - e[0] > 2000])   # the sleep
        if spin and host_us <= spin[0][1] - spin[0][0]:
            break
    else:
        return None
    after = [(a, b, _kernel_label(n)) for a, b, n in events
             if a >= spin[0][0] and (a, b, n) != spin[0]]
    pairs = Counter((p[2], e[2]) for p, e in zip(after, after[1:]))
    before = {}
    for (p, e), k in pairs.most_common():
        before.setdefault(e, p)
    charged = {}
    for p, e in zip(after, after[1:]):
        if before.get(e[2]) == p[2]:
            charged.setdefault(e[2], []).append(e[1] - max(e[0], p[1]))
    return {k: median(v) for k, v in charged.items()} or None


def append_profile(path: str, title: str, fn, rows: int = 30) -> None:
    """Append torch.profiler's table of one call of fn to path."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with open(path, "a") as f:
        f.write(f"\n\n# {title}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=rows))


def check_kernel(card):
    """Phase 3: K1 against its plain version on the card at the main
    path's shapes (ops/kernel_checks.py: within 3 int8 levels, with the
    planted faults outside), bit for bit on the integer grid at M = 37
    (the split form) and M = 16,384 (one block per output tile), and
    CUDA-event times beside the bound and the integer products' yardstick
    (torch._int_mm, which the port never calls)."""
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops import kernel_checks as KC
    rows = {}
    for name, M, K, N, mode in SHAPES:
        c = KC.int8_ffn_case(M, K, N, mode)
        res = KC.check_int8_ffn(c)
        torch.cuda.synchronize()
        _report(f"K1 {name} M={M} K={K} N={N} {mode}", res, card)
        a = c["args"]
        rows[name] = {"err": res["err"], **_timed(
            f"K1 {name}", lambda: K1.int8_ffn(*a, mode=mode),
            lambda: K1.int8_ffn_plain(*a, mode=mode), None,
            *ffn_work(M, K, N), "int8", card)}
        print(f"K1 {name} yardstick: torch._int_mm of the two products "
              f"{int_mm_ms(M, K, N) + int_mm_ms(M, N, K)} ms [{card}]",
              flush=True)
    for M in (37, 32 * 512):
        _report(f"K1 integer grid M={M} K=768 N=3072 (bit for bit)",
                KC.check_int8_ffn(KC.int8_ffn_case(M, 768, 3072, "tanh",
                                                   grid=True)), card)
    return rows


def ffn_work(M: int, K: int, N: int):
    """(bytes, operations) of one int8 FFN call: x and out bf16, both
    int8 weights, four f32 vectors once; 2·M·N·2K int8 operations."""
    return M * K * 2 * 2 + 2 * K * N + 4 * (2 * N + 2 * K), 2 * M * N * 2 * K


def int_mm_ms(M: int, K: int, N: int, reps: int = 20) -> float:
    """torch._int_mm of an s8 [M, K] by a K-major s8 [K, N] (the integer
    product alone, as cuBLAS computes it): the yardstick of K1's and K2's
    products."""
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda")
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device="cuda").t()
    return cuda_ms(lambda: torch._int_mm(a, b), reps)


def make_vault(path: str, n: int = 2176, d: int = 512) -> None:
    from misinfo_tpu_torch.vault.store import TruthVault
    rng = np.random.default_rng(1)
    TruthVault(rng.normal(size=(n, d)).astype(np.float32),
               [{"title": f"Guardian article {i}", "url": f"u{i}",
                 "date": "2024-01-01"} for i in range(n)],
               rng.normal(size=(n, d)).astype(np.float32)).save(path)


def check_reports(reports, what: str) -> None:
    for r in reports:
        if set(r) != REPORT_KEYS or set(r["scores"]) != SCORE_KEYS:
            raise AssertionError(f"{what}: report keys {sorted(r)}")
        for k, v in r["scores"].items():
            if not math.isfinite(v):
                raise AssertionError(f"{what}: {k} = {v}")
        for k in ("ai_score", "misinfo_score", "deepfake_score",
                  "fake_probability", "real_probability", "confidence"):
            if not 0.0 <= r["scores"][k] <= 1.0:
                raise AssertionError(f"{what}: {k} = {r['scores'][k]}")
        if not -1.0 - 1e-5 <= r["scores"]["clip_similarity"] <= 1.0 + 1e-5:
            raise AssertionError(f"{what}: clip_similarity out of range")


def verdicts_per_s(engine, requests, reps: int = 3) -> float:
    engine.analyze_batch(requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.analyze_batch(requests)
    torch.cuda.synchronize()
    return reps * len(requests) / (time.perf_counter() - t0)


def words(rng, n: int) -> str:
    return " ".join(f"w{int(i)}" for i in rng.integers(0, 10_000, n))


# ---------------------------------------------------------------- transcript

WB = dict(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8,
          ffn_dim=2048, max_source_positions=1500, max_target_positions=448)
# phase 7: |Δlogit| allowed between the kernels' and the plain versions'
# teacher-forced decode, three times the largest measured on an H100
# (0.045, against a logit range of 3.4)
TF_BAND = 0.135
# phase 18: the same for K5 in the unfused step, three times the largest
# measured on an H100 (0.0131)
FFN_TF_BAND = 0.04
# phase 21: the same for K6b + K8 over int8 cross planes (0.0412)
I8CC_TF_BAND = 0.125
# phase 23: |Δlogit| / max|logit| allowed between the int8 streaming step
# and the unquantized step at position 0 (the JAX package's own bar)
STREAM_BAND = 0.06


def build_all(builds) -> None:
    """Phase 2: one nvcc per kernel source, all started together, and g++
    on the BPE encoder beside them. builds: (module, the name of its build
    function, the name of its build log or None)."""
    def one(b):
        t0 = time.perf_counter()
        getattr(b[0], b[1])()
        return time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        secs = list(pool.map(one, builds))
    for (m, fn, log), sec in zip(builds, secs):
        print(f"build {m.__name__}.{fn}: {sec:.2f} s", flush=True)
        if log:
            print("\n".join(line for line in getattr(m, log).splitlines()
                            if "registers" in line or "spill" in line))


def check_decode_kernels(K6, K7):
    """Phase 5: the four decode-step bodies against their plain versions
    at whisper-base shapes; returns {body: {err, ms, plain_ms}} at B = 4
    (pos 447) and prints every case."""
    from misinfo_tpu_torch.ops import decode_checks as DC
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        for B in (1, 4, 32):
            cases = [("self_attn_step", f"pos={pos}",
                      lambda c: DC.check_self_attn(c, sms),
                      DC.self_attn_case(B, pos, int8)) for pos in (3, 447)]
            cases.append(("cross_ffn_step", "T=1500",
                          lambda c: DC.check_cross_ffn(c, sms),
                          DC.cross_ffn_case(B, 1500, int8)))
            for name, where, check, case in cases:
                res = check(case)           # raises if out of band
                torch.cuda.synchronize()
                fn, plain = ((K6.fused_self_attn_step, K6.self_attn_step_plain)
                             if name == "self_attn_step" else
                             (K7.fused_cross_ffn_step, K7.cross_ffn_step_plain))
                args, H = case["args"], case["n_heads"]
                ms = cuda_ms(lambda: fn(*args, n_heads=H), 50)
                plain_ms = cuda_ms(lambda: plain(*args, n_heads=H), 10)
                print(f"{name}{sfx} B={B} {where}: max_abs_err={res['err']} "
                      f"(band up to {res['band']}; {res['faults']} planted "
                      f"faults, nearest at {res['nearest_fault']:.2f} bands) "
                      f"kernel_ms={ms} plain_ms={plain_ms}", flush=True)
                if B == 4 and where != "pos=3":
                    rows[name + sfx] = {"err": res["err"], "ms": ms,
                                        "plain_ms": plain_ms,
                                        **decode_bound(name, case, int8)}
    return rows


def decode_work(name, case, scales=()):
    """(bytes moved, operations) of one decode-step body: each input read
    once (the weights, the attended cache rows and, over int8 planes,
    their ``scales``), the output written once; 2 operations per weight
    per row and 4·D per attended cache row."""
    args = case["args"]
    x = args[0]
    B, D = x.shape
    tensors = [t for a in args for t in (a.values() if isinstance(a, dict)
                                         else [a])
               if isinstance(t, torch.Tensor)]
    weights = sum(t.numel() for t in tensors if t.dim() == 2 and t is not x)
    caches = [t for t in tensors if t.dim() == 3]
    rows = args[-1] + (1 if name == "self_attn_step" else 0)
    moved = (nbytes(*[t for t in tensors if t.dim() < 3]) + nbytes(x)
             + sum(B * rows * D * c.element_size() for c in caches)
             + sum(B * rows * s.element_size() for s in scales))
    return moved, 2 * B * weights + 4 * B * rows * D


def decode_bound(name, case, int8: bool, scales=()):
    """bound_ms of one decode-step body from ``decode_work``."""
    return bound(*decode_work(name, case, scales), "int8" if int8 else "bf16")


# __global__ launches per call of each decode-step library; the
# self-attention step's where its o product is folded into the attention
# launch (decode_checks.self_split), one more where it is not
GLOBAL_LAUNCHES = {"self_attn_step": 2, "cross_ffn_step": 5,
                   "cross_ffn_step_i8cc": 5, "layer_step": 1}


def global_launches(lib: str, B: int, pos: int, int8: bool) -> int:
    """The exact __global__ launches per call of ``lib`` at whisper-base."""
    if lib != "self_attn_step":
        return GLOBAL_LAUNCHES[lib]
    from misinfo_tpu_torch.ops import decode_checks as DC
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fold = DC.self_split(B, 8, pos, sms, 1 if int8 else 2)[2]
    return GLOBAL_LAUNCHES[lib] + (0 if fold else 1)


SELF_POSITIONS = (32, 224, 447)   # where K6 is timed


def decode_step_times(card, batches=(1, 4, 32), reps=200, strict=True,
                      only_i8cc_layer=False):
    """Phase 5's timing half (and ``--times``): K6 with both weight types
    at pos 32, 224 and 447, K7 with both, K8 and K9 at pos 447 / T =
    1,500 (``only_i8cc_layer``: K8 and K9 alone, K9's row with the device
    µs of the two-call route K6b → K7b that it replaces, on the same
    inputs), for each B: CUDA-event ms per call over ``reps`` back-to-back
    calls (host-bound where the host takes longer to enqueue a call than
    the card to run it), device µs per call and CUDA kernels per call
    (``device_us``), device µs per call of each kernel
    (``kernel_split_us``), __global__ launches per call by the library's
    own count where it keeps one, a digest of the first call's output
    (seeded inputs: two trees whose kernels agree bit for bit print the
    same digest) and the bound (``decode_bound``, ``layer_bound``). ``strict``: raise unless those counts are
    GLOBAL_LAUNCHES. Returns {(name, B, pos): row}."""
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import decode_checks as DC
    from misinfo_tpu_torch.ops import layer_step as K9
    from misinfo_tpu_torch.ops import self_attn_step as K6
    rows = {}
    for B in batches:
        runs = []
        for int8 in () if only_i8cc_layer else (False, True):
            sfx = "_i8" if int8 else ""
            for pos in SELF_POSITIONS:
                sc = DC.self_attn_case(B, pos, int8)
                runs.append((f"self_attn_step{sfx}", pos, int8,
                             "self_attn_step",
                             getattr(K6, "kernel_launches", None),
                             lambda a=sc["args"]: K6.fused_self_attn_step(
                                 *a, n_heads=8),
                             decode_bound("self_attn_step", sc, int8)))
            cc = DC.cross_ffn_case(B, 1500, int8)
            runs.append((f"cross_ffn_step{sfx}", 447, int8, "cross_ffn_step",
                         getattr(K7, "kernel_launches", None),
                         lambda a=cc["args"]: K7.fused_cross_ffn_step(
                             *a, n_heads=8),
                         decode_bound("cross_ffn_step", cc, int8)))
        ic, lc = DC.cross_i8cc_case(B, 1500), DC.layer_case(B, 447)
        runs += [("cross_ffn_step_i8cc", 447, True, "cross_ffn_step_i8cc",
                  getattr(K7, "kernel_launches_i8cc", None),
                  lambda: K7.fused_cross_ffn_step(*ic["args"], n_heads=8,
                                                  **ic["scales"]),
                  decode_bound("cross_ffn_step", ic, True,
                               ic["scales"].values())),
                 ("layer_step", 447, True, "layer_step", K9.kernel_launches,
                  lambda: K9.fused_layer_step(*lc["args"], n_heads=8),
                  layer_bound(lc))]
        for name, pos, int8, lib, count, fn, bnd in runs:
            y = fn()
            y = (y[0] if isinstance(y, tuple) else y).cpu()
            per_call = None
            if count is not None:
                before = count()
                fn()
                torch.cuda.synchronize()
                per_call = count() - before
            ms = cuda_ms(fn, reps)
            us, kernels = device_us(fn)
            row = {"kernel": name, "B": B, "pos": pos, "ms": ms,
                   "device_us": us,
                   "kernels_us": kernel_split_us(fn),
                   "profiled_kernels_per_call": kernels,
                   "global_launches_per_call": per_call,
                   "output_sha256": hashlib.sha256(
                       y.view(torch.int16).numpy().tobytes()).hexdigest(),
                   "bound_us": bnd["bound_ms"] * 1e3,
                   "bound_by": bnd["bound_by"], "card": card}
            if name == "layer_step" and only_i8cc_layer:
                row["two_call_device_us"] = device_us(
                    lambda: two_call_step(K6, K7, lc))[0]
            print(json.dumps(row), flush=True)
            want = global_launches(lib, B, pos, int8) if strict else None
            if strict and per_call != want:
                raise AssertionError(f"{name} B={B}: {per_call} __global__ "
                                     f"launches per call, want {want}")
            rows[name, B, pos] = row
    return rows


# B, t_actual, T, loud_last: the loud_last cases make the last attended
# row a loud V row, so that the kernel's V piece holding it is planted
I8CC_CASES = ((1, 1500, 1500, False), (4, 1500, 1500, False),
              (8, 1400, 1500, False), (32, 1500, 1500, False),
              (3, 280, 300, False), (4, 1500, 1500, True),
              (3, 280, 300, True))
I8CC_TILES = {1: 512, 4: 512, 8: 256, 32: 128, 3: 384}


def check_i8cc_kernel(K7, card):
    """Phase 19: K8 against its plain version (decode_checks.py) at the
    three V tile widths and a ragged single tile; returns the kernels
    line's row, timed at B = 4."""
    from misinfo_tpu_torch.ops import decode_checks as DC
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = None
    for B, ta, T, loud in I8CC_CASES:
        case = DC.cross_i8cc_case(B, ta, T=T, loud_last=loud)
        if case["tile"] != I8CC_TILES[B]:
            raise AssertionError(f"v_tile({B}, 512, {T}) = {case['tile']}, "
                                 f"want {I8CC_TILES[B]}")
        before = (K7.launches, K7.launches_i8cc)
        res = DC.check_cross_i8cc(case, sms)        # raises if out of band
        torch.cuda.synchronize()
        if (K7.launches, K7.launches_i8cc) != (before[0], before[1] + 1):
            raise AssertionError("the int8-plane call did not count as K8")
        args, H, sc = case["args"], case["n_heads"], case["scales"]
        ms = cuda_ms(lambda: K7.fused_cross_ffn_step(*args, n_heads=H, **sc),
                     50)
        plain_ms = cuda_ms(lambda: K7.cross_ffn_step_i8cc_plain(
            *args, n_heads=H, **sc), 5)
        print(f"cross_ffn_step_i8cc B={B} T={T} t_actual={ta} tile="
              f"{case['tile']}{' loud last row' if loud else ''}: "
              f"max_abs_err={res['err']} (band up to "
              f"{res['band']}; {res['equal']:.4f} of the outputs bit for bit; "
              f"{res['edges']} probabilities at a rounding boundary; "
              f"{res['faults']} planted faults, nearest at "
              f"{res['nearest_fault']:.2f} bands) kernel_ms={ms} "
              f"plain_ms={plain_ms} [{card}]", flush=True)
        if B == 4 and not loud:
            row = {"err": res["err"], "ms": ms, "plain_ms": plain_ms,
                   **decode_bound("cross_ffn_step", case, True,
                                  sc.values())}
    return row


def layer_bound(case):
    """bound_ms of the whole-layer step: the two steps' work, x1 neither
    written nor read (it stays inside the kernel)."""
    m6, o6 = decode_work("self_attn_step", case["self"])
    m7, o7 = decode_work("cross_ffn_step", case["cross"])
    return bound(m6 + m7 - 2 * nbytes(case["args"][0]), o6 + o7, "int8")


def two_call_step(K6, K7, case):
    """The two calls that K9 replaces, K6b then K7b, on a layer case's
    inputs (the self caches' row pos written in place)."""
    x, blk, ck, cv, xk, xv, pos, ta = case["args"]
    sa, ca = blk["self_attn"], blk["cross_attn"]
    H = case["n_heads"]
    x1 = K6.fused_self_attn_step(x, blk["ln1"], sa["qkv"], sa["o"], ck, cv,
                                 pos, n_heads=H)[0]
    return K7.fused_cross_ffn_step(
        x1, blk["ln_cross"], ca["q"], ca["o"], blk["ln2"], blk["mlp_in"],
        blk["mlp_out"], xk, xv, ta, n_heads=H)


# (B, pos) of phase 20: one chunk a head (pos 0; B = 32, 256 virtual
# blocks), two chunks a head that wait for each other (B = 1, 4 at pos
# 447), chunks of unequal length (pos 200)
LAYER_CASES = ((1, 0), (1, 447), (4, 0), (4, 447), (4, 200), (32, 0),
               (32, 447))


def check_layer_kernel(K6, K7, K9, card):
    """Phase 20: K9 against K6b → K7b (bit for bit) and against its plain
    version (decode_checks.py), one __global__ launch per call; returns
    the kernels line's row, timed at B = 4, pos 447, beside the two-call
    route's time."""
    from misinfo_tpu_torch.ops import decode_checks as DC
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = None
    for B, pos in LAYER_CASES:
        case = DC.layer_case(B, pos)
        before = (K9.launches, K9.kernel_launches())
        res = DC.check_layer(case, sms)         # raises on any difference
        torch.cuda.synchronize()
        calls = K9.launches - before[0]
        per_call = K9.kernel_launches() - before[1]
        if (calls, per_call) != (1, 1):
            raise AssertionError(
                f"layer_step B={B} pos={pos}: {per_call} __global__ "
                f"launches in {calls} calls, want 1 in 1")
        x, blk, ck, cv, xk, xv, _, ta = case["args"]
        H = case["n_heads"]
        ms = cuda_ms(lambda: K9.fused_layer_step(
            x, blk, ck, cv, xk, xv, pos, ta, n_heads=H), 50)
        two_ms = cuda_ms(lambda: two_call_step(K6, K7, case), 50)
        plain_ms = cuda_ms(lambda: K9.layer_step_plain(
            x, blk, ck, cv, xk, xv, pos, ta, n_heads=H), 5)
        print(f"layer_step B={B} pos={pos}: output and caches equal to "
              f"K6b → K7b; {per_call} __global__ launch per call; "
              f"against the plain version max_abs_err={res['err']} (band "
              f"up to {res['band']}; {res['faults']} planted faults, "
              f"nearest at {res['nearest_fault']:.2f} bands) kernel_ms="
              f"{ms} two_call_ms={two_ms} plain_ms={plain_ms} [{card}]",
              flush=True)
        if B == 4 and pos == 447:
            row = {"err": res["err"], "ms": ms, "plain_ms": plain_ms,
                   "two_call_ms": two_ms, **layer_bound(case)}
    return row


def write_wav(path: str, seconds: float = 20.0, sr: int = 16000) -> None:
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * sr)) / sr
    audio = (0.4 * np.sin(2 * np.pi * 440.0 * t)
             + 0.3 * np.sin(2 * np.pi * 660.0 * t)
             + 0.05 * rng.normal(size=t.shape))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.numpy()


@contextlib.contextmanager
def counting_steps(W):
    """Count decode steps that ran the fused kernels (the decode looks
    ``_cached_decoder_step`` up by name on every step)."""
    real = W._cached_decoder_step
    seen = {"fused": 0}

    def spy(*a, **kw):
        if kw.get("pallas_self_attn") and kw.get("pallas_cross"):
            seen["fused"] += 1
        return real(*a, **kw)
    W._cached_decoder_step = spy
    try:
        yield seen
    finally:
        W._cached_decoder_step = real


def plain_decode_steps(W, K6, K7):
    """The fused decode step with the kernels' plain versions (on the
    card) for the duration of the block; the cross step's for either kind
    of planes."""
    def plain_cross(*a, k_scale=None, v_scale=None, **kw):
        if k_scale is None:
            return K7.cross_ffn_step_plain(*a, **kw)
        return K7.cross_ffn_step_i8cc_plain(*a, k_scale=k_scale,
                                            v_scale=v_scale, **kw)
    return swapped((W, "fused_self_attn_step", K6.self_attn_step_plain),
                   (W, "fused_cross_ffn_step", plain_cross))


def transcribe_counted(tr, wav, W, K6, K7, int8: bool):
    """Phase 6 for one transcriber: counts set to 0 just before, read just
    after; every launch must be of the int8 body (``int8``) or of the bf16
    body. Returns (K6 launches, K7 launches, the transcript, its wall
    seconds)."""
    layers = tr.cfg.decoder_layers
    what = "quant=kernels" if int8 else "quant=embedding"
    with counting_steps(W) as seen:
        K6.launches = K7.launches = 0       # this path's run starts here
        K6.launches_i8 = K7.launches_i8 = 0
        t0 = time.perf_counter()
        text = tr.transcribe(wav)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = (K6.launches, K6.launches_i8, K7.launches,
                  K7.launches_i8)           # read just after the path
    l6, l6_i8, l7, l7_i8 = counts
    print(f"transcribe ({what}) wall time: {sec} s, {seen['fused']} fused "
          f"decode steps, K6 launches {l6} (int8 {l6_i8}), K7 launches {l7} "
          f"(int8 {l7_i8}) (want {layers * seen['fused']} each); transcript "
          f"{len(text)} chars: {text[:60]!r}", flush=True)
    if text.startswith("[transcript error"):
        raise AssertionError(f"transcribe ({what}) failed: {text}")
    if not (seen["fused"] > 0 and l6 == l7 == layers * seen["fused"]):
        raise AssertionError(f"{what}: K6/K7 launches {l6}/{l7} != "
                             f"{layers} × {seen['fused']} fused steps")
    if (l6_i8, l7_i8) != ((l6, l7) if int8 else (0, 0)):
        raise AssertionError(f"{what}: int8-body launches {l6_i8}/{l7_i8} "
                             f"of {l6}/{l7}")
    return l6, l7, text, sec


def teacher_forced(tr, wav, W, K6, K7):
    """Phase 7: greedy tokens through the fused step with the kernels and
    with the plain versions; per-step logits within TF_BAND."""
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    mels, _ = prep_mel_windows(wav, 2 * tr.cfg.max_source_positions, 1)
    sp = tr.tokenizer.specials
    with torch.inference_mode():
        enc = tr._encode(mels)
        prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                              device="cuda")
        tokens = tr._decode(enc, prompt)[0]
        n = int((tokens[0] != sp.eot).sum().item()) + 1
        n = min(max(n, 8), tr.cfg.max_target_positions)

        def run():
            cache = W.init_kv_cache(tr.params, enc, n, tr.cfg, tr.policy,
                                    merged_self=True, merged_cross=True)
            out = []
            for i in range(n - 1):
                logits, _ = W._cached_decoder_step(
                    tr.params, tokens[:, i], i, enc, cache, tr.cfg,
                    tr.policy, pallas_self_attn=True, pallas_cross=True)
                out.append(logits.float())
            return torch.cat(out)
        got = run()
        with plain_decode_steps(W, K6, K7):
            want = run()
    diff = (got - want).abs().max().item()
    spread = (want.max() - want.min()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"teacher-forced {n - 1} steps: max |Δlogit| {diff} (band "
          f"{TF_BAND}; logit range {spread}); argmax agreement {agree}",
          flush=True)
    if not (math.isfinite(diff) and diff <= TF_BAND):
        raise AssertionError(f"teacher-forced logits differ by {diff}")
    return diff, agree


def transcript_timings(tr, wav, W, K6, K7, profile):
    """Phase 8 timings (printed): encoder per 30 s window, decode ms per
    step with the kernels and with the plain versions."""
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    mels, _ = prep_mel_windows(wav, 2 * tr.cfg.max_source_positions, 1)
    with torch.inference_mode():
        tr._encode(mels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            enc = tr._encode(mels)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) / 5 * 1e3
        prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                              device="cuda")
        per_step = {}
        for name in ("kernel", "plain", "kernel again"):
            ctx = (plain_decode_steps(W, K6, K7) if name == "plain"
                   else contextlib.nullcontext())
            with ctx, counting_steps(W) as seen:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr._decode(enc, prompt)
                torch.cuda.synchronize()
                per_step[name] = ((time.perf_counter() - t0) * 1e3
                                  / max(seen["fused"], 1))
        if profile:
            append_profile(profile, "one greedy transcript decode (B = 1, "
                           "whisper-base, quant=kernels)",
                           lambda: tr._decode(enc, prompt))
    print(f"encoder one 30 s window: {enc_ms} ms; decode ms/step: "
          + ", ".join(f"{k} {v}" for k, v in per_step.items()), flush=True)


def transcript_phases(engine, image, card, profile):
    """Phases 6-8, 18 and 21-23; returns the decode kernels' launches."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    from misinfo_tpu_torch.serve.transcript import (
        WhisperTranscriber, merge_into_caption)

    sp = ByteWhisperTokenizer().specials
    cfg = W.WhisperConfig(vocab_size=sp.vocab_size, eos_token_id=sp.eot,
                          decoder_start_token_id=sp.sot, **WB)
    weights = to_numpy(W.whisper_init(7, cfg))    # the JAX-layout tree
    wav = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_wav_"), "clip.wav")
    write_wav(wav)
    launches = {}
    trs = {}
    # the kernels transcriber walks the ladder's first two rungs (greedy,
    # then best_of 2 at T = 0.2: 3 decodes), which every later phase's
    # transcriber of its config repeats; the embedding one, the greedy rung
    for quant, cut in (("auto", {"fallback_temperatures": (0.0, 0.2),
                                 "best_of": 2}),
                       ("embedding", {"fallback_temperatures": (0.0,)})):
        tr = WhisperTranscriber(weights, config=cfg, device="cuda",
                                decode_cfg=dataclasses.replace(
                                    WhisperDecodeConfig(), quant=quant,
                                    **cut), cuda_graphs=False)
        want = "kernels" if quant == "auto" else "embedding"
        if not (tr.pallas and getattr(tr, f"quant_{want}")):
            raise AssertionError(f"quant={quant!r} resolved to pallas="
                                 f"{tr.pallas}, kernels={tr.quant_kernels}")
        if not (tr.has_weights and tr.tokenizer_compatible):
            raise AssertionError("transcriber reports no usable weights")
        l6, l7, text, sec = transcribe_counted(tr, wav, W, K6, K7,
                                               want == "kernels")
        suffix = "_i8" if want == "kernels" else ""
        launches["self_attn_step" + suffix] = l6
        launches["cross_ffn_step" + suffix] = l7
        trs[want] = tr, text, sec, (l6, l7)
    tiny_transcript_check(wav, card)                          # phase 6
    stamp("6")
    mesh_transcript_phase(weights, cfg, card)                 # phase 30 (e)
    stamp("30 (e)")
    tr = trs["kernels"][0]
    tg = transcriber_graphs(*trs["kernels"], weights, cfg,    # phase 26
                            wav, card)
    isolation_phase(tg, wav, trs["kernels"][1], card)         # 29 (b)
    del tg
    transcriber_from_pt(trs["kernels"], weights, cfg, wav,    # phase 27
                        engine, image, W, K6, K7)
    transcriber_from_native(trs["kernels"], weights, cfg, wav)  # phase 28
    stamp("26-29 (transcriber)")
    teacher_forced(tr, wav, W, K6, K7)
    merged = merge_into_caption("Caption of the clip.", wav, tr)
    if not merged.startswith("Caption of the clip.\n\n"):
        raise AssertionError(f"merge_into_caption gave {merged[:80]!r}")
    check_reports([engine.analyze(merged, image, verbose=False)],
                  "analyze(merged caption)")
    print(f"merged caption: {len(merged)} chars; analyze report ok",
          flush=True)
    transcript_timings(tr, wav, W, K6, K7, profile)
    stamp("7-8")
    launches["fused_ffn_whisper"] = whisper_pallas_ffn(weights, cfg, wav,
                                                       card)
    stamp("18")
    launches.update(whisper_int8_modes(tr, weights, cfg, wav,   # 21-23
                                       card))
    return launches


def tiny_transcript_check(wav, card) -> None:
    """Phase 6's head-width check: a transcriber of WhisperConfig.tiny()'s
    widths (four heads of 16) under the default decode config resolves the
    fused step on (quant "kernels"), yet decodes unfused, since the step's
    kernels take heads of 64 only: its transcript equals the one of
    pallas="off" on the same int8 weights, with no K6 or K7 launch."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    t0 = time.perf_counter()
    sp = ByteWhisperTokenizer().specials
    cfg = dataclasses.replace(
        W.WhisperConfig.tiny(), vocab_size=sp.vocab_size, num_mel_bins=80,
        max_source_positions=1500, max_target_positions=64,
        eos_token_id=sp.eot, decoder_start_token_id=sp.sot)
    weights = to_numpy(W.whisper_init(11, cfg))
    dc = dataclasses.replace(WhisperDecodeConfig(),
                             fallback_temperatures=(0.0,))
    tr, off = (WhisperTranscriber(weights, config=cfg, device="cuda",
                                  decode_cfg=d, cuda_graphs=False)
               for d in (dc, dataclasses.replace(dc, pallas="off",
                                                 quant="kernels")))
    mels = np.random.default_rng(6).standard_normal(
        (2, 3000, 80)).astype(np.float32)
    prompt = torch.tensor([sp.sot_sequence("en")[1:]] * 2, device="cuda")
    before = (K6.launches + K6.launches_i8, K7.launches + K7.launches_i8)
    text = tr.transcribe(wav)
    with torch.inference_mode():
        enc = tr._encode(mels)
        tokens = tr._decode(enc, prompt)[0]
    torch.cuda.synchronize()
    n = (K6.launches + K6.launches_i8 - before[0],
         K7.launches + K7.launches_i8 - before[1])
    want = off.transcribe(wav)
    with torch.inference_mode():
        same = torch.equal(tokens, off._decode(enc, prompt)[0])
    print(f"phase 6, heads of 16 (WhisperConfig.tiny()'s widths): pallas "
          f"{tr.pallas}, quant_kernels {tr.quant_kernels}; K6/K7 launches "
          f"{n}; transcript {'==' if text == want else '!='} pallas='off''s "
          f"({len(text)} chars), tokens of two windows "
          f"{'==' if same else '!='} ({tuple(tokens.shape)}); "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if not (tr.pallas and n == (0, 0) and text == want and same):
        raise AssertionError("phase 6: the tiny transcriber took the fused "
                             "step or another transcript")


def tiny_detector_check(card) -> None:
    """Phase 32's head-width check: DetectorConfig.tiny() (RoBERTa heads
    of 16, CLIP heads of 16 and 24) under engine I's mode (int8,
    use_pallas=True) and engine III's ("flash") on the card takes the
    einsum attention everywhere: no K3 or K11 launch, scores within 1e-4
    of the einsum engine's in the same quant mode."""
    from misinfo_tpu_torch.core.config import (
        ForensicsConfig, ModelPaths, SequenceConfig)
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import (DetectorConfig,
                                                   detector_init)
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import fused_attention as K3
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tiny_")
    vault = os.path.join(tmp, "vault.npz")
    make_vault(vault, 300, 64)
    det = DetectorConfig.tiny()
    params = detector_init(0, det)
    rng = np.random.default_rng(32)
    image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    reqs = ([{"text": words(rng, n), "image": image} for n in (20, 150)]
            + [{"text": words(rng, 200)}, {"image": image}])
    for use_pallas, quant in ((True, "int8"), ("flash", "none")):
        cfg = ForensicsConfig(verbose=False)
        cfg = cfg.replace(
            paths=ModelPaths(vault_path=vault),
            seq=SequenceConfig(roberta_max_len=128, image_size=64),
            precision=dataclasses.replace(cfg.precision, quant=quant))
        eng, einsum = (MisinfoForensics(cfg, det, params=params,
                                        device="cuda", cuda_graphs=False,
                                        use_pallas=p)
                       for p in (use_pallas, False))
        before = (K3.launches, K11.launches)
        got = eng.analyze_batch(reqs)
        torch.cuda.synchronize()
        n = (K3.launches - before[0], K11.launches - before[1])
        want = einsum.analyze_batch(reqs)
        drift = max(abs(a["scores"][k] - b["scores"][k])
                    for a, b in zip(got, want) for k in SCORE_KEYS
                    if isinstance(a["scores"].get(k), float))
        print(f"phase 32, DetectorConfig.tiny() (heads of 16 and 24), "
              f"use_pallas={use_pallas!r}, quant={quant!r}: K3/K11 launches "
              f"{n}, max score drift against the einsum engine {drift} "
              f"(limit 1e-4) [{card}]", flush=True)
        if n != (0, 0) or not drift <= 1e-4:
            raise AssertionError("phase 32: the tiny detector's heads went "
                                 "to a kernel or off the einsum path")
    shutil.rmtree(tmp)
    print(f"phase 32 tiny detector: {time.perf_counter() - t0:.1f} s",
          flush=True)


# -------------------------------------------------------------------- video

CLIP_SECONDS, CLIP_FPS, CLIP_W, CLIP_H = 12, 25.0, 640, 360
VIDEO_GROUP = 16                    # video_batch_buckets[-1]


def write_clip(path: str, seed: int) -> bool:
    """A 12 s mp4 at 25 fps and 640 × 360 (as tests/test_video_e2e.py
    writes one): a moving gradient beside seeded noise blocks. False
    where cv2 or an mp4 encoder is missing."""
    try:
        import cv2
    except ImportError:
        return False
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             CLIP_FPS, (CLIP_W, CLIP_H))
    if not writer.isOpened():
        return False
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, CLIP_W, dtype=np.float32)
    for i in range(int(CLIP_SECONDS * CLIP_FPS)):
        frame = np.empty((CLIP_H, CLIP_W, 3), np.uint8)
        frame[:] = ((ramp + 7 * i) % 256).astype(np.uint8)[None, :, None]
        cells = rng.integers(0, 256, (CLIP_H // 40, CLIP_W // 80, 3),
                             dtype=np.uint8)
        frame[:, : CLIP_W // 2] = np.repeat(np.repeat(cells, 40, 0), 40,
                                            1)[:CLIP_H, : CLIP_W // 2]
        writer.write(frame)
    writer.release()
    return os.path.getsize(path) > 0


def seeded_sampler(frames_of):
    """A stand-in for the engine's frame sampler with
    ``sample_video_frames``' contract: (frames [≤ max_frames], valid
    [max_frames]) for a request's ``video`` key, the frames looked up in
    ``frames_of``."""
    def sample(key, max_frames=12, stride_seconds=1.0, fps_fallback=25.0):
        frames = frames_of(key)[:max_frames]
        valid = np.zeros((max_frames,), np.bool_)
        valid[: len(frames)] = True
        return frames, valid
    return sample


@contextlib.contextmanager
def counting_video_programs(S):
    """Record each video program the engine runs: has_text, the frame
    mask's shape and the host time at which its host prep ended."""
    real = S.video_program
    seen = []

    def spy(params, batch, **kw):
        seen.append({"has_text": kw["has_text"], "batch": batch,
                     "frames": tuple(batch["frame_valid"].shape),
                     "t": time.perf_counter()})
        return real(params, batch, **kw)
    S.video_program = spy
    try:
        yield seen
    finally:
        S.video_program = real


def program_device_ms(fn):
    """One call of ``fn`` (a whole signal program) on the card, after a
    warm call: (device busy ms, the union of torch.profiler's CUDA
    intervals; span ms, CUDA events around the call, host gaps included;
    the host syncs inside the call, as torch.cuda's sync debug mode warns
    of them, with the first warning)."""
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    span = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, last = 0.0, 0.0
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return busy / 1e3, span, syncs


def video_scores(reports):
    return [r["scores"][k] for r in reports
            for k in ("ai_score", "misinfo_score", "deepfake_score",
                      "clip_similarity", "fake_probability")]


def video_phase(engine, rng, card):
    """Phase 25 on phase 4's engine; returns K1's launches in its run, the
    group of 16 requests and the sampler stand-in's frames (None where cv2
    decodes the clips, which stay for phase 26 in the returned directory)."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.engine import signals as S
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops import resize as R
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess.image import stage_image_batch
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    from misinfo_tpu_torch.serve.transcript import (
        WhisperTranscriber, merge_into_caption)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_video_")
    clips = [os.path.join(tmp, f"clip{i}.mp4") for i in range(4)]
    decoded = all(write_clip(c, 20 + i) for i, c in enumerate(clips))
    if decoded:
        sampler = contextlib.nullcontext()
        print(f"phase 25: {len(clips)} clips of {CLIP_SECONDS} s at "
              f"{CLIP_FPS:g} fps, {CLIP_W} × {CLIP_H}, written with cv2; "
              "frames decoded by sample_video_frames", flush=True)
    else:
        seeded = {c: [np.random.default_rng(40 + i * 100 + f).integers(
                      0, 256, (CLIP_H, CLIP_W, 3), dtype=np.uint8)
                      for f in range(12)] for i, c in enumerate(clips)}
        sampler = swapped((F, "sample_video_frames",
                           seeded_sampler(seeded.__getitem__)))
        print("phase 25: no cv2 or mp4 encoder; the engine's frame "
              "sampler replaced by seeded 640 × 360 frames", flush=True)
    clip = clips[0]
    sp = ByteWhisperTokenizer().specials
    wcfg = W.WhisperConfig(vocab_size=sp.vocab_size, eos_token_id=sp.eot,
                           decoder_start_token_id=sp.sot, **WB)
    tr = WhisperTranscriber(to_numpy(W.whisper_init(7, wcfg)), config=wcfg,
                            device="cuda", decode_cfg=dataclasses.replace(
                                WhisperDecodeConfig(),
                                fallback_temperatures=(0.0,)),
                            cuda_graphs=False)
    wav = os.path.join(tmp, "clip.wav")
    write_wav(wav, seconds=CLIP_SECONDS)
    _, _, transcript, _ = transcribe_counted(tr, wav, W, K6, K7, True)
    caption = "Footage of the flood, shared as new."
    merged = merge_into_caption(caption, wav, tr)
    want = ((caption + "\n\n" + transcript).strip()
            if transcript and not transcript.startswith("[transcript error")
            else caption)
    if merged != want:
        raise AssertionError(f"merge_into_caption gave {merged[:80]!r}, "
                             f"want {want[:80]!r}")
    group = [{"video": clips[i % len(clips)], "text": words(rng, 20 + i)}
             for i in range(VIDEO_GROUP)]
    launches = {}
    with sampler, counting_video_programs(S) as seen:
        K1.launches = 0                 # this path's run starts here
        one = [engine.analyze(merged, video_path=clip, verbose=False)]
        torch.cuda.synchronize()
        launches["video_text"] = K1.launches
        one.append(engine.analyze(video_path=clip, verbose=False))
        torch.cuda.synchronize()
        launches["video"] = K1.launches - launches["video_text"]
        t0 = time.perf_counter()
        host = engine.analyze_batch(group)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches["group"] = (K1.launches - launches["video_text"]
                             - launches["video"])
        total = K1.launches             # read just after the path
        grp = seen[-1]
        check_reports(one, "analyze(video)")
        check_reports(host, "video_text group")
        print(f"K1 launches: analyze(merged caption, video) "
              f"{launches['video_text']} (want {PER_PROGRAM['video_text']}), "
              f"analyze(video) {launches['video']} (want "
              f"{PER_PROGRAM['video']}), group of {VIDEO_GROUP} video_text "
              f"{launches['group']} (want {PER_PROGRAM['video_text']}) in "
              f"{len(seen) - 2} program(s) of {seen[-1]['frames']} frames",
              flush=True)
        if (launches != {"video_text": PER_PROGRAM["video_text"],
                         "video": PER_PROGRAM["video"],
                         "group": PER_PROGRAM["video_text"]}
                or [s["frames"] for s in seen] != [(1, 12), (1, 12),
                                                   (VIDEO_GROUP, 12)]):
            raise AssertionError(f"video path: K1 launches {launches}, "
                                 f"programs {[s['frames'] for s in seen]}")
        with swapped((K1, "int8_ffn", K1.int8_ffn_plain)):
            plain = engine.analyze_batch(group)
        drift = max(abs(a - b) for a, b in zip(video_scores(host),
                                               video_scores(plain)))
        print(f"video_text group, kernel vs plain FFN: max score drift "
              f"{drift} (limit 0.05); verdicts "
              f"{[r['verdict'] for r in host]}; top-1 vault rows "
              f"{[r['vault_matches'][0]['title'] for r in host]}",
              flush=True)
        if not drift < 0.05:
            raise AssertionError(f"video scores drift {drift} >= 0.05")
        prep_host = grp["t"] - t0
        batch = grp["batch"]
        kw = dict(has_text=True, det_cfg=engine.det_cfg, cfg=engine.cfg,
                  policy=engine.policy)
        with torch.inference_mode():
            dev = program_device_ms(lambda: S.video_program(
                engine.params, batch, **kw))
        serving = engine.cfg.serving
        engine.cfg = engine.cfg.replace(serving=dataclasses.replace(
            serving, device_resize=True))
        try:
            engine.analyze_batch(group)
            torch.cuda.synchronize()
            del seen[:]
            t0 = time.perf_counter()
            staged = engine.analyze_batch(group)
            torch.cuda.synchronize()
            staged_s = time.perf_counter() - t0
            prep_staged = seen[-1]["t"] - t0
            staged_batch = seen[-1]["batch"]
            with torch.inference_mode():
                staged_dev = program_device_ms(lambda: S.video_program(
                    engine.params, staged_batch, **kw))
        finally:
            engine.cfg = engine.cfg.replace(serving=serving)
        check_reports(staged, "video_text group, device resize")
        if "image_staged" not in staged_batch:
            raise AssertionError("device_resize sent no staged frames")
        routes = max(abs(a - b) for a, b in zip(video_scores(host),
                                                video_scores(staged)))
        frames = VIDEO_GROUP * 12
        print(f"video_text group of {VIDEO_GROUP} ({frames} frames): host "
              f"resize {VIDEO_GROUP / host_s} videos/s, host prep "
              f"{prep_host / frames * 1e3} ms/frame, program device busy "
              f"{dev[0]} ms of a {dev[1]} ms span; device resize "
              f"{VIDEO_GROUP / staged_s} videos/s, host prep "
              f"{prep_staged / frames * 1e3} ms/frame, program device busy "
              f"{staged_dev[0]} ms of a {staged_dev[1]} ms span (staged "
              f"{tuple(staged_batch['image_staged'].shape)}); max score "
              f"difference between the routes {routes} [{card}]",
              flush=True)
        for name, d in (("host resize", dev), ("device resize", staged_dev)):
            print(f"video_text program ({name}): {len(d[2])} host sync(s) "
                  f"in one call{'; first: ' + d[2][0] if d[2] else ''}",
                  flush=True)

    # device_resize_pair on the card against its CPU result
    rgb = [np.asarray(f, np.uint8) for f in
           (F.sample_video_frames(clip, 12)[0] if decoded
            else seeded[clip])]
    extra = [np.random.default_rng(60 + i).integers(
        0, 256, (224, 224, 3), dtype=np.uint8) for i in range(2)]
    st, pa = stage_image_batch(rgb + extra + [None, None], 640, 224)
    cpu = R.device_resize_pair(torch.from_numpy(st), torch.from_numpy(pa))
    gpu = R.device_resize_pair(torch.from_numpy(st).cuda(),
                               torch.from_numpy(pa).cuda())
    n = len(rgb)
    for name, c, g in zip(("effnet", "clip"), cpu, gpu):
        g = g.cpu()
        diff = (g.int() - c.int()).abs()
        share = (diff[:n] > 0).float().mean().item()
        print(f"device_resize_pair {name}, card vs CPU on {n} staged "
              f"frames: max {diff.max().item()} level(s) on {share} of the "
              f"pixels (limit 1 on {R.TIE_SHARE}); identity and zero "
              f"frames equal: {torch.equal(g[n:], c[n:])}", flush=True)
        if not (torch.equal(g[n:], c[n:]) and diff.max() <= 1
                and share <= R.TIE_SHARE):
            raise AssertionError(f"device resize ({name}) on the card is "
                                 "off its CPU result")
        if not torch.equal(g[n:n + 2], torch.from_numpy(np.stack(extra))):
            raise AssertionError("the device resize of a 224 × 224 frame "
                                 "is not the frame")
    return total, group, (None if decoded else seeded), tmp


# ------------------------------------------------------------ CUDA graphs

def dispatch_outputs(engine, reqs, debug=None):
    """One ``_dispatch_batch`` of ``reqs`` (under torch.cuda's sync debug
    mode ``debug``): the packed outputs on the host, and K1's launches."""
    from misinfo_tpu_torch.ops import int8_ffn as K1
    before = K1.launches
    if debug:
        torch.cuda.set_sync_debug_mode(debug)
    try:
        outs = [o for _, o, _ in engine._dispatch_batch(reqs)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = K1.launches - before
    return [o.cpu() for o in outs], launches


def profiled(fn, kernels):
    """fn()'s result, and torch.profiler's CUDA kernel records in that call
    of each kernel of ``kernels`` (its name without namespaces and
    template arguments)."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    seen = Counter(_kernel_label(e.name).split("<")[0].rsplit("::", 1)[-1]
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    return out, {k: seen[k] for k in kernels}


def replay_profiled(engine, reqs, kernel: str, counters):
    """``dispatch_outputs(engine, reqs, "error")`` under torch.profiler:
    (the packed outputs, the change of each of ``counters()``, a dict of
    the wrappers' launch counters, and the records of ``kernel``, which
    each counted call launches once, in that replay). The profiler loses
    a kernel record now and then on the card's machine, so a replay whose
    records fall short of the counters is profiled again, three times at
    most; a count above them is never retried."""
    for _ in range(3):
        before = counters()
        (got, _), rec = profiled(
            lambda: dispatch_outputs(engine, reqs, "error"), (kernel,))
        n = {k: v - before[k] for k, v in counters().items()}
        if rec[kernel] >= sum(n.values()):
            break
    return got, n, rec[kernel]


def same_bits(got, want) -> bool:
    """Packed outputs equal bit for bit (their int32 indices are viewed as
    f32, and -1 is a NaN pattern that torch.equal on floats refuses)."""
    return len(got) == len(want) and all(
        a.shape == b.shape and torch.equal(a.view(torch.int32),
                                           b.view(torch.int32))
        for a, b in zip(got, want))


def reserved_bytes() -> tuple:
    torch.cuda.synchronize()
    st = torch.cuda.memory_stats()
    return st["reserved_bytes.all.current"], st["allocated_bytes.all.current"]


def graph_phase(eager, batch, b32, text, image, group, seeded, card,
                profile):
    """Phase 26: a default engine (CUDA graphs) beside phase 4's eager
    one, on the same seeded weights and vault."""
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import int8_ffn as K1
    sampler = (contextlib.nullcontext() if seeded is None else swapped(
        (F, "sample_video_frames", seeded_sampler(seeded.__getitem__))))
    with sampler:
        m0 = reserved_bytes()
        graphed = F.MisinfoForensics(eager.cfg, DetectorConfig(),
                                     device="cuda")
        torch.cuda.empty_cache()
        m1 = reserved_bytes()
        t0 = time.perf_counter()
        sigs = graphed.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        m2 = reserved_bytes()
        torch.cuda.empty_cache()    # the eager passes' cached blocks
        m3 = reserved_bytes()
        shared, apart = input_bytes(graphed)
        extra = graphed.warmup(batch_sizes=(32,), variants=("full",),
                               videos=())
        print(f"phase 26: default warmup(): {len(sigs)} signatures "
              f"captured in {warm_s} s; reserved bytes up {m2[0] - m1[0]} "
              f"({m3[0] - m1[0]} after empty_cache: the graph pool and the "
              f"input buffers, {shared} bytes shared, {apart} with one set "
              f"per runner), allocated {m2[1] - m1[1]} (the engine's "
              f"weights and vault {m1[1] - m0[1]}); then the b32 full "
              f"signatures ({len(extra)}); eager by rule: none [{card}]",
              flush=True)
        work = {"b32": b32, "analyze": [{"text": text, "image": image}],
                "mixed": batch, "video_text group": group}
        want_k1 = {"b32": 36, "analyze": 36, "mixed": 60,
                   "video_text group": 36}
        for reqs in work.values():       # first use captures the rest
            graphed.analyze_batch(reqs)
        n_runners = len(graphed._runners)
        for name in reversed(list(work)):
            want, w_k1 = dispatch_outputs(eager, work[name])
            got, g_k1, g_rec = replay_profiled(
                graphed, work[name], "ffn_up_kernel",
                lambda: {"K1": K1.launches})
            g_k1 = g_k1["K1"]
            same = same_bits(got, want)
            print(f"phase 26 {name}: replay torch.equal to eager {same}, "
                  f"under sync debug 'error'; K1 launches replay {g_k1} "
                  f"(torch.profiler: {g_rec} records of K1's ffn_up_kernel, "
                  f"one a call, in that replay), eager {w_k1} (want "
                  f"{want_k1[name]})", flush=True)
            if not (same and g_rec == g_k1 == w_k1 == want_k1[name]):
                raise AssertionError(f"phase 26 {name}: graphs off eager")
        if len(graphed._runners) != n_runners:
            raise AssertionError("a replayed workload minted a runner")

        for name, eng in (("eager", eager), ("graphs", graphed),
                          ("graphs again", graphed), ("eager again", eager)):
            eng.analyze(text, image, verbose=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                eng.analyze(text, image, verbose=False)
            torch.cuda.synchronize()
            single = (time.perf_counter() - t0) / 5 * 1e3
            vps = verdicts_per_s(eng, b32)
            t0 = time.perf_counter()
            eng.analyze_batch(group)
            torch.cuda.synchronize()
            videos = len(group) / (time.perf_counter() - t0)
            busy, span, syncs = program_device_ms(
                lambda eng=eng: eng.analyze_batch(b32))
            print(f"phase 26 {name}: single analyze {single} ms; full "
                  f"b32/S512 {vps} verdicts/s; video_text group of "
                  f"{len(group)} {videos} videos/s; b32 batch device busy "
                  f"{busy} ms of a {span} ms span (idle share "
                  f"{1 - busy / span}), host syncs {len(syncs)} [{card}]",
                  flush=True)
        if profile:
            append_profile(profile, "full b32/S512 analyze_batch, CUDA "
                           "graphs", lambda: graphed.analyze_batch(b32),
                           rows=40)

        graphed.reload_vault(eager.cfg.paths.vault_path)
        if sorted(graphed._runners) != sorted(graphed._warmed):
            raise AssertionError("reload_vault kept other runners")
        want, _ = dispatch_outputs(eager, b32)
        got, g_k1 = dispatch_outputs(graphed, b32, "error")
        if not same_bits(got, want):
            raise AssertionError("b32 after reload_vault off eager")
        print(f"phase 26: reload_vault re-captured {len(graphed._runners)} "
              f"signatures; the b32 batch torch.equal to eager, K1 {g_k1}",
              flush=True)
    del graphed
    torch.cuda.empty_cache()
    staged_warmup(eager.cfg, card)


def input_bytes(engine) -> tuple:
    """(bytes of the engine's shared input buffers, bytes that its
    runners' inputs would take with a buffer set of their own each)."""
    return (nbytes(*engine._buffers.values()),
            sum(nbytes(*r.static.values()) for r in engine._runners.values()))


def staged_warmup(cfg, card):
    """Phase 26, device memory under ``serving.device_resize`` with the
    default staging sizes: the default warmup's signatures, seconds and
    reserved bytes (after empty_cache), and its input buffers shared
    against one set per runner."""
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.models.detector import DetectorConfig
    m0 = reserved_bytes()
    eng = F.MisinfoForensics(
        cfg.replace(serving=dataclasses.replace(cfg.serving,
                                                device_resize=True)),
        DetectorConfig(), device="cuda")
    torch.cuda.empty_cache()
    m1 = reserved_bytes()
    t0 = time.perf_counter()
    sigs = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    m2 = reserved_bytes()
    shared, apart = input_bytes(eng)
    print(f"phase 26 device_resize (staging "
          f"{cfg.serving.image_staging_buckets}): default warmup(): "
          f"{len(sigs)} signatures captured in {warm_s} s; reserved bytes up "
          f"{m2[0] - m1[0]} after empty_cache (the engine itself "
          f"{m1[0] - m0[0]}); input buffers {shared} bytes shared, "
          f"{apart} with one set per runner [{card}]", flush=True)
    del eng
    torch.cuda.empty_cache()


def decode_counts(K6, K7, zero=False):
    """The K6/K7 launch counters (K6, K6 int8 body, K7, K7 int8 body),
    set to 0 first with ``zero``."""
    if zero:
        K6.launches = K7.launches = K6.launches_i8 = K7.launches_i8 = 0
    return K6.launches, K6.launches_i8, K7.launches, K7.launches_i8


def transcriber_graphs(te, text, sec, launches, weights, cfg, wav, card):
    """Phase 26, the transcriber: phase 6's (eager; its transcript, wall
    seconds and K6/K7 launches ``text``, ``sec``, ``launches``) against a
    default one (CUDA graphs) on the same weights, after
    ``warmup((1,))``, warmup_transcriber's call. The graphed transcript's
    K6/K7 counts must be phase 6's (decoder layers × fused steps, every
    launch of the int8 body), and a graphed greedy decode's the layers ×
    the eager decode's steps, in the counters and in torch.profiler's
    records of K6's self_attention and K7's cross_attn kernels (one each a
    call)."""
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    tg = WhisperTranscriber(weights, config=cfg, device="cuda",
                            decode_cfg=te.decode_cfg)
    t0 = time.perf_counter()
    warmed = tg.warmup((1,))
    warm_s = time.perf_counter() - t0
    print(f"phase 26 transcriber: warmup((1,)) -> {warmed} in {warm_s} s, "
          f"{len(tg._runners)} runners, "
          f"{sum(len(v) for r in tg._runners.values() for v in getattr(r, 'graphs', {}).values())} "
          f"decode graphs [{card}]", flush=True)
    torch.cuda.synchronize()
    decode_counts(K6, K7, zero=True)        # this path's run starts here
    t0 = time.perf_counter()
    texts = {"graphs": tg.transcribe(wav), "eager (phase 6)": text}
    torch.cuda.synchronize()
    walls = {"graphs": time.perf_counter() - t0, "eager (phase 6)": sec}
    counts = decode_counts(K6, K7)          # read just after the path
    want = (launches[0], launches[0], launches[1], launches[1])
    print(f"phase 26 transcriber: transcribe() with graphs K6 launches "
          f"{counts[0]} (int8 {counts[1]}), K7 {counts[2]} (int8 "
          f"{counts[3]}); phase 6's eager transcript {want}", flush=True)
    if len(set(texts.values())) != 1:
        raise AssertionError(f"graph transcript differs: {texts}")
    if counts != want:
        raise AssertionError(f"graphed transcript K6/K7 launches {counts}, "
                             f"eager {want}")
    mels, _ = prep_mel_windows(wav, 2 * cfg.max_source_positions, 1)
    with torch.inference_mode():
        enc_e, enc_g = te._encode(mels), tg._encode(mels)
        prompt = torch.tensor([te.tokenizer.sot_sequence(language="en")[1:]],
                              device="cuda")
        same = torch.equal(enc_e, enc_g)
        for t, seed in ((0.0, None), (0.2, 262)):
            a, b = te._decode(enc_e, prompt, t, seed), tg._decode(
                enc_g, prompt, t, seed)
            same = same and all(torch.equal(x, y) for x, y in zip(a, b))
        with counting_steps(W) as seen:
            te._decode(enc_e, prompt)
        steps = max(seen["fused"], 1)
        layers = cfg.decoder_layers
        kernels = ("self_attention", "cross_attn")
        for _ in range(3):      # the profiler loses a record now and then
            decode_counts(K6, K7, zero=True)
            _, rec = profiled(lambda: tg._decode(enc_g, prompt), kernels)
            counts = decode_counts(K6, K7)
            if min(rec.values()) >= layers * seen["fused"]:
                break
        print(f"phase 26 transcriber: a greedy decode with graphs: K6/K7 "
              f"launches {counts} (K6, its int8 body, K7, its int8 body; "
              f"want {layers} layers × {seen['fused']} eager steps each), "
              f"torch.profiler's records in that decode {rec}", flush=True)
        if not (seen["fused"] > 0
                and set(counts) == set(rec.values())
                == {layers * seen["fused"]}):
            raise AssertionError(f"graphed decode K6/K7 launches {counts}, "
                                 f"records {rec}")
        per_step = {}
        for name, tr, enc in (("eager", te, enc_e), ("graphs", tg, enc_g),
                              ("graphs again", tg, enc_g),
                              ("eager again", te, enc_e)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                tr._decode(enc, prompt)
            torch.cuda.synchronize()
            per_step[name] = (time.perf_counter() - t0) / 3 * 1e3 / steps
    print(f"phase 26 transcriber: transcribe() of the 20 s clip, text "
          f"equal {len(set(texts.values())) == 1}; wall s "
          + ", ".join(f"{k} {v}" for k, v in walls.items())
          + f"; encoder and greedy / sampled (T = 0.2) tokens torch.equal "
          f"{same}; greedy decode ms/step ({steps} steps) "
          + ", ".join(f"{k} {v}" for k, v in per_step.items())
          + f" [{card}]", flush=True)
    if not same:
        raise AssertionError("graph decode tokens differ from eager")
    return tg


# ------------------------------------------------- entry points (phase 27)

WEIGHT_FILES = ("fusion_weights", "ai_head_weights", "misinfo_head_weights",
                "efficientnet_weights", "clip_weights")
API_REQUESTS, API_CLIENTS = 64, 8


def write_reference_ckpts(tree, root: str) -> dict:
    """Phase 27's checkpoints: ``tree`` through the port's
    export_reference_state_dicts into ``root``/mono (the monolithic file
    and clip_detective_best.pth) and ``root``/indiv (the per-branch
    files). Returns each directory's leaf count."""
    from misinfo_tpu_torch.checkpoints.torch_convert import (
        export_reference_state_dicts)
    full, clip_sd = export_reference_state_dicts(tree)

    def tensors(prefix=""):
        return {k: torch.from_numpy(v) for k, v in full.items()
                if k.startswith(prefix)}
    mono, indiv = os.path.join(root, "mono"), os.path.join(root, "indiv")
    os.makedirs(mono)
    os.makedirs(indiv)
    torch.save({"full_model_state_dict": tensors(), "epoch": 8,
                "accuracy": 0.9538},
               os.path.join(mono, "forensics_master_final.pth"))
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in clip_sd.items()}},
               os.path.join(mono, "clip_detective_best.pth"))
    branches = (("ai_head_best.pth", "ai_head."),
                ("roberta_detective_best.pth", "misinfo_head."))
    for name, prefix in branches:
        torch.save({"model_state_dict": tensors(prefix)},
                   os.path.join(indiv, name))
    # the reference CIFAKE trainer saves a raw state_dict
    torch.save(tensors("efficientnet."),
               os.path.join(indiv, "efficientnet_cifake_best.pth"))
    return {mono: len(full) + len(clip_sd),
            indiv: sum(len(tensors(p)) for p in ("ai_head.", "misinfo_head.",
                                                  "efficientnet."))}


def config_in(base, ckpt_dir: str, vault_path: str):
    """``base`` with ModelPaths' reference files in ``ckpt_dir``."""
    p = base.paths
    return base.replace(paths=dataclasses.replace(
        p, vault_path=vault_path,
        **{f: os.path.join(ckpt_dir, getattr(p, f)) for f in WEIGHT_FILES}))


def png_path(image: np.ndarray, path: str) -> str:
    from PIL import Image
    Image.fromarray(image).save(path)
    return path


def png_b64(image: np.ndarray) -> str:
    import base64
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def http(url: str, payload=None):
    """(status, JSON body, seconds) of a GET (no payload) or a POST."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            body = json.loads(r.read())
            code = r.status
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, time.perf_counter() - t0


@contextlib.contextmanager
def counting_runs(engine):
    """Record the variant of every program ``engine`` runs (its ``_run``,
    one call a program) while the block lasts."""
    seen = []
    real = engine._run

    def spy(sig, inputs):
        seen.append(sig[0])
        return real(sig, inputs)
    engine._run = spy
    try:
        yield seen
    finally:
        del engine._run


def api_phase(engine, rng, card):
    """Phase 27, the API: ``serve(ForensicsAPI(engine), port=0)`` over the
    warmed checkpoint engine. Returns K1's launches in its requests."""
    from concurrent.futures import ThreadPoolExecutor
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.serve import api as A

    sigs = engine.warmup()
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for _ in range(4)]
    b64 = [png_b64(im) for im in images]
    reqs = [{"text": words(rng, 20 + (7 * i) % 50), "image_b64": b64[i % 4]}
            for i in range(API_REQUESTS)]
    own = engine.analyze_batch([A._decode_request_image(r) for r in reqs])
    api = A.ForensicsAPI(engine=engine)
    httpd = A.serve(api, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, health, _ = http(url + "/healthz")
        name = torch.cuda.get_device_name(0)
        print(f"phase 27 API: /healthz {code} {health}", flush=True)
        if not (code == 200 and health["device"] == name
                and health["checkpoint_mode"] == "monolithic"):
            raise AssertionError(f"/healthz gave {health}")

        def drive():
            with ThreadPoolExecutor(API_CLIENTS) as ex:
                got = list(ex.map(lambda r: http(url + "/analyze", r), reqs))
            batch = http(url + "/analyze_batch", reqs[:4])
            pred = http(url + "/predict", reqs[4])
            return got, batch, pred

        # the first run also captures the batch buckets that the default
        # warmup leaves to first use (2-16); the second replays them
        for run in ("first run", "again"):
            t0 = time.perf_counter()
            got, batch, pred = drive()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lat = sorted(s for _, _, s in got)
            if any(c != 200 for c, _, _ in got + [batch, pred]):
                raise AssertionError("an API call failed: " + str(
                    [b for c, b, _ in got + [batch, pred] if c != 200][:2]))
            answers = [b for _, b, _ in got] + batch[1]
            wants = own + own[:4]
            drift = max(abs(a["scores"][k] - w["scores"][k])
                        for a, w in zip(answers, wants)
                        for k in ("fake_probability", "ai_score",
                                  "deepfake_score", "clip_similarity"))
            same = all(a["verdict"] == w["verdict"]
                       for a, w in zip(answers, wants))
            same = same and pred[1]["verdict_text"] == own[4]["verdict_text"]
            print(f"phase 27 API ({run}): {API_REQUESTS} full requests "
                  f"from {API_CLIENTS} client threads in {wall} s: "
                  f"{API_REQUESTS / wall} requests/s (with one "
                  f"/analyze_batch of 4 and one /predict), latency p50 "
                  f"{lat[len(lat) // 2] * 1e3} ms, p95 "
                  f"{lat[int(0.95 * (len(lat) - 1))] * 1e3} ms, "
                  f"{len(engine._runners)} runners; verdicts equal to the "
                  f"engine's own {same}, max score difference {drift} "
                  f"[{card}]", flush=True)
            if not same:
                raise AssertionError("an API verdict differs from the "
                                     "engine's")

        code, metrics, _ = http(url + "/metrics")
        print(f"phase 27 API: /metrics verdicts_per_sec "
              f"{metrics.get('verdicts_per_sec')}, host_prep "
              f"{metrics.get('host_prep', {}).get('summary')}", flush=True)
        if not (code == 200 and {"verdicts_per_sec", "memory",
                                 "host_prep"} <= set(metrics)):
            raise AssertionError(f"/metrics gave keys {sorted(metrics)}")

        # K1 in the replays: the profiler's records of its up kernel over
        # the API calls equal PER_PROGRAM × the programs dispatched (the
        # profiler drops a record now and then: three tries at most)
        for _ in range(3):
            before = K1.launches
            with counting_runs(engine) as seen:
                _, rec = profiled(drive, ("ffn_up_kernel",))
            want = sum(PER_PROGRAM[v] for v in seen)
            counted = K1.launches - before
            if rec["ffn_up_kernel"] >= want:
                break
        print(f"phase 27 API: the batcher dispatched {len(seen)} programs "
              f"({', '.join(sorted(set(seen)))}) over the warmed signatures "
              f"({len(sigs)}, CUDA graphs); K1 launches {counted}, "
              f"torch.profiler records of ffn_up_kernel "
              f"{rec['ffn_up_kernel']} (want {want})", flush=True)
        if not (seen and rec["ffn_up_kernel"] == counted == want):
            raise AssertionError("K1 off PER_PROGRAM × programs in the API")
    finally:
        httpd.shutdown()
        api.close()
    return want


def entry_points_phase(batch, vault_path, rng, card):
    """Phase 27: the entry points on reference checkpoints at full width.
    Returns K1's launches in the phase (its counts set to 0 just before,
    read just after)."""
    import gc
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.serve import cli

    det = DetectorConfig()
    base = ForensicsConfig(verbose=True)
    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tree = detector_init(11, det)
        t0 = time.perf_counter()
        written = write_reference_ckpts(tree, tmp)
        mono, indiv = list(written)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d in written for f in os.listdir(d))
        print(f"phase 27: {size} bytes of .pth written in "
              f"{time.perf_counter() - t0} s", flush=True)
        K1.launches = 0             # this path's run starts here
        booted = {}
        for d, mode in ((mono, "monolithic"), (indiv, "individual")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = F.MisinfoForensics(config_in(base, d, vault_path), det,
                                     device="cuda",
                                     cuda_graphs=mode == "monolithic")
            torch.cuda.synchronize()
            boot = time.perf_counter() - t0
            rep = eng.load_report
            print(f"phase 27: boot from {mode} .pth {boot} s, load_report "
                  f"mode {rep['mode']}, applied {rep['applied']} (written "
                  f"{written[d]}), skipped {len(rep['skipped'])} [{card}]",
                  flush=True)
            if (rep["mode"], rep["applied"], rep["skipped"]) != (
                    mode, written[d], []):
                raise AssertionError(f"phase 27 {mode}: load_report {rep}")
            booted[mode] = eng
        # the trees the files carry, given as params: individual mode
        # overlays the heads and EfficientNet on the engine's seeded init
        want_i = detector_init(base.seed, det)
        for sub in ("ai_head", "misinfo_head", "efficientnet"):
            want_i[sub] = tree[sub]
        for mode, params in (("monolithic", tree), ("individual", want_i),
                             ("another seed", detector_init(12, det))):
            ref = F.MisinfoForensics(config_in(base, tmp, vault_path), det,
                                     params=params, device="cuda",
                                     cuda_graphs=False)
            want = ref.analyze_batch(batch)
            got = booted.get(mode, booted["monolithic"]).analyze_batch(batch)
            check_reports(got, f"phase 27 {mode}")
            equal = got == want
            print(f"phase 27: {mode} engine's analyze_batch of the mixed "
                  f"batch equal to one given the tree: {equal}", flush=True)
            if equal != (mode != "another seed"):
                raise AssertionError(f"phase 27 {mode}: reports equal "
                                     f"{equal}")
            del ref
        engine = booted.pop("monolithic")
        del booted
        gc.collect()
        torch.cuda.empty_cache()

        # the CLI in the process, beside the monolithic files
        img = png_path(batch[0]["image"], os.path.join(tmp, "image.png"))
        reqs = [{k: (img if k == "image" else v) for k, v in r.items()}
                for r in batch]
        jsonl = os.path.join(tmp, "requests.jsonl")
        with open(jsonl, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in reqs)
        out = os.path.join(tmp, "cli.json")
        cwd = os.getcwd()
        os.chdir(mono)
        try:
            t0 = time.perf_counter()
            rc = cli.main(["--batch-file", jsonl, "--output", out,
                           "--vault", vault_path, "--quiet"])
            cli_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        gc.collect()
        torch.cuda.empty_cache()
        with open(out) as f:
            got = json.load(f)
        want = json.loads(json.dumps(list(engine.analyze_stream(
            reqs, explanations=True))))
        print(f"phase 27 CLI: --batch-file of {len(reqs)} requests rc {rc} "
              f"in {cli_s} s (boot included); its JSON equal to "
              f"analyze_stream on the monolithic engine: {got == want}",
              flush=True)
        if not (rc == 0 and got == want):
            raise AssertionError("phase 27: the CLI's output differs")

        api_phase(engine, rng, card)
        launches = K1.launches      # read just after the path
        print(f"phase 27: K1 launches {launches}; the engine half of the "
              f"phase {time.perf_counter() - start} s", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def export_whisper_hf(tree) -> dict:
    """A Whisper tree (numpy, the JAX layout) → an HF WhisperModel state
    dict of torch tensors, the inverse of torch_convert.convert_whisper."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def lin(key, node):
        sd[key + ".weight"] = t(node["kernel"].T)
        if "bias" in node:
            sd[key + ".bias"] = t(node["bias"])

    def ln(key, node):
        sd[key + ".weight"], sd[key + ".bias"] = (t(node["scale"]),
                                                  t(node["bias"]))
    enc, dec = tree["encoder"], tree["decoder"]
    for conv in ("conv1", "conv2"):
        sd[f"encoder.{conv}.weight"] = t(
            enc[conv]["kernel"].transpose(2, 1, 0))
        sd[f"encoder.{conv}.bias"] = t(enc[conv]["bias"])
    sd["encoder.embed_positions.weight"] = t(enc["positions"])
    sd["decoder.embed_tokens.weight"] = t(dec["token_embedding"])
    sd["decoder.embed_positions.weight"] = t(dec["positions"])
    projections = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                   ("out_proj", "o"))
    for tower, blocks in (("encoder", enc["blocks"]),
                          ("decoder", dec["blocks"])):
        for i, b in enumerate(blocks):
            lp = f"{tower}.layers.{i}."
            ln(lp + "self_attn_layer_norm", b["ln1"])
            attn = b["attn"] if tower == "encoder" else b["self_attn"]
            for hf, j in projections:
                lin(lp + "self_attn." + hf, attn[j])
            if tower == "decoder":
                ln(lp + "encoder_attn_layer_norm", b["ln_cross"])
                for hf, j in projections:
                    lin(lp + "encoder_attn." + hf, b["cross_attn"][j])
            ln(lp + "final_layer_norm", b["ln2"])
            lin(lp + "fc1", b["mlp_in"])
            lin(lp + "fc2", b["mlp_out"])
    ln("encoder.layer_norm", enc["final_ln"])
    ln("decoder.layer_norm", dec["final_ln"])
    return sd


def transcriber_from_pt(want, weights, cfg, wav, engine, image, W, K6, K7):
    """Phase 27, the transcriber: ``weights`` as an HF-layout ``.pt``,
    loaded through ``WhisperTranscriber(checkpoint_dir=...)``; the 20 s
    clip transcribed to phase 6's text (``want``: its kernels
    transcriber, text, seconds and K6/K7 launches) with phase 6's counts,
    the greedy tokens torch.equal, merge_into_caption → analyze."""
    from misinfo_tpu_torch.serve.transcript import (
        WhisperTranscriber, merge_into_caption)
    tr0, text0, _, counts0 = want
    d = tempfile.mkdtemp(prefix="chip_smoke_whisper_")
    try:
        path = os.path.join(d, "whisper-base.pt")
        sd = export_whisper_hf(weights)
        torch.save(sd, path)
        t0 = time.perf_counter()
        tr = WhisperTranscriber(checkpoint_dir=path, device="cuda",
                                decode_cfg=tr0.decode_cfg, cuda_graphs=False)
        boot = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"phase 27 transcriber: {len(sd)} tensors as an HF .pt, built in "
          f"{boot} s: has_weights {tr.has_weights}, tokenizer_compatible "
          f"{tr.tokenizer_compatible}, config equal {tr.cfg == cfg}",
          flush=True)
    if not (tr.has_weights and tr.tokenizer_compatible and tr.cfg == cfg):
        raise AssertionError("phase 27: the .pt transcriber is not phase 6's")
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    mels, _ = prep_mel_windows(wav, 2 * cfg.max_source_positions, 1)
    with torch.inference_mode():
        prompt = torch.tensor(
            [tr.tokenizer.sot_sequence(language="en")[1:]], device="cuda")
        tok = tr._decode(tr._encode(mels), prompt)[0]
        tok0 = tr0._decode(tr0._encode(mels), prompt)[0]
    l6, l7, text, sec = transcribe_counted(tr, wav, W, K6, K7, True)
    print(f"phase 27 transcriber: greedy tokens torch.equal to the tree's "
          f"{torch.equal(tok, tok0)}; transcribe() text equal to phase 6's "
          f"{text == text0}, K6/K7 launches {l6}/{l7} (phase 6 "
          f"{counts0[0]}/{counts0[1]})", flush=True)
    if not (torch.equal(tok, tok0) and text == text0
            and (l6, l7) == tuple(counts0)):
        raise AssertionError("phase 27: the .pt transcriber differs")
    merged = merge_into_caption("Caption of the clip.", wav, tr)
    if merged != ("Caption of the clip.\n\n" + text).strip():
        raise AssertionError(f"merge_into_caption gave {merged[:80]!r}")
    check_reports([engine.analyze(merged, image, verbose=False)],
                  "phase 27 analyze(merged caption)")


# ------------------------------------------------------ trainers (phase 28)

TRAIN_ROWS, TRAIN_BATCH, TRAIN_LEN = 200, 16, 256
IMAGE_ITEMS, IMAGE_BATCH = 160, 32
FUSION_ROWS, FUSION_EPOCHS = 64, 10


class GradCapture:
    """An optimizer stand-in that keeps the gradients a step hands it."""

    def update(self, grads, state):
        self.grads = grads


def text_loss_grads(tree, det, policy, batch, device):
    """(loss, {path: gradient on the CPU}) of one misinfo-head text step
    (make_text_head_step) on ``device``, the trainable leaves being the
    backbone and the misinfo head."""
    from misinfo_tpu_torch.train import optim, steps
    from misinfo_tpu_torch.utils.tree import clone_tree
    tree = clone_tree(tree, device)
    tx = optim.make_optimizer(optim.OptimConfig(), optim.branch_mask(
        tree, ["roberta", "misinfo_head"]))
    state = tx.init(tree)
    cap = GradCapture()
    _, _, m = steps.make_text_head_step(cap, det, policy)(
        tree, state, steps.batch_to(batch, device))
    return float(m["loss"]), {p: g.detach().float().cpu()
                              for p, g in zip(state.paths, cap.grads)}


def text_step_card_vs_cpu(card):
    """Phase 28, first part: one f32 text step (RoBERTa-base + both heads,
    B = 2, S = 128, dropout 0) on the card and on the CPU from the same
    tree and batch. The attention key biases' exact gradient is zero (a
    softmax does not see a shift of all its scores): both sides hold
    rounding noise there, which must stay below 1e-5 of the largest
    gradient; every other leaf within 1e-3 of its own largest."""
    from misinfo_tpu_torch.core.config import PrecisionConfig
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.models.roberta import head_init, roberta_init
    from misinfo_tpu_torch.ops.common import Policy, set_exact_f32
    det = DetectorConfig()
    det = dataclasses.replace(det, roberta=dataclasses.replace(
        det.roberta, hidden_dropout=0.0))
    gen = torch.Generator().manual_seed(31)
    tree = {"roberta": roberta_init(gen, det.roberta),
            "ai_head": head_init(gen, det.roberta),
            "misinfo_head": head_init(gen, det.roberta)}
    rng = np.random.default_rng(31)
    ids = rng.integers(3, det.roberta.vocab_size, (2, 128)).astype(np.int32)
    mask = np.ones((2, 128), np.int32)
    ids[1, 90:], mask[1, 90:] = det.roberta.pad_token_id, 0
    batch = {"input_ids": ids, "attention_mask": mask,
             "labels": np.asarray([1, 0], np.int32)}
    policy = Policy(PrecisionConfig.highest())
    tf32 = torch.backends.cudnn.allow_tf32
    set_exact_f32(parity=True)
    try:
        t0 = time.perf_counter()
        l_cpu, g_cpu = text_loss_grads(tree, det, policy, batch, "cpu")
        cpu_s = time.perf_counter() - t0
        l_card, g_card = text_loss_grads(tree, det, policy, batch, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    def norm(gs):
        return float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in gs.values()])))
    n_cpu, n_card = norm(g_cpu), norm(g_card)
    top = max(float(g.abs().max()) for g in g_cpu.values())
    ratio, noise = 0.0, 0.0
    for path, a in g_cpu.items():
        b = g_card[path]
        if path[-2:] == ("k", "bias"):
            noise = max(noise, float(a.abs().max()), float(b.abs().max()))
            continue
        scale = float(a.abs().max())
        diff = float((a - b).abs().max())
        if scale or diff:
            ratio = max(ratio, diff / scale if scale else math.inf)
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    rel_norm = abs(n_card - n_cpu) / n_cpu
    print(f"phase 28: f32 text step (RoBERTa-base + heads, B 2, S 128) "
          f"card vs CPU: loss {l_card} / {l_cpu} (rel {rel_loss}, bound "
          f"1e-4), gradient norm {n_card} / {n_cpu} (rel {rel_norm}, bound "
          f"1e-3), largest per-leaf |Δg| / max|g| {ratio} (bound 1e-3) over "
          f"{len(g_cpu)} leaves, key-bias noise {noise} (bound "
          f"{1e-5 * top}); CPU step {cpu_s} s", flush=True)
    if not (rel_loss <= 1e-4 and rel_norm <= 1e-3 and ratio <= 1e-3
            and noise <= 1e-5 * top):
        raise AssertionError("phase 28: the card's f32 text step is off "
                             "the CPU's")


# the step (from 0) a trainer's record profiles, not timed: the profiler
# slows it
PROFILED_STEP = 3


def step_device_ms(fn):
    """fn() under torch.profiler: (its result, the card's busy ms — the
    union of the CUDA records' intervals — and the number of records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, last = 0.0, 0.0
    for a, b in spans:
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    return out, busy / 1e3, len(spans)


@contextlib.contextmanager
def timed_trainer(module):
    """Every step of ``module``'s trainer timed with the card synced
    before and after, and its loss read; every checkpoint it saves timed.
    Yields the record."""
    from misinfo_tpu_torch.checkpoints import io as ckpt_io
    rec = {"n": 0, "ms": [], "loss": [], "save_s": [], "busy_ms": None,
           "kernels": None}
    real_run, real_save = module.run_training, ckpt_io.save_checkpoint

    def run(params, opt_state, step_fn, *a, **kw):
        def timed(p, o, b, g):
            torch.cuda.synchronize()
            rec["n"] += 1
            if rec["n"] == PROFILED_STEP + 1:
                out, rec["busy_ms"], rec["kernels"] = step_device_ms(
                    lambda: step_fn(p, o, b, g))
                return out
            t0 = time.perf_counter()
            out = step_fn(p, o, b, g)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["loss"].append(float(out[2]["loss"]))
            return out
        return real_run(params, opt_state, timed, *a, **kw)

    def save(*a, **kw):
        t0 = time.perf_counter()
        real_save(*a, **kw)
        rec["save_s"].append(time.perf_counter() - t0)
    module.run_training, ckpt_io.save_checkpoint = run, save
    try:
        yield rec
    finally:
        module.run_training, ckpt_io.save_checkpoint = real_run, real_save


def run_trainer(name, module, train, per_step, unit, out_dir, like, card):
    """One trainer at full width: its result, and the printed step ms
    (median after the first two steps), rate, peak memory, first and last
    loss, checkpoint save and load seconds."""
    from misinfo_tpu_torch.checkpoints.io import load_checkpoint
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_trainer(module) as rec:
        res = train()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    loaded = load_checkpoint(out_dir, like)
    load_s = time.perf_counter() - t0
    ms = float(np.median(rec["ms"][2:]))
    losses = rec["loss"]
    info = {"steps": rec["n"],
            "ms": ms, "rate": per_step / ms * 1e3,
            "busy_ms": rec["busy_ms"], "kernels": rec["kernels"],
            "peak_gb": peak / 1e9, "own_gb": (peak - base) / 1e9,
            "loss": (losses[0], losses[-1]), "saves": rec["save_s"],
            "load_s": load_s, "wall_s": wall}
    print(f"phase 28 {name}: {info['steps']} steps, step ms {ms} (median "
          f"after the first two; step {PROFILED_STEP} profiled instead: the "
          f"card busy {rec['busy_ms']} ms over {rec['kernels']} CUDA "
          f"records), {info['rate']} {unit}/s, peak memory "
          f"{info['peak_gb']} GB ({info['own_gb']} GB over what the phase "
          f"found allocated), loss first {losses[0]} last {losses[-1]}, "
          f"{len(rec['save_s'])} checkpoint saves {rec['save_s']} s, load "
          f"{load_s} s, trainer wall {wall} s [{card}]", flush=True)
    if not (losses and all(math.isfinite(v) for v in losses)
            and loaded is not None and rec["save_s"]):
        raise AssertionError(f"phase 28 {name}: losses {losses[:3]}..., "
                             "or no checkpoint")
    return res, info


def write_pngs(root: str, n: int, size: int = 224, seed: int = 28):
    """``n`` seeded RGB PNGs: smooth gradients, blocks and noise."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    paths = []
    for i in range(n):
        c = rng.uniform(0, 255, (2, 3)).astype(np.float32)
        img = (c[0] * xx[..., None] + c[1] * yy[..., None]) / 2
        r, q = rng.integers(0, size - 48, 2)
        img[r:r + 48, q:q + 48] = rng.uniform(0, 255, 3)
        img += rng.normal(0, 8, img.shape)
        p = os.path.join(root, f"img{i:04d}.png")
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            p, compress_level=1)
        paths.append(p)
    return paths


def same_leaves(a, b, branches=None) -> bool:
    """torch.equal over the leaves of two trees (of ``branches`` only)."""
    from misinfo_tpu_torch.utils.tree import leaves_with_paths
    pa, pb = leaves_with_paths(a), leaves_with_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        torch.equal(x.to(y.device), y) for (p, x), (_, y) in zip(pa, pb)
        if branches is None or p[0] in branches)


def roberta_flops(tree, det) -> float:
    """One RoBERTa training step's FLOPs: 6 × the non-embedding
    parameters × the tokens, plus the attention products (QKᵀ and PV,
    forward and twice in backward: 12·L·B·S²·D)."""
    from misinfo_tpu_torch.utils.tree import leaves_with_paths
    n = sum(t.numel() for p, t in leaves_with_paths(tree)
            if p[0] in ("ai_head", "misinfo_head")
            or p[:2] == ("roberta", "layers"))
    r = det.roberta
    attn = 12 * r.num_layers * TRAIN_BATCH * TRAIN_LEN ** 2 * r.hidden_size
    return 6 * n * TRAIN_BATCH * TRAIN_LEN + attn


def trainers_phase(engine, vault_path, rng, card):
    """Phase 28: the f32 step on the card against the CPU, the five
    trainers at full width in bf16 on generated rows, and the RoBERTa
    trainer's directory served (the engine, the CLI). Returns K1's
    launches in the fusion judge's sweep over ``engine`` (its counts set
    to 0 just before the sweep, read just after)."""
    import gc
    import pandas as pd
    from misinfo_tpu_torch.checkpoints.from_jax import to_device
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops.serving import optimize_for_serving
    from misinfo_tpu_torch.serve import cli
    from misinfo_tpu_torch.train import (
        cifake_efficientnet, clip_detective, fusion_judge, roberta_detective)
    from misinfo_tpu_torch.utils.tree import clone_tree

    start = time.perf_counter()
    text_step_card_vs_cpu(card)
    det = DetectorConfig()
    tree = seed0_tree()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    quiet = lambda *_: None     # noqa: E731
    try:
        csv = os.path.join(tmp, "welfake.csv")
        pd.DataFrame([{"text": words(rng, int(rng.integers(150, 320))),
                       "label": i % 2} for i in range(TRAIN_ROWS)]
                     ).to_csv(csv, index=False)
        out = os.path.join(tmp, "roberta")
        res, info = run_trainer(
            "roberta_detective", roberta_detective,
            lambda: roberta_detective.train(
                csv, out, epochs=1, batch_size=TRAIN_BATCH,
                max_len=TRAIN_LEN, det_cfg=det, params=tree, log=quiet,
                device="cuda"),
            TRAIN_BATCH * TRAIN_LEN, "tokens", out, tree, card)
        flops = roberta_flops(tree, det)
        share = flops / (info["ms"] / 1e3) / PEAK_OPS["bf16"]
        print(f"phase 28 roberta_detective: {flops / 1e12} TFLOP a step, "
              f"{share} of the bf16 dense peak ({PEAK_OPS['bf16'] / 1e12} "
              f"TFLOP/s), least time {flops / PEAK_OPS['bf16'] * 1e3} ms "
              f"[{card}]", flush=True)

        # the trainer's directory, served: the engine and the CLI
        cfg = ForensicsConfig(verbose=False)
        cfg = cfg.replace(paths=dataclasses.replace(
            cfg.paths, vault_path=vault_path, orbax_dir=out))
        t0 = time.perf_counter()
        served = F.MisinfoForensics(cfg, det, device="cuda",
                                    cuda_graphs=False)
        boot = time.perf_counter() - t0
        want = optimize_for_serving(clone_tree(res.params), served.policy,
                                    served.quant)
        equal = same_leaves(want, served.params,
                            ("roberta", "ai_head", "misinfo_head"))
        rep = served.load_report
        text = words(rng, 40)
        report = served.analyze(text, verbose=False)
        check_reports([report], "phase 28 native engine")
        print(f"phase 28: engine booted from the trainer's directory in "
              f"{boot} s, load_report mode {rep['mode']} (trainer "
              f"{rep.get('trainer')}, epoch {rep.get('epoch')}), text "
              f"branch torch.equal to the trained tree {equal}, analyze "
              f"verdict {report['verdict']}", flush=True)
        if not (rep["mode"] == "native" and equal):
            raise AssertionError(f"phase 28: native engine {rep['mode']}, "
                                 f"equal {equal}")
        del want
        out_json = os.path.join(tmp, "cli.json")
        t0 = time.perf_counter()
        rc = cli.main(["--checkpoint", out, "--text", text, "--vault",
                       vault_path, "--output", out_json, "--quiet"])
        cli_s = time.perf_counter() - t0
        with open(out_json) as f:
            got = json.load(f)
        same = got == json.loads(json.dumps(report))
        print(f"phase 28 CLI: --checkpoint rc {rc} in {cli_s} s (boot "
              f"included); its JSON equal to the engine's analyze: {same}",
              flush=True)
        if not (rc == 0 and same):
            raise AssertionError("phase 28: the CLI's output differs")
        del served, res
        gc.collect()
        torch.cuda.empty_cache()

        pngs = write_pngs(tmp, IMAGE_ITEMS)
        items = [(p, i % 2) for i, p in enumerate(pngs)]
        out = os.path.join(tmp, "cifake")
        run_trainer("cifake_efficientnet", cifake_efficientnet,
                    lambda: cifake_efficientnet.train(
                        "", out, epochs=1, batch_size=IMAGE_BATCH,
                        det_cfg=det, params=tree, items=items, log=quiet,
                        device="cuda"),
                    IMAGE_BATCH, "images", out, tree, card)
        gc.collect()

        pairs = os.path.join(tmp, "pairs.csv")
        n_match = IMAGE_ITEMS * 4 // 5
        pd.DataFrame([{"image_path": p, "text": words(rng, 12),
                       "label": int(i >= n_match)}
                      for i, p in enumerate(pngs)]).to_csv(pairs, index=False)
        out = os.path.join(tmp, "clip")
        res, _ = run_trainer(
            "clip_detective", clip_detective,
            lambda: clip_detective.train(
                pairs, out_dir=out, epochs=1, batch_size=IMAGE_BATCH,
                det_cfg=det, params=tree, log=quiet, device="cuda"),
            IMAGE_BATCH, "pairs", out, tree, card)
        trained = {("clip", "text_projection"), ("clip", "visual_projection"),
                   ("clip", "logit_scale")}
        from misinfo_tpu_torch.utils.tree import leaves_with_paths
        frozen = [torch.equal(a, b.cpu()) for (p, a), (_, b) in zip(
            leaves_with_paths(tree), leaves_with_paths(res.params))
            if p[:2] not in trained]
        moved = [not torch.equal(a, b.cpu()) for (p, a), (_, b) in zip(
            leaves_with_paths(tree), leaves_with_paths(res.params))
            if p[:2] in trained]
        print(f"phase 28 clip_detective: {sum(frozen)} of {len(frozen)} "
              f"frozen leaves torch.equal to their start, {sum(moved)} of "
              f"{len(moved)} trained ones moved", flush=True)
        if not (all(frozen) and all(moved)):
            raise AssertionError("phase 28: the CLIP trainer's freeze")
        del res
        gc.collect()
        torch.cuda.empty_cache()

        rows = [{"text": words(rng, int(rng.integers(20, 200))),
                 "image": pngs[i % len(pngs)], "label": i % 2}
                for i in range(FUSION_ROWS)]
        fusion_before = clone_tree(engine.params["fusion"])
        counts = {}
        for _ in range(3):          # the profiler may drop a record
            K1.launches = 0         # this path's run starts here
            with counting_runs(engine) as seen:
                (vecs, labels), rec = profiled(
                    lambda: fusion_judge.precompute_scores(
                        engine, rows, log=quiet), ("ffn_up_kernel",))
            launches = K1.launches  # read just after the sweep
            want = sum(PER_PROGRAM[v] for v in seen)
            counts = {"programs": list(seen), "want": want,
                      "launches": launches,
                      "records": rec["ffn_up_kernel"]}
            if counts["records"] >= want:
                break
        print(f"phase 28 fusion_judge: precompute_scores over "
              f"{FUSION_ROWS} rows: programs {counts['programs']}, K1 "
              f"launches {launches} and ffn_up_kernel records "
              f"{counts['records']} (want {want} = 36 x programs)",
              flush=True)
        if not (launches == want == counts["records"] and np.all(
                np.isfinite(vecs)) and np.any(vecs)):
            raise AssertionError(f"phase 28: the fusion sweep {counts}")
        out = os.path.join(tmp, "fusion")
        res, _ = run_trainer(
            "fusion_judge", fusion_judge,
            lambda: fusion_judge.train_on_scores(
                vecs, labels, engine.params, out, epochs=FUSION_EPOCHS,
                log=quiet, device="cuda"),
            16, "rows", out, seed0_tree(), card)
        intact = same_leaves(fusion_before, engine.params["fusion"])
        only_fusion = same_leaves(engine.params, res.params,
                                  ("roberta", "ai_head", "misinfo_head",
                                   "efficientnet", "clip"))
        print(f"phase 28 fusion_judge: the engine's own fusion leaves "
              f"untouched {intact}; every other branch of the trained tree "
              f"torch.equal to the engine's {only_fusion}", flush=True)
        if not (intact and only_fusion):
            raise AssertionError("phase 28: the fusion trainer touched "
                                 "what it does not own")
        del res
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 28: {time.perf_counter() - start} s in all", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def transcriber_from_native(want, weights, cfg, wav):
    """Phase 28, the transcriber: phase 27's HF ``.pt`` through
    ``checkpoints/convert.py --whisper`` into a native directory, loaded
    by ``WhisperTranscriber(checkpoint_dir=dir)``: its config phase 6's
    and its greedy tokens torch.equal to phase 6's transcriber's."""
    from misinfo_tpu_torch.checkpoints import convert
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    tr0 = want[0]
    d = tempfile.mkdtemp(prefix="chip_smoke_native_whisper_")
    try:
        pt = os.path.join(d, "whisper-base.pt")
        torch.save(export_whisper_hf(weights), pt)
        t0 = time.perf_counter()
        rc = convert.main(["--whisper", pt, "--out", os.path.join(d, "ck")])
        conv_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr = WhisperTranscriber(checkpoint_dir=os.path.join(d, "ck"),
                                device=tr0.device, decode_cfg=tr0.decode_cfg,
                                cuda_graphs=False)
        boot = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    mels, _ = prep_mel_windows(wav, 2 * cfg.max_source_positions, 1)
    with torch.inference_mode():
        prompt = torch.tensor(
            [tr.tokenizer.sot_sequence(language="en")[1:]], device=tr.device)
        tok = tr._decode(tr._encode(mels), prompt)[0]
        tok0 = tr0._decode(tr0._encode(mels), prompt)[0]
    same = torch.equal(tok, tok0)
    print(f"phase 28 transcriber: convert.py --whisper rc {rc} in {conv_s} "
          f"s, the directory's transcriber built in {boot} s: has_weights "
          f"{tr.has_weights}, config equal {tr.cfg == cfg}, greedy tokens "
          f"torch.equal to phase 6's {same}", flush=True)
    if not (rc == 0 and tr.has_weights and tr.cfg == cfg and same):
        raise AssertionError("phase 28: the converted transcriber differs")


# ------------------------------------------ training over a mesh (phase 31)

MESH_TEXT_B, MESH_TEXT_S = 16, 256
MESH_IMAGE_B = 32
MESH_FULL_B, MESH_FULL_S = 8, 128
MESH_F32_B, MESH_F32_S = 4, 64
# a bf16 mesh step's first loss against the single card's, relative, and
# its gradients' global norm (stated before the first card run)
MESH_BF16_LOSS, MESH_BF16_NORM = 1e-2, 5e-2
MESH_CLI_ROWS, MESH_CLI_BATCH = 48, 16
# phase 31 (d): the bf16 updates' gap ‖θ_two − θ_one‖ / ‖θ_one − θ_start‖
# between the two-process and the one-process runs. AdamW turns a
# gradient element at the bf16 rounding floor into an update of ±lr
# either way, so rounding alone leaves a gap (0.0585 on the tiny config
# over 4 steps, a CPU rehearsal); a gradient wrong in direction on a
# share of the elements moves it by O(1) (stated before the first card
# run)
MESH_UPDATE_GAP = 0.25


class CaptureTx:
    """An optimizer that keeps the gradients its first update gets (the
    first replica's, summed over data) before updating."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def update(self, grads, state):
        if self.grads is None:              # None: a leaf the loss skips
            self.grads = [(p, (torch.zeros_like(t) if g is None else g)
                           .detach().float().cpu())
                          for p, g, t in zip(state.paths, grads,
                                             state.leaves)]
        self.tx.update(grads, state)


def mesh_train_run(make, tree, mask, batch, grid, reps, lr=2e-5):
    """``reps`` steps of ``make(tx)`` from ``tree`` on one card (``grid``
    None) or over a (data, model) grid of the card named once a position:
    the first loss, the first update's gradients {path: g} (split pieces
    put back), the step ms (median after the first), the peak memory over
    what was allocated before, and whether every replica holds the same
    bits after the last step."""
    from misinfo_tpu_torch.core.mesh import place_train_batch
    from misinfo_tpu_torch.parallel.sharding import (
        merge_pieces, replica_leaves, shard_train_params)
    from misinfo_tpu_torch.train import optim, steps
    from misinfo_tpu_torch.utils.tree import clone_tree
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if grid is None:
        mesh, params = None, clone_tree(tree, "cuda")
        placed = steps.batch_to(batch, "cuda")
    else:
        mesh = one_card_mesh(*grid)
        params = shard_train_params(mesh, tree)
        placed = place_train_batch(mesh, batch)
    tx = optim.make_optimizer(optim.OptimConfig(
        lr=lr, warmup_fraction=0.0, total_steps=100), mask)
    cap = CaptureTx(tx)
    step = make(cap)
    state = tx.init(params)
    gen = torch.Generator("cuda").manual_seed(31)
    ms, losses = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, placed, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    same = True
    if mesh is not None:
        first = replica_leaves(params.rows[0])
        same = all(torch.equal(a, b) for row in params.rows[1:]
                   for (_, _, a), (_, _, b) in zip(first, replica_leaves(row)))
    grads = dict(merge_pieces([(p, 0, g) for p, g in cap.grads], "cpu"))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del params, state, placed
    return {"loss": losses[0], "losses": losses, "grads": grads,
            "ms": float(np.median(ms[1:])) if reps > 1 else ms[0],
            "peak_gb": peak, "replicas_equal": same}


def grads_apart(a, b) -> tuple:
    """(max |Δg| over every leaf / the largest |g|, the relative gap of
    the global norms) between two runs' gradients."""
    top = max(float(g.abs().max()) for g in a.values())
    diff = max(float((a[p] - b[p]).abs().max()) for p in a)
    na = math.sqrt(sum(float(g.double().square().sum()) for g in a.values()))
    nb = math.sqrt(sum(float(g.double().square().sum()) for g in b.values()))
    return diff / top, abs(na - nb) / na


def mesh_steps_phase(card):
    """Phase 31 (a): the training steps over grids of the one card named
    more than once, each held to the single-card step from the same tree
    and batch: f32 at a small batch within the CPU tests' band, bf16 at
    full size within the stated band; step ms and peak memory."""
    from misinfo_tpu_torch.core.config import PrecisionConfig
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops.common import Policy, set_exact_f32
    from misinfo_tpu_torch.train import optim, steps
    from misinfo_tpu_torch.train.clip_detective import clip_trainable_mask
    start = time.perf_counter()
    rng = np.random.default_rng(31)
    det = DetectorConfig()
    tree = seed0_tree()

    def branches(*names):          # a step places only what it reads
        return {k: tree[k] for k in names}
    text = branches("roberta", "ai_head", "misinfo_head")
    text_mask = optim.branch_mask(text, list(text))

    def text_batch(b, s):
        ids = rng.integers(3, det.roberta.vocab_size, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.int32)
        for i in range(1, b, 2):            # every other row padded
            n = int(rng.integers(s // 4, s))
            ids[i, n:], mask[i, n:] = det.roberta.pad_token_id, 0
        return {"input_ids": ids, "attention_mask": mask,
                "labels": (np.arange(b) % 2).astype(np.int32)}

    def images(b):
        return rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)

    def clip_ids(b):
        ids = rng.integers(1, det.clip.vocab_size - 2, (b, 77)).astype(
            np.int32)
        mask = np.ones((b, 77), np.int32)
        ids[:, 40] = det.clip.eos_token_id
        mask[:, 41:] = 0
        return ids, mask

    # f32 parity at a small batch, dropout off: within the CPU band
    cold = dataclasses.replace(det, roberta=dataclasses.replace(
        det.roberta, hidden_dropout=0.0))
    f32 = Policy(PrecisionConfig.highest())
    tf32 = torch.backends.cudnn.allow_tf32
    set_exact_f32(parity=True)
    try:
        batch = text_batch(MESH_F32_B, MESH_F32_S)
        runs = {g: mesh_train_run(
            lambda tx: steps.make_text_head_step(tx, cold, f32), text,
            text_mask, batch, g, 1) for g in (None, (2, 1), (1, 2))}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for g in ((2, 1), (1, 2)):
        r, s = runs[g], runs[None]
        gap, norm = grads_apart(s["grads"], r["grads"])
        print(f"phase 31 (a) f32 text step (RoBERTa-base, B {MESH_F32_B} × "
              f"{MESH_F32_S}) data={g[0]},model={g[1]} against one card: "
              f"loss {r['loss']} / {s['loss']} (|Δ| "
              f"{abs(r['loss'] - s['loss'])}, band 1e-5), max |Δg| / max|g| "
              f"{gap} (band 1e-5), norm gap {norm}, replicas equal "
              f"{r['replicas_equal']}", flush=True)
        if not (abs(r["loss"] - s["loss"]) <= 1e-5 and gap <= 1e-5
                and r["replicas_equal"]):
            raise AssertionError(f"phase 31 (a): the f32 mesh step {g}")
    del runs

    bf16 = Policy(PrecisionConfig(compute_dtype="bfloat16", gelu_mode="erf"))
    ids, mask = clip_ids(MESH_FULL_B)
    full_batch = {**text_batch(MESH_FULL_B, MESH_FULL_S), "clip_ids": ids,
                  "clip_mask": mask, "images_u8": images(MESH_FULL_B)}
    ids, mask = clip_ids(MESH_IMAGE_B)
    clip, effnet = branches("clip"), branches("efficientnet")
    cases = [
        ("text", f"RoBERTa detective B {MESH_TEXT_B} × {MESH_TEXT_S}",
         lambda tx: steps.make_text_head_step(tx, det, bf16), text,
         text_mask, text_batch(MESH_TEXT_B, MESH_TEXT_S), ((2, 1), (1, 2)),
         "tokens", MESH_TEXT_B * MESH_TEXT_S),
        ("clip", f"CLIP B {MESH_IMAGE_B}",
         lambda tx: steps.make_clip_step(tx, det, bf16), clip,
         clip_trainable_mask(clip),
         {"input_ids": ids, "attention_mask": mask,
          "images_u8": images(MESH_IMAGE_B)}, ((2, 1),), "pairs",
         MESH_IMAGE_B),
        ("effnet", f"EfficientNet-B0 B {MESH_IMAGE_B}",
         lambda tx: steps.make_effnet_step(tx, bf16), effnet,
         optim.branch_mask(effnet, ["efficientnet"]),
         {"images_u8": images(MESH_IMAGE_B),
          "labels": (np.arange(MESH_IMAGE_B) % 2).astype(np.int32)},
         ((2, 1),), "images", MESH_IMAGE_B),
        ("full", f"make_full_step B {MESH_FULL_B} × {MESH_FULL_S}",
         lambda tx: steps.make_full_step(tx, det, bf16), tree, None,
         full_batch, ((2, 2),), "rows", MESH_FULL_B)]
    rows = {}
    for kind, what, make, sub, m, batch, grids, unit, per in cases:
        reps = 2 if kind == "full" else 3
        single = mesh_train_run(make, sub, m, batch, None, reps)
        for g in grids:
            r = mesh_train_run(make, sub, m, batch, g, reps)
            rel = abs(r["loss"] - single["loss"]) / abs(single["loss"])
            _, norm = grads_apart(single["grads"], r["grads"])
            rows[kind, g] = {"ms": r["ms"], "single_ms": single["ms"],
                             "peak_gb": r["peak_gb"],
                             "single_peak_gb": single["peak_gb"]}
            print(f"phase 31 (a) bf16 {what} data={g[0]},model={g[1]}: step "
                  f"ms {r['ms']} against one card's {single['ms']} "
                  f"({per / r['ms'] * 1e3} against "
                  f"{per / single['ms'] * 1e3} {unit}/s), peak memory "
                  f"{r['peak_gb']} GB against {single['peak_gb']}; first "
                  f"loss {r['loss']} / {single['loss']} (rel {rel}, band "
                  f"{MESH_BF16_LOSS}), gradient norm gap {norm} (band "
                  f"{MESH_BF16_NORM}), replicas equal {r['replicas_equal']} "
                  f"[{card}]", flush=True)
            if not (rel <= MESH_BF16_LOSS and norm <= MESH_BF16_NORM
                    and r["replicas_equal"]
                    and all(math.isfinite(v) for v in r["losses"])):
                raise AssertionError(f"phase 31 (a): the bf16 {kind} step "
                                     f"over {g}")
        del single
        gc_cuda()
    print(f"phase 31 (a): {time.perf_counter() - start:.1f} s", flush=True)
    return rows


_SEED0 = {}


def seed0_tree():
    """``detector_init(0, DetectorConfig())``, built once for the phases
    that only copy it (the trainers clone their ``params``, the mesh
    placements copy, ``load_checkpoint`` reads its structure): a full
    tree takes seconds of host time to draw."""
    if not _SEED0:
        from misinfo_tpu_torch.models.detector import (
            DetectorConfig, detector_init)
        _SEED0["tree"] = detector_init(0, DetectorConfig())
    return _SEED0["tree"]


def gc_cuda() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


MESH_WORKER = r"""
import hashlib, sys, time
import torch
import torch.distributed as dist
from misinfo_tpu_torch.checkpoints import io as ckpt_io
from misinfo_tpu_torch.core import mesh as M
from misinfo_tpu_torch.train import clip_detective
from misinfo_tpu_torch.utils.tree import leaves_with_paths

csv, out, res_path = sys.argv[1:4]
t0 = time.perf_counter()
assert M.init_multihost() is True          # the JAX_* env path
rank, backend = dist.get_rank(), dist.get_backend()
probe = {}
x = torch.arange(4.0, device="cuda")
for name, fn in (
        ("all_reduce", lambda: dist.all_reduce(x.clone())),
        ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
        ("all_gather", lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x))):
    try:
        fn()
        torch.cuda.synchronize()
        probe[name] = "ok"
    except Exception as e:                 # gloo refuses some on CUDA
        probe[name] = f"{type(e).__name__}: {str(e)[:100]}"
saves = []
real_save = ckpt_io.save_checkpoint
ckpt_io.save_checkpoint = lambda *a, **k: (saves.append(1), real_save(*a, **k))
t1 = time.perf_counter()
res = clip_detective.main(["--train-csv", csv, "--out", out, "--epochs",
                           "1", "--batch-size", "%d", "--mesh", "data=2",
                           "--device", "cuda"])
train_s = time.perf_counter() - t1
digest = hashlib.sha256()
trained = {}
for p, t in leaves_with_paths(res.params):
    digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                  .tobytes())
    if p[:2] in (("clip", "text_projection"), ("clip", "visual_projection"),
                 ("clip", "logit_scale")):
        trained[p] = t.detach().cpu()
torch.save({"rank": rank, "backend": backend, "probe": probe,
            "digest": digest.hexdigest(), "trained": trained,
            "history": res.history, "saves": len(saves),
            "train_s": train_s, "wall_s": time.perf_counter() - t0},
           res_path)
M.shutdown_multihost()
print("MESH_WORKER_OK", rank, flush=True)
""" % MESH_CLI_BATCH


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_pair(script: str, args: list, tmp: str, name: str,
               timeout: float = 240) -> list:
    """``script`` in two processes (init_multihost's JAX_* env path over a
    free port), each given ``args`` and its result file; their results,
    after an AssertionError with the log if either failed."""
    slug = "".join(c if c.isalnum() else "_" for c in name)
    worker = os.path.join(tmp, f"{slug}.py")
    with open(worker, "w") as f:
        f.write(script)
    port = free_port()
    procs, results = [], []
    for pid in range(2):
        env = dict(os.environ)
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   MISINFO_TPU_DIST_TIMEOUT_S="120",
                   PYTHONPATH=os.pathsep.join(
                       [os.getcwd(), env.get("PYTHONPATH", "")]))
        results.append(os.path.join(tmp, f"{slug}{pid}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, worker, *args, results[-1]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        taken = [ln for ln in log.splitlines()
                 if ln.startswith("init_multihost:")]
        print(f"{name} rank {pid}: rc {p.returncode}; {taken}", flush=True)
        if p.returncode != 0 or "_OK" not in log:
            print(log[-4000:], flush=True)
            raise AssertionError(f"{name}: rank {pid} failed")
    return [torch.load(r, weights_only=False) for r in results]


def two_process_phase(vault_path, rng, card):
    """Phase 31 (b) and (c): the CLIP trainer's own CLI with ``--mesh
    data=2`` in two processes on the one card (init_multihost's JAX_*
    env path; gloo, as NCCL refuses two ranks on one device), held to the
    same training in one process over the card named twice; the engine
    boots from the one checkpoint directory; then ``--mesh data=2`` in
    one process refused."""
    import hashlib
    import pandas as pd
    from misinfo_tpu_torch.core import mesh as M
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops.serving import optimize_for_serving
    from misinfo_tpu_torch.train import clip_detective
    from misinfo_tpu_torch.utils.tree import leaves_with_paths
    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    quiet = lambda *_: None     # noqa: E731
    try:
        pngs = write_pngs(tmp, 24, seed=31)
        csv = os.path.join(tmp, "pairs.csv")
        pd.DataFrame([{"image_path": pngs[i % len(pngs)],
                       "text": words(rng, 12), "label": int(i % 4 == 3)}
                      for i in range(MESH_CLI_ROWS)]).to_csv(csv, index=False)
        out = os.path.join(tmp, "clip_mesh")
        r0, r1 = start_pair(MESH_WORKER, [csv, out], tmp, "phase 31 (b)")

        # the same training in one process, the card named twice
        entries = [(0, torch.device("cuda", 0))] * 2
        with swapped((M, "_global_entries", lambda: entries)):
            t0 = time.perf_counter()
            one = clip_detective.train(csv, out_dir=os.path.join(
                tmp, "clip_one"), epochs=1, batch_size=MESH_CLI_BATCH,
                mesh_spec="data=2", log=quiet, device="cuda")
            one_s = time.perf_counter() - t0
        digest = hashlib.sha256()
        gap = 0.0
        for p, t in leaves_with_paths(one.params):
            digest.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                          .numpy().tobytes())
            if p in r0["trained"]:
                gap = max(gap, float((t.detach().cpu() - r0["trained"][p])
                                     .abs().max()))
        ranks_equal = (r0["digest"] == r1["digest"] and all(
            torch.equal(a, r1["trained"][p]) for p, a in r0["trained"].items()))
        steps_run = len(r0["history"])
        dirs = sorted(d for d in os.listdir(tmp) if d.startswith("clip_"))
        print(f"phase 31 (b): backends {r0['backend']} / {r1['backend']}; "
              f"gloo on CUDA tensors: {r0['probe']}; ranks' trees "
              f"torch.equal {ranks_equal}; the trained leaves against one "
              f"process's data=2 run: max |Δ| {gap} (band 1e-6), whole "
              f"trees' digests equal {digest.hexdigest() == r0['digest']}; "
              f"checkpoint saves rank 0 {r0['saves']}, rank 1 "
              f"{r1['saves']}; directories {dirs}; train s {r0['train_s']} "
              f"/ {r1['train_s']} (one process {one_s}), worker wall "
              f"{r0['wall_s']} / {r1['wall_s']} [{card}]", flush=True)
        if not (r0["backend"] == r1["backend"] == "gloo" and ranks_equal
                and gap <= 1e-6 and r0["saves"] >= 1 and r1["saves"] == 0
                and steps_run >= 1):
            raise AssertionError("phase 31 (b): the two-process run")

        cfg = ForensicsConfig(verbose=False)
        cfg = cfg.replace(paths=dataclasses.replace(
            cfg.paths, vault_path=vault_path, orbax_dir=out))
        t0 = time.perf_counter()
        served = F.MisinfoForensics(cfg, DetectorConfig(), device="cuda",
                                    cuda_graphs=False)
        boot_s = time.perf_counter() - t0
        rep = served.load_report
        report = served.analyze(words(rng, 30), verbose=False)
        check_reports([report], "phase 31 (b) engine")
        want = optimize_for_serving(one.params, served.policy, served.quant)
        same = same_leaves(want, served.params, ("clip",))
        print(f"phase 31 (b): engine booted from the two-process run's "
              f"directory in {boot_s} s: load_report mode {rep['mode']} (trainer "
              f"{rep.get('trainer')}, epoch {rep.get('epoch')}), its CLIP "
              f"branch torch.equal to the trained one {same}, verdict "
              f"{report['verdict']}", flush=True)
        if not (rep["mode"] == "native" and rep.get("trainer")
                == "clip_detective" and same):
            raise AssertionError("phase 31 (b): the engine's boot")
        del served, one, want
        gc_cuda()

        # (c) in one process on one card, data=2 is refused
        try:
            clip_detective.main(["--train-csv", csv, "--out", os.path.join(
                tmp, "refused"), "--epochs", "1", "--mesh", "data=2",
                "--device", "cuda"])
            refused = "not refused"
        except ValueError as e:
            refused = str(e)
        print(f"phase 31 (c): --mesh data=2 in one process on one card: "
              f"{refused!r}", flush=True)
        if refused != "mesh 2x1 != 1 devices":
            raise AssertionError("phase 31 (c): not refused")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 31 (b, c): {time.perf_counter() - start:.1f} s",
          flush=True)


MODEL_WORKER = r"""
import hashlib, sys, time
import torch
import torch.distributed as dist
from misinfo_tpu_torch.checkpoints import io as ckpt_io
from misinfo_tpu_torch.core import mesh as M
from misinfo_tpu_torch.parallel import collectives as C
from misinfo_tpu_torch.train import roberta_detective as rd
from misinfo_tpu_torch.utils.tree import leaves_with_paths

csv, out, res_path = sys.argv[1:4]
t0 = time.perf_counter()
assert M.init_multihost() is True          # the JAX_* env path
rank, backend = dist.get_rank(), dist.get_backend()
ex = {"exchanges": 0, "sent": 0, "received": 0}
real_gather = C._all_gather


def counted(x, group, world, staged):
    ex["exchanges"] += 1
    ex["sent"] += x.numel() * x.element_size()
    ex["received"] += x.numel() * x.element_size() * (world - 1)
    return real_gather(x, group, world, staged)


C._all_gather = counted
steps = []
real_make = rd.make_text_head_step


def timed_make(*a, **k):
    step = real_make(*a, **k)

    def run(*args):
        torch.cuda.synchronize()
        before, t = dict(ex), time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t) * 1e3,
                      "loss": float(out[2]["loss"]),
                      **{k: ex[k] - before[k] for k in ex}})
        return out
    return run


rd.make_text_head_step = timed_make
saves = []
real_save = ckpt_io.save_checkpoint
ckpt_io.save_checkpoint = lambda *a, **k: (saves.append(1), real_save(*a, **k))
torch.cuda.reset_peak_memory_stats()
t1 = time.perf_counter()
res = rd.main(["--csv", csv, "--out", out, "--epochs", "1", "--batch-size",
               "%d", "--max-len", "%d", "--mesh", "data=1,model=2",
               "--device", "cuda"])
train_s = time.perf_counter() - t1
digest = hashlib.sha256()
for p, t in leaves_with_paths(res.params):
    digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                  .tobytes())
torch.save({"rank": rank, "backend": backend, "digest": digest.hexdigest(),
            "history": res.history, "saves": len(saves), "steps": steps,
            "exchanges": dict(ex), "peak_gb":
            torch.cuda.max_memory_allocated() / 1e9, "train_s": train_s,
            "wall_s": time.perf_counter() - t0}, res_path)
M.shutdown_multihost()
print("MODEL_WORKER_OK", rank, flush=True)
""" % (MESH_TEXT_B, MESH_TEXT_S)
MODEL_CLI_ROWS = 48       # 39 training rows: two steps of 16, 9 to eval


def model_group_phase(rng, card):
    """Phase 31 (d): the RoBERTa detective's CLI with ``--mesh
    data=1,model=2`` in two processes on the one card (gloo), the model
    group across them, held to the same training in one process over the
    card named twice."""
    import pandas as pd
    from misinfo_tpu_torch.checkpoints.io import load_checkpoint
    from misinfo_tpu_torch.core import mesh as M
    from misinfo_tpu_torch.train import optim, roberta_detective
    from misinfo_tpu_torch.utils.tree import leaves_with_paths
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_model_group_")
    try:
        csv = os.path.join(tmp, "text.csv")
        pd.DataFrame([{"text": words(rng, int(rng.integers(60, 400))),
                       "label": int(i % 3 == 0)}
                      for i in range(MODEL_CLI_ROWS)]).to_csv(csv,
                                                              index=False)
        out = os.path.join(tmp, "two")
        r0, r1 = start_pair(MODEL_WORKER, [csv, out], tmp,
                            "phase 31 (d)")
        # the same training in one process over the card named twice,
        # from the CLI's own start (detector_init(0)), its step losses kept
        start = seed0_tree()
        one_losses = []
        make = roberta_detective.make_text_head_step

        def recorded(*a, **k):
            step = make(*a, **k)

            def run(*args):
                out = step(*args)
                one_losses.append(float(out[2]["loss"]))
                return out
            return run
        entries = [(0, torch.device("cuda", 0))] * 2
        with swapped((M, "_global_entries", lambda: entries),
                     (roberta_detective, "make_text_head_step", recorded)):
            t0 = time.perf_counter()
            one = roberta_detective.train(
                csv, os.path.join(tmp, "one"), epochs=1,
                batch_size=MESH_TEXT_B, max_len=MESH_TEXT_S, params=start,
                mesh_spec="data=1,model=2", log=lambda *_: None,
                device="cuda")
            one_s = time.perf_counter() - t0
        two = load_checkpoint(out, one.params)
        n = len(r0["steps"])
        sched = optim.make_schedule(optim.OptimConfig(
            lr=2e-5, warmup_fraction=0.1, total_steps=n))
        band = 2.1 * sum(sched(c) for c in range(n))
        trained = ("roberta", "ai_head", "misinfo_head")
        gap, frozen_equal, apart, moved = 0.0, True, 0.0, 0.0
        for (p, a), (_, b), (_, s0) in zip(leaves_with_paths(one.params),
                                           leaves_with_paths(two),
                                           leaves_with_paths(start)):
            if p[0] in trained:          # on the card: 0.5 GB of leaves
                a, b = a.float(), b.to(a.device).float()
                gap = max(gap, float((a - b).abs().max()))
                apart += float((a - b).double().square().sum())
                moved += float((a - s0.to(a.device)).double().square().sum())
            else:
                frozen_equal &= torch.equal(a, b.to(a.device))
        # the updates' gap: ‖θ_two − θ_one‖ / ‖θ_one − θ_start‖
        update_gap = math.sqrt(apart / moved)
        losses = [(k, a[k], b[k]) for a, b in zip(one.history, r0["history"])
                  for k in a if k.endswith("loss")]
        rel = max(abs(a - b) / abs(a) for _, a, b in losses)
        per = [[st for st in r["steps"]] for r in (r0, r1)]
        print(f"phase 31 (d): RoBERTa detective CLI, --mesh data=1,model=2 "
              f"over two processes (backends {r0['backend']} / "
              f"{r1['backend']}), {n} steps of B {MESH_TEXT_B} × "
              f"{MESH_TEXT_S} in bf16: step ms rank 0 "
              f"{[st['ms'] for st in per[0]]}, rank 1 "
              f"{[st['ms'] for st in per[1]]}; a step's exchanges "
              f"{[st['exchanges'] for st in per[0]]}, bytes sent "
              f"{[st['sent'] for st in per[0]]} and received "
              f"{[st['received'] for st in per[0]]} a rank; the run's "
              f"{r0['exchanges']} (eval and gathers included); peak memory "
              f"{r0['peak_gb']} / {r1['peak_gb']} GB; train s "
              f"{r0['train_s']} / {r1['train_s']} (one process {one_s}), "
              f"worker wall {r0['wall_s']} / {r1['wall_s']} [{card}]",
              flush=True)
        two_losses = [st["loss"] for st in r0["steps"]]
        print(f"phase 31 (d): ranks' trees torch.equal "
              f"{r0['digest'] == r1['digest']}; against one process over "
              f"the card named twice: step losses {two_losses} / "
              f"{one_losses} (the first equal: the forward folds in the "
              f"same order), the history's {losses} (max rel {rel}, band "
              f"{MESH_BF16_LOSS}), the updates' gap {update_gap} (band "
              f"{MESH_UPDATE_GAP}), trained leaves max |Δ| {gap} (band "
              f"{band}: 2.1 × the summed learning rate), frozen leaves "
              f"torch.equal {frozen_equal}; checkpoint saves rank 0 "
              f"{r0['saves']}, rank 1 {r1['saves']}", flush=True)
        if not (r0["backend"] == r1["backend"] == "gloo"
                and r0["digest"] == r1["digest"] and n >= 1
                and len(r1["steps"]) == n == len(one_losses)
                and two_losses[0] == one_losses[0]
                and rel <= MESH_BF16_LOSS and update_gap <= MESH_UPDATE_GAP
                and gap <= band and frozen_equal and r0["saves"] >= 1
                and r1["saves"] == 0
                and all(math.isfinite(v) for _, v, _ in losses)):
            raise AssertionError("phase 31 (d): the model group across "
                                 "processes")
        del one, two
        gc_cuda()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 31 (d): {time.perf_counter() - t_start:.1f} s", flush=True)


# ------------------------------------------------------------------- bounds

# H100 SXM peaks, dense, from NVIDIA's data sheet: HBM3 bytes and
# operations per second by operand type
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(moved: float, ops: float, kind: str):
    """The least time the card could take (ms): the bytes moved over the
    memory rate or the operations over the peak rate of their type,
    whichever is larger."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# -------------------------------------------------------------------- vault

BIG_ROWS = 1 << 20                  # 512 × INT4_TILE_ROWS
# the engine phases' vault (10-14, 30 (b, c)): a quarter of BIG_ROWS, still
# 4 × int4.KERNEL_MIN_ROWS; every boot reads and converts the whole f32
# file on the host, which at BIG_ROWS took most of the script's time
VAULT_ROWS = BIG_ROWS // 4
RAGGED_ROWS = BIG_ROWS - 1971       # not a multiple of 2048, nor of 128
K10_BATCHES = (1, 8, 32)
SEP = 0.75         # most a request image may resemble another planted one
PLANT_SIGMA = 0.005                 # noise per element of a planted row


def check_int4_kernels(K10, IC, card):
    """Phase 9: K10a/K10b against their plain versions at 1,048,576 rows
    (B = 1, 8, 32) and at a ragged row count (B = 3): K10b bit for bit,
    K10a within its band with the planted faults outside it; CUDA-event
    times and the kernels' share of the HBM bandwidth."""
    packed, scale = IC.vault_case(BIG_ROWS, device="cuda")
    rows = {}
    for b, n in [(b, BIG_ROWS) for b in K10_BATCHES] + [(3, RAGGED_ROWS)]:
        pk, sc = packed[:n], scale[:n]
        q = IC.query_case(b, seed=b, device="cuda")
        ra = IC.check_k10a(q, pk, sc)
        IC.check_k10b(q, pk, sc)
        torch.cuda.synchronize()
        moved = n * (q.shape[1] // 2 + 4) + b * n * 4
        for name, fn, plain in (
                ("int4_sims", K10.int4_sims, K10.int4_sims_plain),
                ("int4_sims_i8", K10.int4_sims_i8, K10.int4_sims_i8_plain)):
            ms = cuda_ms(lambda: fn(q, pk, sc), 20)
            plain_ms = cuda_ms(lambda: plain(q, pk, sc), 3)
            err = ra["err"] if name == "int4_sims" else 0.0
            extra = (f" (band up to {ra['band']}; {ra['faults']} planted "
                     f"faults, nearest at {ra['nearest_fault']:.1f} bands)"
                     if name == "int4_sims" else " (bitwise equal)")
            print(f"{name} B={b} N={n}: max_abs_err={err}{extra} "
                  f"kernel_ms={ms} plain_ms={plain_ms} "
                  f"kernel_GB/s={moved / ms / 1e6:.1f} "
                  f"({moved / ms * 1e3 / PEAK_BYTES_PER_S:.1%} of 3.35 TB/s) "
                  f"[{card}]", flush=True)
            row = rows.setdefault(name, {"errs": []})
            row["errs"].append(err)
            if n == BIG_ROWS and b == 32:
                row.update(ms=ms, plain_ms=plain_ms, **bound(
                    moved, 2 * b * n * q.shape[1],
                    "int8" if name == "int4_sims_i8" else "bf16"))
    del packed, scale
    return {k: {"err": max(v.pop("errs")), **v} for k, v in rows.items()}


def vault_params():
    """Seeded detector weights (host, f32) for the vault phases, with the
    CLIP vision tower's class and position embeddings zeroed: with them a
    random-weight image embedding is dominated by the image-independent
    class token (in DetectorConfig.tiny() two noise images sit at cosine
    0.99), and no request could stay below the 0.85 reuse gate."""
    from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
    params = detector_init(0, DetectorConfig())
    for k in ("class_embedding", "position_embedding"):
        params["clip"]["vision"][k].zero_()
    return params


def vault_engine(params, path, cuda_graphs=False, mesh=None, **serving):
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    cfg = ForensicsConfig(verbose=False)
    cfg = cfg.replace(paths=dataclasses.replace(cfg.paths, vault_path=path),
                      serving=dataclasses.replace(cfg.serving, **serving))
    t0 = time.perf_counter()
    eng = MisinfoForensics(cfg, DetectorConfig(), params=params, mesh=mesh,
                           device="cuda", cuda_graphs=cuda_graphs)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def clip_embeddings(eng, images=(), captions=()):
    """The engine's l2-normalized CLIP embeddings of images (one at a
    time, as the visual branch computes them) or of captions."""
    from misinfo_tpu_torch.models.clip import (
        clip_image_features, clip_text_features)
    from misinfo_tpu_torch.ops.common import l2_normalize
    from misinfo_tpu_torch.ops.image_ops import normalize_images
    out = []
    with torch.inference_mode():
        for im in images:
            x = normalize_images(
                eng._image_batch([im], 1)["image_clip"].to(eng.device),
                "clip", eng.policy.compute)
            out.append(l2_normalize(clip_image_features(
                eng.params["clip"], x, eng.det_cfg.clip, eng.policy)))
        for c in captions:
            ids, mask = eng.clip_tokenizer.batch([c], eng._cl_len)
            out.append(l2_normalize(clip_text_features(
                eng.params["clip"], eng._tensor(ids), eng._tensor(mask),
                eng.det_cfg.clip, eng.policy)))
    return torch.cat(out).float().cpu().numpy()


def block_image(seed: int) -> np.ndarray:
    """A 224×224 image of 14×14 random 16-pixel blocks, each channel 0 or
    255: of the generators tried on the card (noise, 7×7 or 2×2 blocks of
    any colour) the one whose random-weight embeddings spread most."""
    cells = np.random.default_rng(seed).integers(0, 2, (14, 14, 3)) * 255
    return np.repeat(np.repeat(cells.astype(np.uint8), 16, axis=0), 16,
                     axis=1)


def pick_images(emb: np.ndarray, n_planted: int, n_other: int = 4):
    """Request images from a pool whose embeddings are all below SEP
    cosine of each other (the gate is 0.85), chosen farthest-first: the
    first ``n_planted`` to plant, the rest to stay unmatched."""
    c = emb @ emb.T
    sel = [int(np.argmin(c.mean(axis=1)))]
    while len(sel) < n_planted + n_other:
        rest = [i for i in range(len(emb)) if i not in sel]
        j = min(rest, key=lambda i: c[i, sel].max())
        if not c[j, sel].max() < SEP:
            break
        sel.append(j)
    off = c[np.triu_indices(len(emb), 1)]
    print(f"request image pool: {len(emb)} images, pairwise cosine "
          f"{off.min():.3f}..{off.max():.3f} (mean {off.mean():.3f}); "
          f"{len(sel)} chosen, each below {SEP} of the others", flush=True)
    if len(sel) < n_planted + n_other:
        raise AssertionError("the request images are too alike to plant "
                             "near-duplicates that others cannot match")
    return sel[:n_planted], sel[n_planted:]


def write_vault(path, rows, titles, n, planted, seed):
    """A vault of n random unit rows (and title rows) with planted rows
    {index: (image embedding, title embedding)}; f32, written once."""
    from misinfo_tpu_torch.vault.store import TruthVault
    d = len(next(iter(planted.values()))[0])
    if rows is None:
        seqs = np.random.SeedSequence(seed).spawn(16)
        rows = np.empty((n, d), np.float32)
        titles = np.empty((n, d), np.float32)
        step = -(-n // 8)

        def fill(i):
            r = np.random.default_rng(seqs[i])
            sl = slice((i % 8) * step, min(n, (i % 8 + 1) * step))
            dst = rows if i < 8 else titles
            dst[sl] = r.standard_normal((sl.stop - sl.start, d),
                                        dtype=np.float32)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(fill, range(16)))
    rng = np.random.default_rng(seed + 1)
    for i, (e, t) in planted.items():
        rows[i] = e + PLANT_SIGMA * rng.standard_normal(d)
        titles[i] = t
    meta = [{"title": f"Guardian archive {i}", "url": f"u{i}",
             "date": "2024-01-01"} for i in range(n)]
    TruthVault(rows, meta, titles).save(path)
    return rows, titles


@contextlib.contextmanager
def counting_programs(S):
    """Count the engine's visual program calls (full, visual_only) for
    the duration of the block."""
    real = S.signals_program
    seen = {"visual": 0}

    def spy(params, batch, *, variant, **kw):
        if variant in ("full", "visual_only"):
            seen["visual"] += 1
        return real(params, batch, variant=variant, **kw)
    S.signals_program = spy
    try:
        yield seen
    finally:
        S.signals_program = real


def top(report):
    m = report["vault_matches"]
    return (m[0]["title"], m[0]["similarity"]) if m else (None, None)


def check_vault_reports(reports, plants, what):
    """Planted requests at top-1 with their title and the gate open;
    every other request with the gate shut."""
    check_reports(reports, what)
    for i, r in enumerate(reports):
        gate = r["scores"]["vault_discrepancy"]
        if i in plants:
            title, _ = top(r)
            want = f"Guardian archive {plants[i]}"
            if title != want or not gate > 0.85:
                raise AssertionError(f"{what}: request {i} matched {title} "
                                     f"(want {want}) at {gate}")
        elif gate != 0.0:
            raise AssertionError(f"{what}: unplanted request {i} has "
                                 f"vault_discrepancy {gate} ({top(r)})")


def search_call(eng, q):
    """One vault_search of the query batch q on the engine's planes."""
    from misinfo_tpu_torch.vault.search import vault_search
    dev = eng._vault_device
    ivf = ({k: v for k, v in dev.items() if k.startswith("ivf_")}
           if "ivf_centroids" in dev else None)
    return lambda: vault_search(q, dev["vault_emb"], dev["vault_valid"],
                                top_k=5, ivf=ivf,
                                vault_scale=dev.get("vault_scale"))


def search_ms(eng, q32):
    """ms of one vault_search at B = 32 on the engine's device planes."""
    return cuda_ms(search_call(eng, q32), 10)


def vault_phases(card, small_vault, profile=None):
    """Phases 10-14: the vault capacity modes at 262,144 rows. Returns
    the K10a / K10b launch counts of their main-path runs. With
    ``profile``, appends profiler tables of the int4 engine's batch of 32
    and of one int4 vault_search at B = 32."""
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.engine import signals as S
    from misinfo_tpu_torch.vault import int4 as K10
    from misinfo_tpu_torch.vault import ivf as IVF
    from misinfo_tpu_torch.vault import prepack
    params = vault_params()
    probe, _ = vault_engine(params, "")
    pool = [block_image(100 + i) for i in range(32)]
    emb = clip_embeddings(probe, images=pool)
    planted, others = pick_images(emb, 7)
    captions = [f"Archived photo number {i} of the flood" for i in range(4)]
    cap_emb = clip_embeddings(probe, captions=captions)
    rng = np.random.default_rng(4)
    del probe
    # requests 0-3 full and 4-5 visual_only planted; 6-31 unplanted;
    # planted[6] is the row the reload appends
    reqs = ([{"text": captions[i], "image": pool[planted[i]]}
             for i in range(4)]
            + [{"image": pool[planted[i]]} for i in (4, 5)]
            + [{"text": words(rng, 20), "image": pool[others[i % len(others)]]}
               for i in range(22)]
            + [{"image": pool[others[i % len(others)]]} for i in range(4)])
    rows_at = {i: 1000 + VAULT_ROWS // 6 * i for i in range(6)}
    plant_rows = {rows_at[i]: (emb[planted[i]],
                               cap_emb[i] if i < 4 else emb[planted[i]])
                  for i in range(6)}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vault_")
    path = os.path.join(tmp, "vault.npz")
    t0 = time.perf_counter()
    rows, titles = write_vault(path, None, None, VAULT_ROWS, plant_rows, 5)
    print(f"vault: {VAULT_ROWS} rows × {emb.shape[1]} (f32 image + title "
          f"planes) made "
          f"and written in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 10: the int4 engine at 262,144 rows, two boots; the second
    # with CUDA graphs, for phase 26 (the checks below run on the first)
    eng, boot1 = vault_engine(params, path, vault_dtype="int4")
    if not os.path.exists(prepack.sidecar_path(path)):
        raise AssertionError("the first int4 boot wrote no sidecar")
    real_build = prepack.build_prepacked
    builds = []
    prepack.build_prepacked = lambda v: builds.append(1) or real_build(v)
    geng, boot2 = vault_engine(params, path, cuda_graphs=True,
                               vault_dtype="int4")
    prepack.build_prepacked = real_build
    print(f"int4 engine boot: first {boot1:.1f} s (quantized both planes, "
          f"wrote {os.path.basename(prepack.sidecar_path(path))}), second "
          f"{boot2:.1f} s ({len(builds)} re-quantizations)", flush=True)
    if builds:
        raise AssertionError("the second boot re-quantized the vault")
    stamp("10 (vault written, two int4 boots)")
    d = emb.shape[1]
    if any(tuple(e._vault_device["vault_emb"].shape) != (VAULT_ROWS, d // 2)
           for e in (eng, geng)):
        raise AssertionError("int4 device plane shape")

    with counting_programs(S) as seen:
        K10.launches = K10.launches_i8 = 0      # this path's run starts here
        t0 = time.perf_counter()
        single = eng.analyze(reqs[0]["text"], reqs[0]["image"],
                             verbose=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batch = eng.analyze_batch(reqs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k10 = (K10.launches, K10.launches_i8)   # read just after the path
    plants = {i: rows_at[i] for i in range(6)}
    check_vault_reports([single], {0: rows_at[0]}, "int4 analyze")
    check_vault_reports(batch, plants, "int4 analyze_batch")
    print(f"int4 engine: analyze {1e3 * (t1 - t0):.1f} ms, analyze_batch "
          f"of 32 {1e3 * (t2 - t1):.1f} ms [{card}]; visual programs "
          f"{seen['visual']}, K10b launches {k10[1]}, K10a {k10[0]}",
          flush=True)
    if k10 != (0, seen["visual"]) or seen["visual"] != 3:
        raise AssertionError(f"K10 launches {k10} for {seen['visual']} "
                             "visual programs (want K10b once each)")

    # phase 10, video: one video_text group of 16 videos × 12 frames; the
    # first video's third frame is planted image 0 (its caption planted as
    # that row's title), every other frame an unplanted image
    frames_of = {f"video {v}": [pool[others[(v + f) % len(others)]]
                                for f in range(12 - v % 4)]
                 for v in range(VIDEO_GROUP)}
    frames_of["video 0"][2] = pool[planted[0]]
    vreqs = ([{"video": "video 0", "text": captions[0]}]
             + [{"video": f"video {v}", "text": words(rng, 20)}
                for v in range(1, VIDEO_GROUP)])
    sampler = (F, "sample_video_frames", seeded_sampler(frames_of.get))
    with swapped(sampler), counting_video_programs(S) as vseen:
        K10.launches = K10.launches_i8 = 0      # this path's run starts here
        t0 = time.perf_counter()
        vbatch = eng.analyze_batch(vreqs)
        torch.cuda.synchronize()
        vsec = time.perf_counter() - t0
        k10v = (K10.launches, K10.launches_i8)  # read just after the path
    check_vault_reports(vbatch, {0: rows_at[0]}, "int4 video_text group")
    print(f"int4 engine, video_text group of {VIDEO_GROUP} "
          f"({VIDEO_GROUP * 12} frame rows): {1e3 * vsec:.1f} ms; video "
          f"programs {len(vseen)}, K10b launches {k10v[1]} (want "
          f"{-(-VIDEO_GROUP * 12 // K10.MAX_BATCH)}), K10a {k10v[0]}; video "
          f"0 top-1 {top(vbatch[0])} [{card}]", flush=True)
    if (len(vseen) != 1 or vseen[0]["frames"] != (VIDEO_GROUP, 12)
            or k10v != (0, -(-VIDEO_GROUP * 12 // K10.MAX_BATCH))):
        raise AssertionError(f"K10 launches {k10v} for the video group's "
                             f"{len(vseen)} program(s)")

    # phase 26, int4: the second boot (CUDA graphs) warmed and replayed
    t0 = time.perf_counter()
    gsigs = geng.warmup(batch_sizes=(8, 32),
                        variants=("full", "visual_only"), videos=(16,))
    warm_s = time.perf_counter() - t0
    with swapped(sampler):
        for name, rq in (("batch of 32", reqs), ("video_text group", vreqs)):
            geng.analyze_batch(rq)
            want, _ = dispatch_outputs(eng, rq)
            got, kg, rec = replay_profiled(
                geng, rq, "int4_sims_kernel",
                lambda: {"K10a": K10.launches, "K10b": K10.launches_i8})
            kg = (kg["K10a"], kg["K10b"])
            same = same_bits(got, want)
            want_k = (0, -(-VIDEO_GROUP * 12 // K10.MAX_BATCH)
                      if name == "video_text group" else 2)
            print(f"phase 26 int4 engine (the second boot, warmup of "
                  f"{len(gsigs)} signatures {warm_s} s), {name}: replay "
                  f"torch.equal to eager {same}, K10b launches {kg[1]}, "
                  f"K10a {kg[0]} (want {want_k[1]}, {want_k[0]}; "
                  f"torch.profiler: {rec} int4_sims_kernel records in that "
                  f"replay) [{card}]", flush=True)
            if not (same and kg == want_k and rec == sum(kg)):
                raise AssertionError(f"phase 26 int4 {name}: equal {same}, "
                                     f"K10 {kg} (want {want_k}), profiler "
                                     f"{rec}")
    del geng
    stamp("10, 26 (int4 engine)")

    # phase 11: the same vault in the other dtypes (f32 is the reference)
    q32 = torch.nn.functional.normalize(
        torch.randn(32, d, generator=torch.Generator().manual_seed(3)),
        dim=1).to(eng.device)
    if profile:
        append_profile(profile, f"int4 vault ({VAULT_ROWS} rows) "
                       "analyze_batch of 32", lambda: eng.analyze_batch(reqs))
        append_profile(profile, "int4 vault_search at B = 32",
                       search_call(eng, q32))
    report = {"int4": (eng.memory_report(), search_ms(eng, q32))}
    f32, boot = vault_engine(params, path)
    ref = f32.analyze_batch(reqs)
    check_vault_reports(ref, plants, "f32 analyze_batch")
    with swapped(sampler):
        vref = f32.analyze_batch(vreqs)
    check_vault_reports(vref, {0: rows_at[0]}, "f32 video_text group")
    print(f"video_text group, int4 vs f32 vault: top-1 of video 0 "
          f"{top(vbatch[0])} vs {top(vref[0])}", flush=True)
    if top(vbatch[0])[0] != top(vref[0])[0]:
        raise AssertionError("the int4 and f32 vaults disagree on the "
                             "planted video's top-1")
    drift = 0.0
    for i in plants:
        a, b = batch[i], ref[i]
        if top(a)[0] != top(b)[0]:
            raise AssertionError(f"request {i}: int4 top-1 {top(a)[0]} vs "
                                 f"f32 {top(b)[0]}")
        sims = [m["similarity"] for m in a["vault_matches"]]
        want = [m["similarity"] for m in b["vault_matches"]]
        drift = max([drift, *(abs(x - y) for x, y in zip(sims, want)),
                     *(abs(a["scores"][k] - b["scores"][k]) for k in
                       ("vault_discrepancy", "text_similarity"))])
    print(f"int4 vs f32 engine, planted requests: same top-1, max sim "
          f"drift {drift} (limit 0.05); f32 boot {boot:.1f} s", flush=True)
    if not drift < 0.05:
        raise AssertionError(f"int4 sims drift {drift} from f32's")
    report["float32"] = (f32.memory_report(), search_ms(f32, q32))
    host_vault = f32.vault          # phase 30 (b, c) boots on it
    del f32
    for dt in ("bfloat16", "int8"):
        e, boot = vault_engine(params, path, vault_dtype=dt)
        report[dt] = (e.memory_report(), search_ms(e, q32))
        print(f"{dt} engine boot {boot:.1f} s", flush=True)
        del e
    for dt, (mem, ms) in report.items():
        print(f"vault_dtype={dt}: vault_search B=32 {ms} ms; memory_report "
              f"{json.dumps(mem)} [{card}]", flush=True)

    stamp("11")
    k10_mesh = mesh_vault_phase(params, path, reqs, plants, q32,  # 30 (b, c)
                                card, host_vault)
    del host_vault
    stamp("30 (b, c)")

    # phase 12: IVF over the same f32 vault, built on the card
    real_ivf = IVF.build_ivf
    built = {}

    def timed_build(*a, **kw):
        t = time.perf_counter()
        out = real_ivf(*a, **kw)
        torch.cuda.synchronize()
        built.update(seconds=time.perf_counter() - t, clusters=out.n_clusters,
                     spill=int((out.spill >= 0).sum()))
        return out
    IVF.build_ivf = timed_build
    try:
        ivf_eng, boot = vault_engine(params, path, vault_ivf=True)
    finally:
        IVF.build_ivf = real_ivf
    ivf_reqs = reqs[:6] + reqs[6:8] + reqs[28:30]
    got = ivf_eng.analyze_batch(ivf_reqs)
    check_vault_reports(got, plants, "IVF analyze_batch")
    print(f"IVF: built on the card in {built['seconds']:.1f} s "
          f"({built['clusters']} clusters, {built['spill']} spilled rows), "
          f"engine boot {boot:.1f} s; analyze_batch of {len(ivf_reqs)} found "
          f"every planted row; vault_search B=32 {search_ms(ivf_eng, q32)} "
          f"ms [{card}]", flush=True)
    del ivf_eng
    stamp("12")

    # phase 13: reload_vault(drop_first=True) onto the vault with rows
    # appended, one of them planted
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    extra = 4096
    new_row = VAULT_ROWS + 100
    rng = np.random.default_rng(6)
    more = rng.standard_normal((extra, d)).astype(np.float32)
    path2 = os.path.join(tmp, "vault_grown.npz")
    write_vault(path2, np.concatenate([rows, more]),
                np.concatenate([titles, more[::-1]]), VAULT_ROWS + extra,
                {new_row: (emb[planted[6]], emb[planted[6]])}, 7)
    del rows, titles
    t0 = time.perf_counter()
    info = eng.reload_vault(path2, drop_first=True)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    grown = eng.analyze_batch([{"image": pool[planted[6]]}, reqs[4],
                               reqs[6]])
    check_vault_reports(grown, {0: new_row, 1: rows_at[4]},
                        "after reload_vault")
    print(f"reload_vault(drop_first=True): {info} in {reload_s:.1f} s; the "
          f"appended row {new_row} is found", flush=True)
    del eng

    # phase 14: an int4 vault below KERNEL_MIN_ROWS runs K10a
    small, _ = vault_engine(params, small_vault, vault_dtype="int4")
    rng = np.random.default_rng(8)
    small_reqs = ([{"image": pool[i]} for i in others[:3]]
                  + [{"text": words(rng, 20), "image": pool[planted[0]]}])
    with counting_programs(S) as seen:
        K10.launches = K10.launches_i8 = 0      # this path's run starts here
        out = small.analyze_batch(small_reqs)
        torch.cuda.synchronize()
        k10a = (K10.launches, K10.launches_i8)  # read just after the path
    check_reports(out, "int4 small-vault analyze_batch")
    print(f"int4 engine, {small.vault.num_articles}-row vault: visual "
          f"programs {seen['visual']}, K10a launches {k10a[0]}, K10b "
          f"{k10a[1]}", flush=True)
    if k10a != (seen["visual"], 0) or not seen["visual"]:
        raise AssertionError(f"K10 launches {k10a} on the small vault")
    shutil.rmtree(tmp)
    return {"int4_sims": k10a[0],
            "int4_sims_i8": k10[1] + k10v[1] + k10_mesh}


# ------------------------------------------------------- opt-in kernel modes

OPT_SHAPES = {                      # the main path's shapes at full b32/S512
    "int8_dense": (("roberta", 32 * 512, 768, 768),
                   ("clip_text", 32 * 77, 512, 512),
                   ("clip_vision", 32 * 50, 768, 768)),
    "fused_attention": (("roberta", 32, 512, 12, True, False),
                        ("clip_text", 32, 77, 8, True, True),
                        ("clip_vision", 32, 50, 12, False, False)),
    "fused_ffn": (("roberta", 32 * 512, 768, 3072, "tanh"),
                  ("clip_text", 32 * 77, 512, 2048, "quick"),
                  ("clip_vision", 32 * 50, 768, 3072, "quick"),
                  ("whisper_decode", 32, 512, 2048, "tanh"),
                  ("whisper_tiny_decode", 32, 384, 1536, "tanh"),
                  ("whisper_medium_decode", 32, 1024, 4096, "tanh"),
                  ("whisper_large_decode", 32, 1280, 5120, "tanh")),
}


# phases 16-17: (label, quant, use_pallas, launches of one analyze of a
# 300-word request, launches of the b32/S512 batch). 12 layers per tower;
# K2 takes the 4 projections of a tower whose rows reach 256 (RoBERTa
# 512 / 16,384, CLIP text 77 / 2,464, CLIP vision 50 / 1,600)
OPT_ENGINES = (
    ("I", "int8", True,
     {"int8_dense": 48, "int8_ffn": 36, "fused_attention": 36},
     {"int8_dense": 144, "int8_ffn": 36, "fused_attention": 36}),
    ("II", "none", "ffn", {"fused_ffn": 36}, {"fused_ffn": 36}))


def _report(what, res, card) -> None:
    extra = (f"bitwise equal (a one-ulp scale fault moves "
             f"{res['fault_elements']} outputs)" if "fault_elements" in res
             else f"max_abs_err={res['err']} (band up to {res['band']}; "
                  f"worst {res['worst']:.3f} of the band; {res['faults']} "
                  f"planted faults, nearest at "
                  f"{res['nearest_fault']:.1f} bands)")
    print(f"{what}: {extra} [{card}]", flush=True)


def _timed(name, fn, plain, library, moved, ops, kind, card, reps=20):
    row = {"ms": cuda_ms(fn, reps), "plain_ms": cuda_ms(plain, 3),
           "library_ms": cuda_ms(library, reps) if library else None,
           **bound(moved, ops, kind)}
    print(f"{name} times: kernel_ms={row['ms']} plain_ms={row['plain_ms']} "
          f"library_ms={row['library_ms']} bound_ms={row['bound_ms']} "
          f"({row['bound_by']}) [{card}]", flush=True)
    return row


def attention_times(card, reps=20):
    """K3 (bf16) beside scaled_dot_product_attention and its plain version
    at the three main-path shapes (the library call gets the same
    additive mask: padding and, for CLIP text, causal), CUDA-event ms and
    the kernel's device µs; printed, and returned by shape with the
    bound (all operations counted, causal or not)."""
    import torch.nn.functional as F
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import kernel_checks as KC
    rows = {}
    for name, B, S, H, m, causal in OPT_SHAPES["fused_attention"]:
        c = KC.attention_case(B, S, H, m, causal, torch.bfloat16)
        q, k, v, mask = c["q"], c["k"], c["v"], c["mask"]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        add = torch.zeros(B, 1, S, S, device=q.device)
        if mask is not None:
            add += ((1.0 - mask) * -1e9)[:, None, None, :]
        if causal:
            add += torch.full((S, S), -1e9, device=q.device).triu(1)
        add = add.to(torch.bfloat16)
        kernel = (lambda q=q, k=k, v=v, mask=mask, causal=causal:
                  K3.fused_attention(q, k, v, mask, causal))
        row = {"ms": cuda_ms(kernel, reps),
               "plain_ms": cuda_ms(lambda: K3.fused_attention_plain(
                   q, k, v, mask, causal), 3),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=add), reps),
               "device_us": device_us(kernel, 10)[0],
               **bound(nbytes(q, k, v, q) + (nbytes(mask) if m else 0),
                       4 * B * H * S * S * q.shape[-1], "bf16")}
        print(json.dumps({"kernel": "fused_attention", "shape": name,
                          "B": B, "S": S, "H": H, "causal": causal, **row,
                          "card": card}), flush=True)
        rows[name] = row
    return rows


LN_ROWS, LN_D = 32 * 512, 768       # K4's drive: RoBERTa b32/S512 rows
# --times: K1 at the b32/S512 shapes, RoBERTa at B = 3 and one request of
# each tower; K2 at the b32 shapes and one RoBERTa request (CLIP's 77 and
# 50 rows stay below K2's 256)
INT8_TIMES = {
    "int8_ffn": (("roberta_b32", 32 * 512, 768, 3072, "tanh"),
                 ("roberta_b3", 3 * 512, 768, 3072, "tanh"),
                 ("clip_text_b32", 32 * 77, 512, 2048, "quick"),
                 ("clip_vision_b32", 32 * 50, 768, 3072, "quick"),
                 ("roberta_1", 512, 768, 3072, "tanh"),
                 ("clip_text_1", 77, 512, 2048, "quick"),
                 ("clip_vision_1", 50, 768, 3072, "quick"),
                 ("clip_vision_video", 16 * 12 * 50, 768, 3072, "quick")),
    "int8_dense": (("roberta_b32", 32 * 512, 768, 768),
                   ("clip_text_b32", 32 * 77, 512, 512),
                   ("clip_vision_b32", 32 * 50, 768, 768),
                   ("roberta_1", 512, 768, 768)),
}


def _int8_layer(K: int, N: int, gen):
    """A seeded int8 dense layer laid out as the imported tree's serving
    transform lays it on the card (K-major where it has ``kmajor``)."""
    from misinfo_tpu_torch.ops import serving
    from misinfo_tpu_torch.ops.quant import quantize_dense
    p = quantize_dense({"kernel": torch.randn(K, N, generator=gen) * 0.03,
                        "bias": torch.randn(N, generator=gen) * 0.01})
    lay = getattr(serving, "kmajor", lambda t: t)
    return lay(p["kernel_q"].cuda()), p["w_scale"].cuda(), p["bias"].cuda()


def _time_row(kernel, name, fn, shape, work, kind, library, yardstick,
              card, calls: int = 20) -> None:
    """One --times JSON line: device µs per call, CUDA kernels per call,
    each CUDA kernel's device µs, the bound and the yardstick's µs
    (``library``, never called by the port in the kernel's place)."""
    us, per_call = device_us(fn, calls)
    b = bound(*work, kind)
    print(json.dumps({
        "kernel": kernel, "shape": name, **shape, "device_us": us,
        "kernels_per_call": per_call, "kernels_us": kernel_split_us(fn),
        "bound_us": b["bound_ms"] * 1e3, "bound_by": b["bound_by"],
        "library_us": device_us(library, calls)[0], "yardstick": yardstick,
        "card": card}), flush=True)


def _int_mm(products):
    """The int8 rows' yardstick: torch._int_mm of each (M, K, N) integer
    product on random s8 operands, in one callable, and its name."""
    ops = [(torch.randint(-127, 128, (M, K), dtype=torch.int8,
                          device="cuda"),
            torch.randint(-127, 128, (N, K), dtype=torch.int8,
                          device="cuda").t()) for M, K, N in products]
    return (lambda: [torch._int_mm(a, b) for a, b in ops],
            "torch._int_mm of the same integer products")


def int8_times(card):
    """K1 and K2 of the imported tree at INT8_TIMES' shapes, one JSON line
    each: device µs per call (device_us), the device µs of each of its
    CUDA kernels (kernel_split_us), CUDA kernels per call, the bound, and
    torch._int_mm of the same integer products as the yardstick."""
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import int8_ffn as K1
    gen = torch.Generator().manual_seed(8)
    for name, M, K, N, mode in INT8_TIMES["int8_ffn"]:
        x = torch.randn(M, K, generator=gen).to(torch.bfloat16).cuda()
        args = (x, *_int8_layer(K, N, gen), *_int8_layer(N, K, gen))
        fn = lambda: K1.int8_ffn(*args, mode=mode)              # noqa: E731
        _time_row("int8_ffn", name, fn, {"M_K_N": [M, K, N]},
                  ffn_work(M, K, N), "int8", *_int_mm([(M, K, N), (M, N, K)]),
                  card, calls=50)
    for name, M, K, N in INT8_TIMES["int8_dense"]:
        x = torch.randn(M, K, generator=gen).to(torch.bfloat16).cuda()
        args = (x, *_int8_layer(K, N, gen))
        fn = lambda: K2.int8_dense(*args)                       # noqa: E731
        _time_row("int8_dense", name, fn, {"M_K_N": [M, K, N]},
                  (nbytes(*args) + M * N * 2, 2 * M * K * N), "int8",
                  *_int_mm([(M, K, N)]), card, calls=50)


# --times: K5 (bf16) at the towers' b32/S512 shapes, one RoBERTa request
# and Whisper's pallas_ffn decode rows; K10a/K10b at the archive vault's
# 1,048,576 rows × 512 for 1, 8, 32 and 64 query rows
FFN_TIMES = (("roberta_b32", 32 * 512, 768, 3072, "tanh"),
             ("clip_text_b32", 32 * 77, 512, 2048, "quick"),
             ("clip_vision_b32", 32 * 50, 768, 3072, "quick"),
             ("roberta_1", 512, 768, 3072, "tanh"),
             ("whisper_base_decode_1", 1, 512, 2048, "tanh"),
             ("whisper_base_decode_32", 32, 512, 2048, "tanh"),
             ("whisper_large_decode_32", 32, 1280, 5120, "tanh"))
INT4_TIMES = (1, 8, 32, 64)


def ffn_times(card):
    """K5 of the imported tree (bf16) at FFN_TIMES' shapes, one JSON line
    each; the yardstick is cuBLAS's two bf16 products with f32 output
    (torch.mm), which no port path calls in K5's place."""
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import kernel_checks as KC
    for name, M, K, N, mode in FFN_TIMES:
        a = KC.ffn_case(M, K, N, mode, torch.bfloat16)["args"]
        x, w1, _, w2, _ = a
        g = torch.randn(M, N, device="cuda").to(torch.bfloat16)
        _time_row("fused_ffn", name,
                  lambda a=a, mode=mode: K5.fused_ffn(*a, mode=mode),
                  {"M_K_N_K2": [M, K, N, K]},
                  (nbytes(*a) + M * K * 2, 2 * M * N * 2 * K), "bf16",
                  lambda: (torch.mm(x, w1, out_dtype=torch.float32),
                           torch.mm(g, w2, out_dtype=torch.float32)),
                  "torch.mm(x, W1) + torch.mm(g, W2), f32 out", card)


def int4_times(card):
    """K10a and K10b of the imported tree at INT4_TIMES' query rows
    against a 1,048,576-row, 512-d vault, one JSON line each; the
    yardstick is torch._int_mm of the same integer product over the rows
    unpacked to s8 (twice the bytes; query columns padded to 8)."""
    from misinfo_tpu_torch.vault import int4 as K10
    from misinfo_tpu_torch.vault import int4_checks as IC
    packed, scale = IC.vault_case(BIG_ROWS, device="cuda")
    nib = K10.unpack_int4(packed).to(torch.int8)
    D = nib.shape[1]
    for B in INT4_TIMES:
        q = IC.query_case(B, seed=B, device="cuda")
        qi8 = torch.zeros(max(8, -(-B // 8) * 8), D, dtype=torch.int8,
                          device="cuda")
        qi8[:B] = K10.quantize_query_i8(q)[0]
        moved = nbytes(packed, scale) + B * BIG_ROWS * 4
        for name, fn, qbytes, kind in (
                ("int4_sims", K10.int4_sims, 2, "bf16"),
                ("int4_sims_i8", K10.int4_sims_i8, 1, "int8")):
            _time_row(name, f"B{B}",
                      lambda fn=fn, q=q: fn(q, packed, scale),
                      {"B_N_D": [B, BIG_ROWS, D]},
                      (moved + B * D * qbytes, 2 * B * BIG_ROWS * D), kind,
                      lambda: torch._int_mm(nib, qi8.t()),
                      f"torch._int_mm(s8 rows [N, D], query [D, "
                      f"{qi8.shape[0]}])", card)
    del packed, scale, nib


# K4's checks (rows, D): the drive's shape, the other Whisper and RoBERTa
# widths (the kernel's compiled row widths) and two others (its general
# loop; 1,001 bf16 rows are not 16-byte aligned)
LN_CHECKS = ((LN_ROWS, LN_D), (4096, 512), (4096, 1024), (4096, 1280),
             (4096, 1000), (4096, 1001))


def _parent_library(root: str, name: str):
    """The library of csrc/<name>.cu in the tree at ``root``, built with
    this tree's nvcc flags beside this tree's libraries."""
    import ctypes
    from misinfo_tpu_torch.ops import cuda_build as CB
    src = os.path.join(root, "misinfo_tpu_torch", "csrc", f"{name}.cu")
    tag = hashlib.sha256(os.path.abspath(root).encode()).hexdigest()[:8]
    so = CB.BUILD_DIR / f"parent_{name}_{tag}.so"
    CB.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *CB.NVCC_FLAGS, "-I", os.path.dirname(src), "-o",
                    str(so), src], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _parent_layer_norm(root: str):
    """The K4 of the tree at ``root``, as a callable with
    fused_layer_norm's arguments."""
    import ctypes
    lib = _parent_library(root, "layer_norm")
    lib.layer_norm_launch.restype = ctypes.c_int
    lib.layer_norm_launch.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 2
                                      + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p])

    def run(x, scale, bias, eps=1e-5):
        out = torch.empty_like(x)
        err = lib.layer_norm_launch(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], eps, int(x.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent layer_norm launch failed: {err}")
        return out
    return run


def layer_norm_times(card, parent=None, rounds=50):
    """K4 at 16,384 × 768 bf16 as medians of per-call CUDA-event times over
    ``rounds`` rounds, one call of each contender per round in turn, the
    L2 flushed (a 128 MB fill) before every call: K4, F.layer_norm with
    bf16 copies of scale and bias (the library time of earlier runs),
    F.layer_norm with the f32 scale and bias themselves (the same function,
    where PyTorch takes a bf16 input with f32 parameters) and, with
    ``parent`` (another tree's root), that tree's K4. Printed as one JSON
    line, with the card's clocks, temperature and power draw read just
    after, and returned."""
    import torch.nn.functional as F
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import kernel_checks as KC
    c = KC.layer_norm_case(LN_ROWS, LN_D, torch.bfloat16)
    x, sc, bi = c["x"], c["scale"], c["bias"]
    sc16, bi16 = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
    runs = {"kernel": lambda: K3.fused_layer_norm(x, sc, bi),
            "library_bf16_params": lambda: F.layer_norm(x, (LN_D,), sc16,
                                                        bi16)}
    note = None
    try:
        F.layer_norm(x, (LN_D,), sc, bi)
        runs["library_f32_params"] = lambda: F.layer_norm(x, (LN_D,), sc, bi)
    except RuntimeError as e:     # a yardstick only: the port never calls it
        note = f"F.layer_norm refuses f32 parameters with a bf16 input: {e}"
    if parent:
        prev = _parent_layer_norm(parent)
        runs["parent_kernel"] = lambda: prev(x, sc, bi)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    times = {k: [] for k in runs}
    for fn in runs.values():
        fn()
    for _ in range(rounds):
        for name, fn in runs.items():
            flush.zero_()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    row = {"kernel": "layer_norm", "rows": LN_ROWS, "D": LN_D,
           "rounds": rounds, "clocks_after": clocks,
           **{f"{k}_median_ms": sorted(v)[len(v) // 2]
              for k, v in times.items()},
           **bound(2 * nbytes(x) + nbytes(sc, bi), 8 * x.numel(), "f32"),
           "note": note, "card": card}
    print(json.dumps(row), flush=True)
    return row


def check_opt_in_kernels(card):
    """Phase 15: K2-K5 against their plain versions on the card at the
    main path's shapes (ops/kernel_checks.py), bf16 and f32; CUDA-event
    times at the RoBERTa shape (bf16) with the bound and, for K3 and K4,
    the one PyTorch call that computes the same function."""
    import torch.nn.functional as F
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import kernel_checks as KC
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    for name, M, K, N in OPT_SHAPES["int8_dense"]:
        for xd in (bf16, f32):
            _report(f"int8_dense {name} M={M} K={K} N={N} x {xd}",
                    KC.check_int8_dense(KC.int8_dense_case(M, K, N, xd)),
                    card)
    _report("int8_dense no bias M=300 K=N=768", KC.check_int8_dense(
        KC.int8_dense_case(300, 768, 768, bias=False)), card)
    _, M, K, N = OPT_SHAPES["int8_dense"][0]
    c = KC.int8_dense_case(M, K, N)
    a = (c["x"], c["wq"], c["w_scale"], c["bias"])
    rows["int8_dense"] = {"err": 0.0, **_timed(
        "int8_dense roberta", lambda: K2.int8_dense(*a),
        lambda: K2.int8_dense_plain(*a), None, nbytes(*a) + M * N * 2,
        2 * M * K * N, "int8", card)}
    print(f"int8_dense roberta yardstick: torch._int_mm of the product "
          f"{int_mm_ms(M, K, N)} ms [{card}]", flush=True)

    errs = []
    for dt in (bf16, f32):
        for name, B, S, H, m, causal in OPT_SHAPES["fused_attention"]:
            res = KC.check_attention(KC.attention_case(B, S, H, m, causal, dt))
            errs.append(res["err"])
            _report(f"fused_attention {name} B={B} S={S} H={H} {dt}", res,
                    card)
    rows["fused_attention"] = {"err": max(errs),
                               **attention_times(card)["roberta"]}
    if not (rows["fused_attention"]["ms"]
            < rows["fused_attention"]["plain_ms"]):
        raise AssertionError("K3 is slower than its plain version")

    errs = []
    for dt in (bf16, f32):
        for rws, D in LN_CHECKS:
            res = KC.check_layer_norm(KC.layer_norm_case(rws, D, dt))
            errs.append(res["err"])
            _report(f"layer_norm rows={rws} D={D} {dt}", res, card)
    c = KC.layer_norm_case(LN_ROWS, LN_D, bf16)
    x, sc, bi = c["x"], c["scale"], c["bias"]
    K3.ln_launches = 0      # K4's own drive (no model calls it) starts here
    K3.fused_layer_norm(x, sc, bi)
    torch.cuda.synchronize()
    ln_launches = K3.ln_launches        # read just after it
    if ln_launches != 1:
        raise AssertionError(f"K4: {ln_launches} launches for one call")
    medians = layer_norm_times(card)
    lib_params = ((sc, bi) if "library_f32_params_median_ms" in medians
                  else (sc.to(bf16), bi.to(bf16)))
    rows["layer_norm"] = {"err": max(errs), "launches": ln_launches, **_timed(
        "layer_norm", lambda: K3.fused_layer_norm(x, sc, bi),
        lambda: K3.fused_layer_norm_plain(x, sc, bi),
        lambda: F.layer_norm(x, (LN_D,), *lib_params),
        2 * nbytes(x) + nbytes(sc, bi), 8 * x.numel(), "f32", card)}

    errs = []
    for dt in (bf16, f32):
        for name, M, K, N, mode in OPT_SHAPES["fused_ffn"]:
            res = KC.check_ffn(KC.ffn_case(M, K, N, mode, dt))
            errs.append(res["err"])
            _report(f"fused_ffn {name} M={M} K={K} N={N} {mode} {dt}", res,
                    card)
    _, M, K, N, mode = OPT_SHAPES["fused_ffn"][0]
    a = KC.ffn_case(M, K, N, mode, bf16)["args"]
    rows["fused_ffn"] = {"err": max(errs), **_timed(
        "fused_ffn roberta", lambda: K5.fused_ffn(*a, mode=mode),
        lambda: K5.fused_ffn_plain(*a, mode=mode), None,
        nbytes(*a) + M * K * 2, 2 * M * N * 2 * K, "bf16", card, reps=10)}
    return rows


def engine_surface(engine, batch, image, rng, card) -> None:
    """Phase 24: on phase 4's engine, analyze_batch_async(...)() and
    analyze_stream over the mixed batch give analyze_batch's reports (every
    score equal, in order); the five per-signal conveniences answer once
    each; the host prep of the b32 batch's 32 images (and of 32
    photo-sized ones where cv2 or PIL is installed) with the engine's
    thread pool and with a serial map swapped in (printed only)."""
    def key(reports):
        return [(r["scores"], r["vault_matches"]) for r in reports]
    want = key(engine.analyze_batch(batch))
    for what, got in (("analyze_batch_async",
                       engine.analyze_batch_async(batch)()),
                      ("analyze_stream", list(engine.analyze_stream(batch)))):
        if key(got) != want:
            raise AssertionError(f"{what} differs from analyze_batch")
    text = words(rng, 40)
    answers = {
        "analyze_text": engine.analyze_text(text),
        "analyze_image": engine.analyze_image(image),
        "analyze_consistency": engine.analyze_consistency(text, image),
        "search_vault": engine.search_vault(image, text),
        "fusion_verdict": engine.fusion_verdict(want[0][0])}
    for name, a in answers.items():
        nums = [v for v in a.values() if isinstance(v, (int, float))]
        if not nums or not all(math.isfinite(v) for v in nums):
            raise AssertionError(f"{name} answered {a}")
    if not answers["search_vault"]["matches"]:
        raise AssertionError("search_vault found no match in the vault")
    import importlib.util
    sets = {"the b32 batch's 224x224 images": [image] * 32}
    if any(importlib.util.find_spec(m) for m in ("cv2", "PIL")):
        sets["1280x720 images"] = [
            rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
            for _ in range(32)]

    def prep_ms(images, reps=3):
        engine._image_batch(images, 32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._image_batch(images, 32)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    prep = []
    for what, images in sets.items():
        pooled = prep_ms(images)
        with swapped((engine, "_prep_map",
                      lambda fn, items: [fn(x) for x in items])):
            serial = prep_ms(images)
        prep.append(f"{what}: pool {pooled} ms, serial {serial} ms, pool "
                    f"again {prep_ms(images)} ms")
    print(f"engine surface: analyze_batch_async and analyze_stream equal "
          f"analyze_batch over {len(batch)} requests; "
          + "; ".join(f"{k} {v}" for k, v in answers.items())
          + f"; host prep of 32 images, thread pool of "
          f"{engine._pool()._max_workers}: " + "; ".join(prep)
          + f" [{card}]", flush=True)


@contextlib.contextmanager
def swapped(*swaps):
    """Replace module attributes, (module, name, stand-in) each, for the
    duration of the block: here the kernels' wrappers by their plain
    versions, which then run on the card."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def opt_in_engines(default, vault_path, b32, image, rng, card,
                   profile=None):
    """Phases 16-17: the engine at full width in its opt-in kernel modes,
    with phase 4's seeded weights, vault and b32/S512 requests. Engine I
    (quant="int8", use_pallas=True): one analyze() of a 300-word request
    (RoBERTa's 512 rows take K2, CLIP's 77 and 50 stay below 256) and the
    b32 batch, whose full program must launch K2 144, K1 36 and K3 36
    times. Engine II (quant="none", use_pallas="ffn"): K5 36 times. Each:
    scores within 0.05 of the same engine with the plain versions,
    verdicts/s beside the default engine's, params bytes. With
    ``profile``, appends a profiler table of each engine's b32 batch.
    Returns the kernels' launch counts of the b32 runs."""
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import int8_ffn as K1
    mods = {"int8_dense": K2, "int8_ffn": K1, "fused_attention": K3,
            "fused_ffn": K5}
    plain = {"int8_dense": (K2, "int8_dense", K2.int8_dense_plain),
             "int8_ffn": (K1, "int8_ffn", K1.int8_ffn_plain),
             "fused_attention": (K3, "fused_attention",
                                 K3.fused_attention_plain),
             "fused_ffn": (K5, "fused_ffn", K5.fused_ffn_plain)}
    launches = {}
    vps = {"default": verdicts_per_s(default, b32)}
    for label, quant, use_pallas, want_single, want_b32 in OPT_ENGINES:
        cfg = ForensicsConfig(verbose=False)
        cfg = cfg.replace(
            paths=dataclasses.replace(cfg.paths, vault_path=vault_path),
            precision=dataclasses.replace(cfg.precision, quant=quant))
        eng = MisinfoForensics(cfg, DetectorConfig(), use_pallas=use_pallas,
                               device="cuda", cuda_graphs=False)
        what = f"engine {label} (quant={quant!r}, use_pallas={use_pallas!r})"
        if eng.quant != quant:
            raise AssertionError(f"{what}: quant resolved to {eng.quant}")
        if quant == "int8":
            held, kernels = storage_report(eng.params)
            pb = eng.memory_report()["params_bytes"]
            print(f"{what}: params {pb} bytes, storages held {held} bytes; "
                  f"{kernels} int8 kernels, all K-major", flush=True)
            if held != pb:
                raise AssertionError(f"{what}: the tree holds {held} bytes "
                                     f"of storage for {pb} bytes of params")
        text = words(rng, 300)
        eng.analyze(text, image, verbose=False)          # build, warm up
        torch.cuda.synchronize()
        counts = {}
        for run, fn in (("single", lambda: [eng.analyze(text, image,
                                                        verbose=False)]),
                        ("b32", lambda: eng.analyze_batch(b32))):
            for m in mods.values():
                m.launches = 0          # this path's run starts here
            reports = fn()
            torch.cuda.synchronize()
            counts[run] = {n: m.launches for n, m in mods.items()
                           if m.launches}  # read just after the path
            check_reports(reports, f"{what} {run}")
        print(f"{what}: launches, one analyze {counts['single']} (want "
              f"{want_single}); full b32/S512 {counts['b32']} (want "
              f"{want_b32})", flush=True)
        if counts != {"single": want_single, "b32": want_b32}:
            raise AssertionError(f"{what}: launch counts off")
        launches.update(counts["b32"])
        with_kernels = eng.analyze_batch(b32)
        with swapped(*[plain[n] for n in want_b32]):
            with_plain = eng.analyze_batch(b32)
        drift = max(abs(a["scores"][k] - b["scores"][k])
                    for a, b in zip(with_kernels, with_plain)
                    for k in ("ai_score", "misinfo_score", "deepfake_score",
                              "clip_similarity", "fake_probability"))
        vps[label] = verdicts_per_s(eng, b32)
        print(f"{what}: max score drift against the plain versions {drift} "
              f"(limit 0.05); b32/S512 {vps[label]} verdicts/s; params "
              f"{eng.memory_report()['params_bytes']} bytes (default "
              f"engine, quant={default.quant!r}: "
              f"{default.memory_report()['params_bytes']}) [{card}]",
              flush=True)
        if not drift < 0.05:
            raise AssertionError(f"{what}: scores drift {drift} >= 0.05")
        if profile:
            append_profile(profile, f"{what} full b32/S512 analyze_batch",
                           lambda: eng.analyze_batch(b32), rows=40)
        del eng
    vps["default again"] = verdicts_per_s(default, b32)
    print("b32/S512 verdicts/s in one run: " + ", ".join(
        f"{k} {v}" for k, v in vps.items()) + f" [{card}]", flush=True)
    return launches


# ------------------------------------------ flash attention (phase 32)

# phase 32 (a): K11 against its plain version, (B, S, H, layout, causal),
# bf16 and f32 (ops/kernel_checks.py::flash_case: "packed" ragged
# requests with a padding tail, "padded" the mask form)
FLASH_CHECKS = ((32, 512, 12, "packed", False),
                (32, 512, 12, "padded", False),
                (32, 512, 12, "packed", True),
                (32, 128, 12, "packed", False),
                (8, 2048, 12, "packed", False),
                (3, 384, 5, "packed", True))
# its times: (name, B, S, H, layout, causal); the first is the kernels
# line's row
FLASH_TIMES = (("roberta_b32_packed", 32, 512, 12, "packed", False),
               ("roberta_b32_padded", 32, 512, 12, "padded", False),
               ("s2048_packed", 8, 2048, 12, "packed", False))


def flash_work(case):
    """(bytes, operations) of one bf16 K11 call on ``case``: q, k, v, the
    output and the segment ids each moved once; 4·D operations per (query,
    key) pair of the key tiles its blocks of 128 queries walk (the data
    decides which: flash_attention.walked_tiles)."""
    from misinfo_tpu_torch.ops import flash_attention as K11
    q, k, v, qs, ks = (case[n] for n in ("q", "k", "v", "q_seg", "kv_seg"))
    B, S, H, D = q.shape
    tiles = K11.walked_tiles(qs, ks, case["causal"], S, k.shape[1])
    pairs = int(tiles.sum()) * (B if qs is None else 1) * 128 * 128
    return nbytes(q, k, v, q, qs, ks), 4 * D * H * pairs


def _parent_flash(root: str):
    """The K11 of the tree at ``root``, as a callable with flash_attention's
    arguments (bf16, the same C entry)."""
    import ctypes
    from misinfo_tpu_torch.ops import flash_attention as K11
    lib = _parent_library(root, "flash_attention")
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

    def run(q, k, v, qs, ks, causal):
        B, S, H, D = q.shape
        out = torch.empty_like(q)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if qs is None else qs.data_ptr(),
            None if ks is None else ks.data_ptr(), out.data_ptr(), B, S, H,
            k.shape[1], D, int(causal), 0, 1.0 / math.sqrt(D),
            K11.MASK_VALUE, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent flash_attention launch failed: {err}")
        return out
    return run


def flash_times(card, reps=20, parent=None):
    """K11 (bf16) at FLASH_TIMES' shapes beside its plain version and
    scaled_dot_product_attention with the equivalent boolean mask (the
    port never calls it): CUDA-event ms, the kernel's device µs (the
    median of three readings), the bound; with ``parent`` (another tree's
    root) that tree's K11 too, its device µs read in turn with this
    tree's (this, parent, parent, this, this, parent) and the largest
    difference between the two outputs. Printed as JSON lines and
    returned by shape."""
    import torch.nn.functional as F
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import kernel_checks as KC
    prev = _parent_flash(parent) if parent else None
    rows = {}
    for name, B, S, H, layout, causal in FLASH_TIMES:
        c = KC.flash_case(B, S, H, layout, causal, torch.bfloat16)
        q, k, v, qs, ks = (c[n] for n in ("q", "k", "v", "q_seg", "kv_seg"))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        seen = K11.visible(qs, ks, causal, S, S, q.device)
        seen = None if seen is None else seen[:, None].contiguous()
        kernel = (lambda q=q, k=k, v=v, qs=qs, ks=ks, causal=causal:
                  K11.flash_attention(q, k, v, qs, ks, causal))
        runs = {"device_us": kernel}
        extra = {}
        if prev:
            runs["parent_device_us"] = (
                lambda q=q, k=k, v=v, qs=qs, ks=ks, causal=causal:
                prev(q, k, v, qs, ks, causal))
            extra["parent_max_abs_diff"] = (
                kernel().float() - runs["parent_device_us"]().float()
            ).abs().max().item()
        us = {key: [] for key in runs}
        for r in range(3):
            for key in (runs if r % 2 == 0 else reversed(list(runs))):
                us[key].append(device_us(runs[key], 10)[0])
        row = {"ms": cuda_ms(kernel, reps),
               "plain_ms": cuda_ms(lambda: K11.flash_attention_plain(
                   q, k, v, qs, ks, causal), 3),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=seen), reps),
               **{key: _median(v) for key, v in us.items()},
               **{f"{key}_runs": v for key, v in us.items()}, **extra,
               **bound(*flash_work(c), "bf16")}
        print(json.dumps({"kernel": "flash_attention", "shape": name,
                          "B": B, "S": S, "H": H, "layout": layout,
                          "causal": causal, **row, "card": card}),
              flush=True)
        rows[name] = row
    return rows


def _median(xs):
    """The median of readings, None if any reading is None (device_us
    gives None where the host fell behind the card)."""
    from statistics import median
    return None if None in xs else median(xs)


def flash_checks(card):
    """Phase 32 (a): K11 against its plain version on the card at
    FLASH_CHECKS' shapes, bf16 and f32, within ops/kernel_checks.py's
    band with every planted fault outside; then its times. Returns the
    kernels line's row (the b32/S512 packed shape) and every shape's."""
    from misinfo_tpu_torch.ops import kernel_checks as KC
    errs = []
    for dt in (torch.bfloat16, torch.float32):
        for B, S, H, layout, causal in FLASH_CHECKS:
            res = KC.check_flash(KC.flash_case(B, S, H, layout, causal, dt))
            torch.cuda.synchronize()
            errs.append(res["err"])
            _report(f"flash_attention B={B} S={S} H={H} {layout} "
                    f"causal={causal} {dt}", res, card)
    times = flash_times(card)
    return {"err": max(errs), **times[FLASH_TIMES[0][0]]}, times


def flash_engine_phase(default, vault_path, b32, image, rng, card):
    """Phase 32 (b): engine III, MisinfoForensics(use_pallas="flash") at
    full width with quant "auto" (K1 still serves the FFNs) and phase 4's
    seeded weights and vault: one analyze() of a 300-word request, the
    b32/S512 batch (dense rows, K11's padded form) and a ragged b32 batch
    with pack_text=True (packed rows, K11 over segment ids), each with
    exact K11, K3 and K1 launch counts (JAX's gate: K11 on RoBERTa's rows
    of 512, one a layer; K3 on CLIP's 77 and 50, the fall-through); the
    batches' scores within 0.05 of the same engine with K11's plain
    version and of the default engine, verdicts printed; a second engine
    III with CUDA graphs, warmup() of the b32 signature, the b32 batch
    replayed (and the packed batch captured at first use, then replayed)
    under sync debug "error", packed outputs bit for bit engine III's
    eager ones, K11's launches per replay equal to eager's; b32 verdicts/s
    beside the default engine's (printed only). Returns K11's launches in
    the counted runs."""
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import int8_ffn as K1
    mods = {"flash_attention": K11, "fused_attention": K3, "int8_ffn": K1}
    cfg = ForensicsConfig(verbose=False)
    cfg = cfg.replace(paths=dataclasses.replace(cfg.paths,
                                                vault_path=vault_path))
    packed_cfg = cfg.replace(serving=dataclasses.replace(cfg.serving,
                                                         pack_text=True))
    eng = MisinfoForensics(cfg, DetectorConfig(), use_pallas="flash",
                           device="cuda", cuda_graphs=False)
    what = "engine III (use_pallas='flash')"
    if eng.quant != "int8_ffn":
        raise AssertionError(f"{what}: quant resolved to {eng.quant}")
    det = eng.det_cfg
    want = {"flash_attention": det.roberta.num_layers,
            "fused_attention": det.clip.text_layers + det.clip.vision_layers,
            "int8_ffn": PER_PROGRAM["full"]}
    text = words(rng, 300)
    ragged = [{"text": words(rng, int(n)), "image": image}
              for n in rng.integers(5, 300, 32)]
    eng.analyze(text, image, verbose=False)          # build, warm up
    torch.cuda.synchronize()
    runs = (("analyze", lambda: [eng.analyze(text, image, verbose=False)]),
            ("b32", lambda: eng.analyze_batch(b32)),
            ("packed b32", lambda: eng.analyze_batch(ragged)))
    counts, reports, flash_launches = {}, {}, 0
    for run, fn in runs:
        with swapped(*([(eng, "cfg", packed_cfg)] if run == "packed b32"
                       else [])):
            for m in mods.values():
                m.launches = 0          # this path's run starts here
            reports[run] = fn()
            torch.cuda.synchronize()
            counts[run] = {n: m.launches for n, m in mods.items()}
        flash_launches += counts[run]["flash_attention"]
        check_reports(reports[run], f"{what} {run}")
    print(f"{what}: launches {counts} (want {want} each run) [{card}]",
          flush=True)
    if any(c != want for c in counts.values()):
        raise AssertionError(f"{what}: launch counts off")

    keys = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
            "fake_probability")

    def drift(a, b):
        return max(abs(x["scores"][k] - y["scores"][k])
                   for x, y in zip(a, b) for k in keys)
    for run, reqs in (("b32", b32), ("packed b32", ragged)):
        swaps = [(eng, "cfg", packed_cfg)] if run == "packed b32" else []
        with swapped(*swaps, (K11, "flash_attention",
                              K11.flash_attention_plain)):
            plain = eng.analyze_batch(reqs)
        base = default.analyze_batch(reqs)
        d_plain, d_default = (drift(reports[run], plain),
                              drift(reports[run], base))
        print(f"{what} {run}: max score drift against K11's plain version "
              f"{d_plain}, against the default engine {d_default} (limit "
              f"0.05); verdicts "
              + "".join("F" if r["verdict"] else "R" for r in reports[run])
              + f" (default engine "
              + "".join("F" if r["verdict"] else "R" for r in base)
              + f") [{card}]", flush=True)
        if not (d_plain < 0.05 and d_default < 0.05):
            raise AssertionError(f"{what} {run}: scores drift")

    graphed = MisinfoForensics(cfg, DetectorConfig(), use_pallas="flash",
                               device="cuda")
    sigs = graphed.warmup(batch_sizes=(32,), text_buckets=(512,),
                          variants=("full",), videos=())
    for run, reqs in (("b32", b32), ("packed b32", ragged)):
        swaps = [(e, "cfg", packed_cfg) for e in (eng, graphed)
                 if run == "packed b32"]
        with swapped(*swaps):
            K11.launches = 0
            want_out, _ = dispatch_outputs(eng, reqs)
            torch.cuda.synchronize()
            eager_n = K11.launches
            if run == "packed b32":
                dispatch_outputs(graphed, reqs)      # captured at first use
            K11.launches = 0
            got, _ = dispatch_outputs(graphed, reqs, "error")
            torch.cuda.synchronize()
            replay_n = K11.launches
        same = same_bits(got, want_out)
        print(f"{what} with CUDA graphs, {run}: warmed {sigs}; replay "
              f"{'==' if same else '!='} eager; K11 launches per replay "
              f"{replay_n}, eager {eager_n} [{card}]", flush=True)
        if not same or replay_n != eager_n:
            raise AssertionError(f"{what} {run}: graph replay differs from "
                                 "eager")
    vps = {"engine III": verdicts_per_s(eng, b32),
           "engine III graphs": verdicts_per_s(graphed, b32),
           "default": verdicts_per_s(default, b32)}
    print("b32/S512 verdicts/s: " + ", ".join(
        f"{k} {v}" for k, v in vps.items()) + f" [{card}]", flush=True)
    del eng, graphed
    return flash_launches


# ------------------------------- flash attention's backward (phase 33)

# phase 33 (a): K11-bwd against its plain version, (B, S, H, layout,
# causal), bf16 and f32: the training step's rows (16 × 256, packed),
# RoBERTa b32/S512 packed, padded (its last row all padding) and packed
# causal, one key tile (S = 128), and a unit count that is no multiple of
# the SMs with odd heads
FLASH_BWD_CHECKS = ((16, 256, 12, "packed", False),
                    (32, 512, 12, "packed", False),
                    (32, 512, 12, "padded", False),
                    (32, 512, 12, "packed", True),
                    (32, 128, 12, "packed", False),
                    (3, 384, 5, "packed", True))
# its times: (name, B, S, H, layout); the first is the kernels line's row
FLASH_BWD_TIMES = (("train_16x256_packed", 16, 256, 12, "packed"),
                   ("roberta_b32_packed", 32, 512, 12, "packed"),
                   ("roberta_b32_padded", 32, 512, 12, "padded"),
                   ("s2048_packed", 8, 2048, 12, "packed"))
# phase 33 (b): the packed text-head training step through
# use_pallas="flash"
FLASH_TRAIN_ROWS, FLASH_TRAIN_SLOTS, FLASH_TRAIN_STEPS = 16, 64, 3
# step one's gradients with K11 and K11-bwd against the same step with
# their plain versions, leaf by leaf: in f32, where the kernels sit within
# a few f32 roundings of the plain versions, within 1e-3 of the leaf's own
# largest (phase 28's card-vs-CPU bar); in bf16, where a one-step flip of
# a bf16 output is carried through twelve layers and the head's ReLU
# (which a flipped sign switches for a whole slot), within 2^-4 (sixteen
# bf16 roundings) of the largest gradient of any leaf. The attention key
# biases, whose exact gradient is 0 (rounding noise on both sides), are
# held to the largest gradient of any leaf in both.
FLASH_GRAD_BAND = {"float32": 1e-3, "bfloat16": 2.0 ** -4}


def flash_bwd_work(case, which: str):
    """(bytes, operations) of K11-bwd on ``case``: "dkv" reads q, k, v, dO,
    l, m, di and the segment ids once and writes dK and dV, four products
    (s, dp, dV, dK) of 2·D operations a (query, key) pair; "dq" the same
    reads, dQ written, three products (s, dp, dQ); "both", the function:
    o in di's place, dQ, dK and dV written, five products. The pairs are
    those of the key tiles the kernels walk (the data decides which:
    flash_attention.walked_pairs)."""
    from misinfo_tpu_torch.ops import flash_attention as K11
    q, k, v, qs, ks = (case[n] for n in ("q", "k", "v", "q_seg", "kv_seg"))
    B, S, H, D = q.shape
    walked = K11.walked_pairs(qs, ks, case["causal"], S, k.shape[1])
    pairs = int(walked.sum()) * (B if qs is None else 1) * 128 * 128 * H
    reads = nbytes(q, k, v, case["do"], case["l"], case["m"], qs, ks)
    if which == "dkv":
        return reads + nbytes(case["l"]) + nbytes(k, v), 8 * D * pairs
    if which == "dq":
        return reads + nbytes(case["l"]) + nbytes(q), 6 * D * pairs
    return reads + nbytes(case["o"], q, k, v), 10 * D * pairs


def _parent_flash_bwd(root: str):
    """The K11-bwd of the tree at ``root``: {"dkv": ..., "dq": ...},
    callables with flash_dkv's and flash_dq's arguments (bf16, the same C
    entries), and "lib", the library."""
    import ctypes
    from misinfo_tpu_torch.ops import flash_attention as K11
    lib = _parent_library(root, "flash_attention_bwd")
    for name, n_out in (("flash_dkv_launch", 2), ("flash_dq_launch", 1)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (9 + n_out) + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

    def kernel(which):
        def run(q, k, v, qs, ks, l, m, do, di, causal=False):
            B, S, H, D = q.shape
            outs = ((torch.empty_like(k), torch.empty_like(v))
                    if which == "dkv" else (torch.empty_like(q),))
            err = getattr(lib, f"flash_{which}_launch")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if qs is None else qs.data_ptr(),
                None if ks is None else ks.data_ptr(), l.data_ptr(),
                m.data_ptr(), do.data_ptr(), di.data_ptr(),
                *(t.data_ptr() for t in outs), B, S, H, k.shape[1], D,
                int(causal), 0, 1.0 / math.sqrt(D), K11.MASK_VALUE,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{root}'s flash_{which}_launch failed: "
                                   f"{err}")
            return outs if which == "dkv" else outs[0]
        return run
    return {"dkv": kernel("dkv"), "dq": kernel("dq"), "lib": lib}


def _max_diff(a, b) -> float:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def flash_bwd_times(card, reps=20, parent=None):
    """K11-bwd (bf16) at FLASH_BWD_TIMES' shapes: each kernel's CUDA-event
    ms and device µs (the median of three readings) beside its bound and
    its plain version's ms, and as the library's time the backward alone
    of scaled_dot_product_attention with the equivalent boolean mask
    (torch.autograd.grad of its output; the port never calls it), which
    computes dQ, dK and dV in one call (CUDA-event ms, which the host's
    autograd work can set, and its device µs); K11's forward with and
    without its residuals. With ``parent`` (another tree's root) that tree's two
    kernels too (``_parent_flash_bwd``), each one's device µs read in turn
    with this tree's (this, parent, parent, this, this, parent), and the
    largest difference between the two outputs. Printed as JSON lines,
    returned by (shape, kernel)."""
    import torch.nn.functional as F
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import kernel_checks as KC
    prev = _parent_flash_bwd(parent) if parent else None
    rows = {}
    for name, B, S, H, layout in FLASH_BWD_TIMES:
        c = KC.flash_bwd_case(B, S, H, layout, False, torch.bfloat16)
        q, k, v, qs, ks = (c[n] for n in ("q", "k", "v", "q_seg", "kv_seg"))
        args = (q, k, v, qs, ks, c["l"], c["m"], c["do"],
                K11.flash_di(c["o"], c["do"]), False)
        lt = [t.transpose(1, 2).contiguous().requires_grad_(True)
              for t in (q, k, v)]
        seen = K11.visible(qs, ks, False, S, S, q.device)[:, None]
        lib_out = F.scaled_dot_product_attention(*lt, attn_mask=seen)
        lib_do = c["do"].transpose(1, 2).contiguous()
        def library():
            return torch.autograd.grad(lib_out, lt, lib_do,
                                       retain_graph=True)
        library_ms = cuda_ms(library, reps)
        library_us = device_us(library, 10)[0]
        del lib_out, seen
        fwd = {"fwd_ms": cuda_ms(lambda: K11.flash_attention(
                   q, k, v, qs, ks), reps),
               "fwd_residuals_ms": cuda_ms(lambda: K11.flash_forward(
                   q, k, v, qs, ks), reps),
               "fwd_device_us": device_us(lambda: K11.flash_attention(
                   q, k, v, qs, ks), 10)[0],
               "fwd_residuals_device_us": device_us(
                   lambda: K11.flash_forward(q, k, v, qs, ks), 10)[0]}
        for which, fn, plain in (("dkv", K11.flash_dkv, K11.flash_dkv_plain),
                                 ("dq", K11.flash_dq, K11.flash_dq_plain)):
            runs = {"device_us": lambda fn=fn: fn(*args)}
            extra = {}
            if prev:
                runs["parent_device_us"] = (
                    lambda which=which: prev[which](*args))
                extra["parent_max_abs_diff"] = _max_diff(
                    runs["device_us"](), runs["parent_device_us"]())
            us = {key: [] for key in runs}
            for r in range(3):
                for key in (runs if r % 2 == 0 else reversed(list(runs))):
                    us[key].append(device_us(runs[key], 10)[0])
            row = {"ms": cuda_ms(lambda: fn(*args), reps),
                   "plain_ms": cuda_ms(lambda: plain(*args), 3),
                   "library_ms": library_ms,
                   "library_device_us": library_us,
                   **{key: _median(v) for key, v in us.items()},
                   **{f"{key}_runs": v for key, v in us.items()}, **extra,
                   **bound(*flash_bwd_work(c, which), "bf16")}
            print(json.dumps({"kernel": f"flash_attention_bwd_{which}",
                              "shape": name, "B": B, "S": S, "H": H,
                              "layout": layout, **row, "card": card}),
                  flush=True)
            rows[(name, which)] = row
        both = bound(*flash_bwd_work(c, "both"), "bf16")
        print(json.dumps({"kernel": "flash_attention_bwd", "shape": name,
                          "function_bound_ms": both["bound_ms"],
                          "function_bound_by": both["bound_by"], **fwd,
                          "card": card}), flush=True)
        del c, args, lt
        gc_cuda()
    return rows


def flash_bwd_checks(card):
    """Phase 33 (a): K11-bwd against its plain version on the card at
    FLASH_BWD_CHECKS' shapes, bf16 and f32, fed the plain forward's
    residuals, within ops/kernel_checks.py's band with every planted fault
    outside; K11's own l and m at the same shapes; then the times. Returns
    the kernels line's rows (the training shape), by kernel."""
    from misinfo_tpu_torch.ops import kernel_checks as KC
    errs = {"dkv": [], "dq": []}
    for dt in (torch.bfloat16, torch.float32):
        for B, S, H, layout, causal in FLASH_BWD_CHECKS:
            c = KC.flash_bwd_case(B, S, H, layout, causal, dt)
            res = KC.check_flash_bwd(c)
            lm = KC.check_flash_residuals(c)
            torch.cuda.synchronize()
            errs["dkv"].append(res["err_dkv"])
            errs["dq"].append(res["err_dq"])
            _report(f"flash_attention backward B={B} S={S} H={H} {layout} "
                    f"causal={causal} {dt} (dQ {res['err_dq']}, dK/dV "
                    f"{res['err_dkv']}; K11's l, m at {lm['worst']} of "
                    f"their band)", res, card)
    times = flash_bwd_times(card)
    return {w: {"err": max(errs[w]), **times[(FLASH_BWD_TIMES[0][0], w)]}
            for w in errs}


def flash_train_phase(card):
    """Phase 33 (b): the packed text-head training step (train/steps.py::
    make_packed_text_head_step's loss, composed from the public functions:
    roberta_encode(..., use_pallas="flash", deterministic=True) → CLS
    slots → head_apply → weighted_cross_entropy, through make_step) on
    RoBERTa-base with seeded weights in bf16 (quant "none": training
    quantizes nothing), on packed_batches(n_rows=16, n_slots=64) of 256
    tokens: step one's gradients held leaf by leaf (FLASH_GRAD_BAND)
    against the same step with K11's and K11-bwd's plain versions swapped
    in; three AdamW steps (make_optimizer), each launching K11, its dK/dV
    and its dQ kernel once a layer, their losses within 1e-2 of the einsum
    path's (use_pallas=False); step ms of both. The gradients are held in
    f32 too (FLASH_GRAD_BAND). Returns the launches of the three steps, by
    counter."""
    from misinfo_tpu_torch.core.config import PrecisionConfig
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.models.roberta import (
        head_apply, head_init, roberta_encode, roberta_init)
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops.common import Policy, set_exact_f32
    from misinfo_tpu_torch.preprocess.tokenizer import (
        load_clip_tokenizer, load_roberta_tokenizer)
    from misinfo_tpu_torch.train import optim, steps
    from misinfo_tpu_torch.train.datasets import MisinfoDataset, Sample
    from misinfo_tpu_torch.train.losses import (
        weighted_accuracy, weighted_cross_entropy)
    from misinfo_tpu_torch.utils.tree import clone_tree
    start = time.perf_counter()
    det = DetectorConfig()
    rc = det.roberta
    gen = torch.Generator().manual_seed(33)
    tree = {"roberta": roberta_init(gen, rc),
            "misinfo_head": head_init(gen, rc)}
    policy = Policy(PrecisionConfig(compute_dtype="bfloat16",
                                    gelu_mode="erf"))
    rng = np.random.default_rng(33)
    samples = [Sample(text=words(rng, int(rng.integers(10, 240))),
                      label=i % 2) for i in range(200)]
    ds = MisinfoDataset(samples, load_roberta_tokenizer(None, rc.vocab_size),
                        load_clip_tokenizer(None, det.clip.vocab_size),
                        image_size=det.clip.image_size, roberta_len=256,
                        clip_len=det.clip.max_text_len, seed=33)
    it = ds.packed_batches(n_rows=FLASH_TRAIN_ROWS,
                           n_slots=FLASH_TRAIN_SLOTS)
    batches = [steps.batch_to(next(it), "cuda")
               for _ in range(FLASH_TRAIN_STEPS)]
    segs = [int(b["slot_valid"].sum()) for b in batches]

    def loss_for(use_pallas, policy=policy):
        def loss_fn(axis, rows, bs, gens):
            (p,), (b,) = rows, bs
            hidden = roberta_encode(
                p["roberta"], b["input_ids"], b["attention_mask"], rc,
                policy, use_pallas=use_pallas,
                position_ids=b["position_ids"],
                segment_ids=b["segment_ids"], deterministic=True)
            pooled = hidden[b["cls_rows"].long(), b["cls_cols"].long()]
            logits = head_apply(p["misinfo_head"], pooled, policy,
                                dropout_rate=rc.head_dropout)
            w = b["slot_valid"]
            return (weighted_cross_entropy(logits, b["labels"], w),
                    weighted_accuracy(logits, b["labels"], w))
        return loss_fn

    def counts():
        return (K11.launches, K11.bwd_dkv_launches, K11.bwd_dq_launches)

    def zero():
        K11.launches = K11.bwd_dkv_launches = K11.bwd_dq_launches = 0

    def first_grads(pol, *swaps):
        t = clone_tree(tree, "cuda")
        state = optim.make_optimizer(optim.OptimConfig()).init(t)
        cap = GradCapture()
        with swapped(*swaps):
            zero()
            _, _, m = steps.make_step(cap, loss_for("flash", pol),
                                      "accuracy")(t, state, batches[0])
            torch.cuda.synchronize()
            n = counts()
        return float(m["loss"]), dict(zip(state.paths, cap.grads)), n

    def plain_forward(q, k, v, qs, ks, causal, scale):
        r = K11.flash_core(q, k, v, qs, ks, causal, scale)
        return r["out"], r["l"], r["m"]
    plain = ((K11, "flash_forward", plain_forward),
             (K11, "flash_attention_bwd", K11.flash_attention_bwd_plain))
    want = (rc.num_layers,) * 3
    tf32 = torch.backends.cudnn.allow_tf32
    ok = True
    for dtype, band in FLASH_GRAD_BAND.items():
        pol = Policy(PrecisionConfig(compute_dtype=dtype, gelu_mode="erf"))
        set_exact_f32(parity=dtype == "float32")
        try:
            l_k, g_k, n_k = first_grads(pol)
            l_p, g_p, n_p = first_grads(pol, *plain)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        top = max(float(g.abs().max()) for g in g_p.values())
        worst, worst_at = 0.0, None
        for path, gp in g_p.items():
            diff = float((g_k[path].float() - gp.float()).abs().max())
            scale = (float(gp.abs().max()) if dtype == "float32"
                     and path[-2:] != ("k", "bias") else top)
            r = diff / (band * scale) if scale else (
                math.inf if diff else 0.0)
            if r > worst:
                worst, worst_at = r, path
        apart, norm_gap = grads_apart(
            {p: g.float() for p, g in g_p.items()},
            {p: g.float() for p, g in g_k.items()})
        print(f"phase 33 (b): {dtype} step one's gradients with K11/K11-bwd "
              f"against their plain versions over {len(g_p)} leaves: worst "
              f"{worst} of the band (at {worst_at}), max |Δg| / max |g| "
              f"{apart}, global norms {norm_gap} apart; loss {l_k} / {l_p}; "
              f"launches (K11, dK/dV, dQ) {n_k} and {n_p} with the plain "
              f"versions [{card}]", flush=True)
        ok = ok and worst <= 1.0 and n_k == want and n_p == (0, 0, 0)
    if not ok:
        raise AssertionError("phase 33 (b): the kernels' gradients are off "
                             "their plain versions'")

    def train(use_pallas):
        t = clone_tree(tree, "cuda")
        tx = optim.make_optimizer(optim.OptimConfig(
            lr=2e-5, weight_decay=0.01, warmup_fraction=0.1,
            total_steps=FLASH_TRAIN_STEPS, clip_norm=1.0))
        state = tx.init(t)
        step = steps.make_step(tx, loss_for(use_pallas), "accuracy")
        losses, ms, ns = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            zero()                      # this step's run starts here
            t0 = time.perf_counter()
            t, state, m = step(t, state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ns.append(counts())         # read just after it
            losses.append(float(m["loss"]))
        return losses, ms, ns
    l_f, ms_f, ns_f = train("flash")
    l_e, ms_e, _ = train(False)
    gap = max(abs(a - b) for a, b in zip(l_f, l_e))
    print(f"phase 33 (b): RoBERTa-base packed text-head steps, bf16, "
          f"{FLASH_TRAIN_ROWS} rows × 256 tokens ({segs} requests): losses "
          f"through flash {l_f}, einsum path {l_e} (largest gap {gap}, "
          f"bound 1e-2); launches a step (K11, dK/dV, dQ) {ns_f} (want "
          f"{want}); step ms flash {ms_f}, einsum {ms_e}; "
          f"{time.perf_counter() - start:.1f} s [{card}]", flush=True)
    if not (gap <= 1e-2 and all(n == want for n in ns_f)
            and all(math.isfinite(x) for x in l_f)):
        raise AssertionError("phase 33 (b): the flash training steps are "
                             "off")
    return {k: sum(n[i] for n in ns_f)
            for i, k in enumerate(("forward", "dkv", "dq"))}


def only_flash_bwd() -> int:
    """``--only 33``: phase 33 alone (no result lines)."""
    from misinfo_tpu_torch.ops import flash_attention as K11
    card = card_line()
    print(card, flush=True)
    build_all([(K11, "_library", "build_log"),
               (K11, "_bwd_library", "bwd_build_log")])
    flash_bwd_checks(card)
    flash_train_phase(card)
    stamp("33")
    return 0


def storage_report(tree):
    """(bytes of the distinct storages a param tree holds, int8 kernels);
    raises unless every ``kernel_q``'s transpose is contiguous."""
    seen, kernels = {}, 0

    def walk(t, key=None):
        nonlocal kernels
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
            if key == "kernel_q":
                kernels += 1
                if not t.t().is_contiguous():
                    raise AssertionError("an int8 kernel is not K-major")
    walk(tree)
    return sum(seen.values()), kernels


def whisper_pallas_ffn(weights, cfg, wav, card):
    """Phase 18: one whisper-base greedy decode_transcript(pallas_ffn=True)
    (bf16 weights, fused steps off): K5 once per decoder layer per step;
    tokens equal to those of the same decode with K5's plain version;
    teacher-forced logits within FFN_TF_BAND. Returns K5's launches."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    tr = WhisperTranscriber(weights, config=cfg, device="cuda",
                            decode_cfg=dataclasses.replace(
                                WhisperDecodeConfig(), quant="none",
                                pallas="off"), cuda_graphs=False)
    mels, _ = prep_mel_windows(wav, 2 * cfg.max_source_positions, 1)
    prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                          device=tr.device)
    real_step = W._cached_decoder_step
    steps = []

    def step(*a, **kw):
        steps.append(1)
        return real_step(*a, **kw)

    def decode():
        return W.decode_transcript(tr.params, None, tr.cfg, tr.policy,
                                   enc_out=enc, prompt_tokens=prompt,
                                   pallas_ffn=True)[0]
    with torch.inference_mode():
        enc = tr._encode(mels)
        decode()                                        # warm up
        torch.cuda.synchronize()
        with swapped((W, "_cached_decoder_step", step)):
            K5.launches = 0             # this path's run starts here
            t0 = time.perf_counter()
            tokens = decode()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = K5.launches      # read just after the path
        with swapped((K5, "fused_ffn", K5.fused_ffn_plain)):
            tokens_plain = decode()
        n = tokens.shape[1]

        def forced():
            cache = W.init_kv_cache(tr.params, enc, n, tr.cfg, tr.policy)
            return torch.cat([W._cached_decoder_step(
                tr.params, tokens[:, i], i, enc, cache, tr.cfg, tr.policy,
                pallas_ffn=True)[0].float() for i in range(n - 1)])
        got = forced()
        with swapped((K5, "fused_ffn", K5.fused_ffn_plain)):
            want = forced()
    layers = cfg.decoder_layers
    diff = (got - want).abs().max().item()
    emitted = int((tokens[0] != cfg.eos_token_id).sum().item())
    same = torch.equal(tokens, tokens_plain)
    print(f"whisper pallas_ffn decode: {len(steps)} steps ({emitted} tokens "
          f"before EOS) in {sec} s, K5 launches {launches} (want "
          f"{layers} × {len(steps)}); tokens equal to the plain version's: "
          f"{same}; teacher-forced max |Δlogit| {diff} (band {FFN_TF_BAND}) "
          f"[{card}]", flush=True)
    if launches != layers * len(steps) or not steps:
        raise AssertionError(f"K5 launches {launches} != {layers} × "
                             f"{len(steps)} decode steps")
    if not (same and math.isfinite(diff) and diff <= FFN_TF_BAND):
        raise AssertionError("the pallas_ffn decode disagrees with its plain "
                             "version")
    return launches


def whisper_int8_modes(tr, weights, cfg, wav, card):
    """Phases 21-23 on the quant="kernels" transcriber's weights (int8
    blocks, fused QKV): greedy decode_transcript over bf16 cross planes
    (K6b + K7b), with cross_int8=True (K6b + K8) and with
    pallas_layer=True (K9), each with exact launch counts; K8's decode
    teacher-forced against the plain versions; K9's outputs equal to the
    two-call decode's; then the quant="int8" transcriber (no decode
    kernel). Returns the launches of K8 and K9."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import layer_step as K9
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    mels, _ = prep_mel_windows(wav, 2 * cfg.max_source_positions, 1)
    sp = tr.tokenizer.specials
    prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                          device=tr.device)
    layers = cfg.decoder_layers
    real_step = W._cached_decoder_step
    steps = []

    def step(*a, **kw):
        steps.append(1)
        return real_step(*a, **kw)

    def counts():
        return {"K5": K5.launches, "K6": K6.launches,
                "K6 int8": K6.launches_i8, "K7": K7.launches, "K7 int8": K7.launches_i8,
                "K8": K7.launches_i8cc, "K9": K9.launches}

    def counted(**kw):
        """One warm decode, then one with the counts set to 0 just before
        and read just after: (outputs, steps, counts, ms per step)."""
        def decode():
            return W.decode_transcript(
                tr.params, None, tr.cfg, tr.policy, enc_out=enc,
                prompt_tokens=prompt, nospeech_id=sp.no_speech, **kw)
        decode()
        torch.cuda.synchronize()
        del steps[:]
        with swapped((W, "_cached_decoder_step", step)):
            K5.launches = K6.launches = K6.launches_i8 = 0
            K7.launches = K7.launches_i8 = K7.launches_i8cc = 0
            K9.launches = 0             # this path's run starts here
            globals_before = K9.kernel_launches()
            t0 = time.perf_counter()
            out = decode()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            seen = counts()             # read just after the path
            seen["K9 __global__"] = K9.kernel_launches() - globals_before
        n = len(steps)
        if n == 0:
            raise AssertionError(f"decode_transcript({kw}) took no step")
        return out, n, {k: v for k, v in seen.items() if v}, sec * 1e3 / n

    with torch.inference_mode():
        enc = tr._encode(mels)
        two = dict(pallas_self_attn=True, pallas_cross=True)
        out2, n2, c2, ms2 = counted(**two)
        out8, n8, c8, ms8 = counted(**two, cross_int8=True)
        out9, n9, c9, ms9 = counted(pallas_layer=True)
        two_again = counted(**two)[3]

        # phase 21: exact counts, then kernels against plain versions
        for what, n, got, want in (
                ("bf16 planes", n2, c2, {"K6": layers * n2,
                                         "K6 int8": layers * n2,
                                         "K7": layers * n2,
                                         "K7 int8": layers * n2}),
                ("cross_int8", n8, c8, {"K6": layers * n8,
                                        "K6 int8": layers * n8,
                                        "K8": layers * n8}),
                ("pallas_layer", n9, c9, {"K9": layers * n9,
                                          "K9 __global__": layers * n9})):
            print(f"whisper int8-weight decode, {what}: {n} steps, launches "
                  f"{got} (want {want})", flush=True)
            if got != want:
                raise AssertionError(f"{what}: launch counts off")
        tokens = out8[0]
        n = tokens.shape[1]

        def forced():
            cache = W.init_kv_cache(tr.params, enc, n, tr.cfg, tr.policy,
                                    merged_self=True, merged_cross=True,
                                    cross_int8=True)
            if cache["cross_k"][0].dtype != torch.int8:
                raise AssertionError("cross_int8 cache is not int8")
            return torch.cat([W._cached_decoder_step(
                tr.params, tokens[:, i], i, enc, cache, tr.cfg, tr.policy,
                **two)[0].float() for i in range(n - 1)])
        got = forced()
        with plain_decode_steps(W, K6, K7):
            before = counts()
            want = forced()
            if counts() != before:
                raise AssertionError("the plain decode launched a kernel")
    diff = (got - want).abs().max().item()
    spread = (want.max() - want.min()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    same_tokens = (out8[0] == out2[0]).float().mean().item()
    print(f"cross_int8 decode teacher-forced {n - 1} steps: max |Δlogit| "
          f"{diff} (band {I8CC_TF_BAND}; logit range {spread}); argmax "
          f"agreement {agree}; tokens shared with the bf16-plane decode "
          f"{same_tokens}; decode ms/step: bf16 planes {ms2}, cross_int8 "
          f"{ms8}, bf16 planes again {two_again} [{card}]", flush=True)
    if not (math.isfinite(diff) and diff <= I8CC_TF_BAND):
        raise AssertionError(f"cross_int8 teacher-forced logits differ by "
                             f"{diff}")

    # phase 22: the whole-layer decode is the two-call decode
    equal = [torch.equal(a, b) for a, b in zip(out9, out2)]
    print(f"pallas_layer decode: tokens, avg_logprob, p(no speech) equal to "
          f"the two-call decode's: {equal}; decode ms/step: pallas_layer "
          f"{ms9}, two calls {ms2} and {two_again} [{card}]", flush=True)
    if not (all(equal) and len(equal) == 3):
        raise AssertionError("the pallas_layer decode differs from the "
                             "two-call decode")
    if not all(bool(torch.isfinite(t.float()).all()) for t in out9[1:]):
        raise AssertionError("the pallas_layer decode is not finite")

    # phase 23: the int8 streaming transcriber
    trq = WhisperTranscriber(weights, config=cfg, device="cuda",
                             decode_cfg=dataclasses.replace(
                                 WhisperDecodeConfig(), quant="int8",
                                 fallback_temperatures=(0.0,)),
                             cuda_graphs=False)
    emb = trq.params["decoder"].get("token_embedding_q")
    if not (trq.quant and not trq.pallas and not trq.quant_kernels
            and emb is not None and emb.dtype == torch.int8
            and emb.is_cuda):
        raise AssertionError("quant='int8' did not resolve to the int8 "
                             "streaming decode on the card")
    exact = WhisperTranscriber(weights, config=cfg, device="cuda",
                               decode_cfg=dataclasses.replace(
                                   WhisperDecodeConfig(), quant="none",
                                   pallas="off"), cuda_graphs=False)
    caches = []

    def stream_step(*a, **kw):
        steps.append(1)
        caches.append(a[4].get("cross_k_scale") is not None
                      and a[4]["cross_k"][0].dtype == torch.int8)
        return real_step(*a, **kw)
    del steps[:]
    before = counts()
    with swapped((W, "_cached_decoder_step", stream_step)):
        t0 = time.perf_counter()
        text = trq.transcribe(wav)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    if counts() != before:
        raise AssertionError(f"the int8 streaming transcriber launched a "
                             f"decode kernel: {before} → {counts()}")
    if text.startswith("[transcript error"):
        raise AssertionError(f"transcribe (quant=int8) failed: {text}")
    # every decode step streams int8 caches; language detection's one SOT
    # step has a cache of its own
    if not (sum(caches) > 0 and sum(caches) >= len(caches) - 1):
        raise AssertionError("a streaming decode step ran without int8 "
                             "cross caches")
    with torch.inference_mode():
        sot = torch.full((1,), sp.sot, dtype=torch.int64, device="cuda")
        lq = real_step(trq.params, sot, 0, enc, W.init_kv_cache(
            trq.params, enc, 1, cfg, trq.policy, quant=True), cfg,
            trq.policy)[0].float()
        lx = real_step(exact.params, sot, 0, enc, W.init_kv_cache(
            exact.params, enc, 1, cfg, exact.policy), cfg,
            exact.policy)[0].float()
    rel = ((lq - lx).abs().max() / lx.abs().max()).item()
    print(f"transcribe (quant=int8, greedy rung only): {sec} s, "
          f"{len(steps)} steps, {sec * 1e3 / len(steps)} ms per step, no "
          f"decode kernel launched; transcript {len(text)} chars; position-0 "
          f"logits within {rel} × max|logit| of the unquantized step (limit "
          f"{STREAM_BAND}) [{card}]", flush=True)
    if not (math.isfinite(rel) and rel <= STREAM_BAND):
        raise AssertionError(f"int8 streaming logits off by {rel} × "
                             f"max|logit|")
    return {"cross_ffn_step_i8cc": c8["K8"], "layer_step": c9["K9"]}


# ------------------------------------------------------------- phase 29

# K2 at serving's fused QKV widths (N = 3D) at b32: RoBERTa, CLIP text,
# CLIP vision
QKV_SHAPES = (("roberta_b32", 32 * 512, 768, 3 * 768),
              ("clip_text_b32", 32 * 77, 512, 3 * 512),
              ("clip_vision_b32", 32 * 50, 768, 3 * 768))
# K2 launches of one full program at b32 (every tower's rows reach 256):
# q, k, v and o of the 36 attention blocks, or their qkv and o
K2_PER_FULL = {"unfused": 144, "fused": 72}
FUSED_BAND = 2e-2          # JAX's bf16 band for the fuse (test_serving_opt)
FUSED_SCORES = ("ai_score", "misinfo_score", "deepfake_score",
                "clip_similarity", "fake_probability")


def qkv_kernel_rows(card):
    """Phase 29 (a), K2 alone at QKV_SHAPES: bit for bit its plain version
    and the three unfused launches (ops/kernel_checks.py), then CUDA-event
    ms, device µs (fused, and the three unfused launches), the plain
    version, torch._int_mm of the same integer product and the bound."""
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import kernel_checks as KC
    rows = {}
    for name, M, K, N in QKV_SHAPES:
        case = KC.int8_dense_case(M, K, N)
        res = KC.check_int8_dense_fused(case)
        a = (case["x"], case["wq"], case["w_scale"], case["bias"])
        parts = [(c["x"], c["wq"], c["w_scale"], c["bias"])
                 for c in KC.split_qkv_case(case)]
        fn = lambda a=a: K2.int8_dense(*a)                      # noqa: E731
        row = {"err": 0.0, **_timed(
            f"int8_dense fused qkv {name} M={M} K={K} N={N}", fn,
            lambda a=a: K2.int8_dense_plain(*a), None,
            nbytes(*a) + M * N * 2, 2 * M * K * N, "int8", card)}
        row["device_us"] = device_us(fn, 50)[0]
        row["unfused_device_us"] = device_us(
            lambda: [K2.int8_dense(*p) for p in parts], 20)[0]
        row["int_mm_ms"] = int_mm_ms(M, K, N)
        print(f"int8_dense fused qkv {name}: bitwise equal to its plain "
              f"version and to the three unfused launches (a one-ulp scale "
              f"fault moves {res['fault_elements']} outputs); device "
              f"{row['device_us']} us, the three unfused launches "
              f"{row['unfused_device_us']} us; torch._int_mm of the product "
              f"{row['int_mm_ms']} ms [{card}]", flush=True)
        rows[name] = row
    return rows


def fused_qkv_phase(default, vault_path, batch, b32, card):
    """Phase 29 (a): serving's QKV fuse at full width. K2 alone at the
    fused shapes (qkv_kernel_rows); then phase 4's seeded tree, fused and
    not, in two quant="int8" engines: the mixed batch's and the b32
    batch's reports equal (==), K2 launched 72 times per full program
    against 144, K1 36 times in both; two more such engines with
    use_pallas=True: K3 36 times in both and the scores within
    FUSED_BAND; and a fused int8_ffn engine
    (quant "auto") against phase 4's unfused one within FUSED_BAND, K1 36
    times. b32/S512 verdicts/s fused against unfused, in turns (printed
    only). Returns (K2's fused rows by shape, the launches of the fused
    int8 engine's b32 run)."""
    import gc
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops.serving import fuse_qkv_params
    start = time.perf_counter()
    rows = qkv_kernel_rows(card)
    det = DetectorConfig()
    tree = detector_init(default.cfg.seed, det)     # phase 4's weights
    fused_tree = fuse_qkv_params(tree)
    mods = {"int8_dense": K2, "int8_ffn": K1, "fused_attention": K3}

    def engine(quant, params, use_pallas=False):
        cfg = ForensicsConfig(verbose=False)
        cfg = cfg.replace(
            paths=dataclasses.replace(cfg.paths, vault_path=vault_path),
            precision=dataclasses.replace(cfg.precision, quant=quant))
        eng = MisinfoForensics(cfg, det, params=params, device="cuda",
                               use_pallas=use_pallas, cuda_graphs=False)
        qkv = eng.params["roberta"]["layers"][0]["attn"].get("qkv")
        if (qkv is not None) != (params is fused_tree):
            raise AssertionError("phase 29: the engine's tree is not the "
                                 "one it was given")
        D = det.roberta.hidden_size
        if quant == "int8" and qkv is not None and not (
                tuple(qkv["kernel_q"].shape) == (D, 3 * D)
                and (qkv["kernel_q"].t().is_contiguous()
                     or not qkv["kernel_q"].is_cuda)):
            raise AssertionError(f"phase 29: the fused int8 kernel is not "
                                 f"a K-major [{D}, {3 * D}]")
        return eng

    def counted(eng, reqs):
        for m in mods.values():
            m.launches = 0          # this path's run starts here
        reports = eng.analyze_batch(reqs)
        torch.cuda.synchronize()
        return reports, {n: m.launches for n, m in mods.items()}

    def drift(a, b):
        return max(abs(x["scores"][k] - y["scores"][k])
                   for x, y in zip(a, b) for k in FUSED_SCORES)

    engines = {label: engine("int8", params) for label, params in
               (("unfused", tree), ("fused", fused_tree))}
    out = {}
    for label, eng in engines.items():
        eng.analyze_batch(batch)                    # build, warm up
        mixed, _ = counted(eng, batch)
        big, counts = counted(eng, b32)
        k3 = engine("int8", tree if label == "unfused" else fused_tree,
                    use_pallas=True)    # the fused attention kernel (K3)
        k3.analyze_batch(batch)
        with_k3, counts_k3 = counted(k3, b32)
        del k3
        check_reports(mixed + big + with_k3, f"phase 29 int8 {label}")
        out[label] = (mixed, big, with_k3, counts, counts_k3)
        print(f"phase 29 int8 engine, {label} QKV: launches of the b32 full "
              f"program {counts} (K2 want {K2_PER_FULL[label]}), with "
              f"use_pallas=True {counts_k3} [{card}]", flush=True)
        if counts != {"int8_dense": K2_PER_FULL[label],
                      "int8_ffn": PER_PROGRAM["full"],
                      "fused_attention": 0} or counts_k3 != {
                **counts, "fused_attention": PER_PROGRAM["full"]}:
            raise AssertionError(f"phase 29: {label} launches {counts}, "
                                 f"with K3 {counts_k3}")
    u, f = out["unfused"], out["fused"]
    same = (u[0] == f[0], u[1] == f[1])
    k3_drift = drift(u[2], f[2])
    print(f"phase 29 int8: fused reports == unfused: mixed batch {same[0]}, "
          f"b32 {same[1]}; with K3 max score drift {k3_drift} (band "
          f"{FUSED_BAND}; equal {u[2] == f[2]})", flush=True)
    if not (all(same) and k3_drift <= FUSED_BAND):
        raise AssertionError("phase 29: the fused int8 engine differs")
    vps = {}
    for label in ("unfused", "fused", "fused again", "unfused again"):
        vps[label] = verdicts_per_s(engines[label.split()[0]], b32)
    print("phase 29 int8 b32/S512 verdicts/s, fused QKV against unfused, "
          "in turns: " + ", ".join(f"{k} {v}" for k, v in vps.items())
          + f" [{card}]", flush=True)
    launches = u[3]["int8_dense"], f[3]["int8_dense"]
    del engines, out, u, f
    gc.collect()
    torch.cuda.empty_cache()

    ffn = engine("auto", fused_tree)
    if ffn.quant != "int8_ffn":
        raise AssertionError(f"phase 29: quant='auto' resolved to {ffn.quant}")
    ffn.analyze_batch(batch)
    got, counts = counted(ffn, batch)
    want = default.analyze_batch(batch)
    d = drift(want, got)
    big, counts_b32 = counted(ffn, b32)
    check_reports(got + big, "phase 29 int8_ffn fused")
    vps = {}
    for label, eng in (("unfused (phase 4)", default), ("fused", ffn),
                       ("fused again", ffn), ("unfused again", default)):
        vps[label] = verdicts_per_s(eng, b32)
    print(f"phase 29 int8_ffn (bf16 QKV): fused against phase 4's unfused "
          f"engine, mixed batch max score drift {d} (band {FUSED_BAND}); "
          f"launches mixed {counts}, b32 {counts_b32} (K1 want "
          f"{PER_PROGRAM['full']}); b32/S512 verdicts/s "
          + ", ".join(f"{k} {v}" for k, v in vps.items()) + f" [{card}]",
          flush=True)
    if not (d <= FUSED_BAND and counts_b32 == {
            "int8_dense": 0, "int8_ffn": PER_PROGRAM["full"],
            "fused_attention": 0}):
        raise AssertionError(f"phase 29: int8_ffn fused drift {d}, "
                             f"launches {counts_b32}")
    del ffn
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 29 (a): {time.perf_counter() - start} s", flush=True)
    return rows, launches[1]


def isolation_phase(tr, wav, text, card):
    """Phase 29 (b): transcribe() of the 20 s clip on a warmed transcriber
    with MISINFO_TPU_TRANSCRIPT_ISOLATION=0, then 1 twice: the text of all
    three equal to ``text`` (phase 6's), one pool (the class's, made at
    the first transcribe() of the script with isolation on) reused; the
    worker a
    process of its own, its niceness 10 above this one's, no CUDA context
    in it; the host prep's ms inline and in the worker (printed)."""
    from statistics import median
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    env = "MISINFO_TPU_TRANSCRIPT_ISOLATION"
    saved = os.environ.get(env)
    before = WhisperTranscriber._POOL   # made by an earlier transcribe()
    texts, walls, pools, prep = [], [], [], {}
    try:
        for value in ("0", "1", "1"):
            os.environ[env] = value
            t0 = time.perf_counter()
            texts.append(tr.transcribe(wav))
            walls.append(time.perf_counter() - t0)
            pools.append(WhisperTranscriber._POOL)
        for value in ("0", "1"):
            os.environ[env] = value
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                tr._host_prep(wav)
                ms.append((time.perf_counter() - t0) * 1e3)
            prep["inline" if value == "0" else "worker"] = median(ms)
    finally:
        if saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved
    pool = pools[-1]
    if pool is None:
        raise AssertionError("phase 29: no host-prep worker pool")
    ask = lambda expr: pool.submit(eval, expr).result()      # noqa: E731
    pid = ask("__import__('os').getpid()")
    nice = ask("__import__('os').nice(0)")
    torch_in = ask("'torch' in __import__('sys').modules")
    cuda = ask("(lambda t: t is not None and t.cuda.is_initialized())("
               "__import__('sys').modules.get('torch'))")
    method = ask("__import__('multiprocessing').get_start_method()")
    want_nice = min(os.nice(0) + 10, 19)
    print(f"phase 29 (b) isolation: transcribe() at 0, 1, 1: wall s "
          f"{walls}, texts equal to phase 6's {[t == text for t in texts]}; "
          f"one pool, reused {pools[1] is pools[2]} (made by an earlier "
          f"phase's transcribe() {pools[1] is before}); worker pid {pid} "
          f"(this process "
          f"{os.getpid()}), start method {method}, niceness {nice} (want "
          f"{want_nice}), torch imported in it {torch_in} (the spawned "
          f"child re-imports this script), CUDA initialized in it {cuda}; "
          f"host prep ms of the clip: inline {prep['inline']}, worker "
          f"{prep['worker']} [{card}]", flush=True)
    if not (all(t == text for t in texts) and pools[1] is not None
            and pools[1] is pools[2]
            and pid != os.getpid() and method == "spawn"
            and nice == want_nice and cuda is False):
        raise AssertionError("phase 29: the isolated host prep")


ARCHIVE_PAGES = 600
PREP_FUSION_ROWS, PREP_EPOCHS = 192, 3


def write_archive(root: str, rng):
    """ARCHIVE_PAGES pages in ten folders. Page i: og:title and og:image
    pointing at a seeded local 224² PNG (block_image), but every 20th page
    (i % 20 == 0) has only <h1> and <img>, i % 20 == 1 points at a broken
    image file and i % 20 == 2 has no title. Returns {title: image} of the
    pages with a title and a readable image, with and without bs4 (the
    regex fallback reads og tags only)."""
    from PIL import Image
    imgs = os.path.join(root, "images")
    os.makedirs(imgs)
    want = {"bs4": {}, "regex": {}}
    for i in range(ARCHIVE_PAGES):
        d = os.path.join(root, "site", f"sec{i % 10}")
        os.makedirs(d, exist_ok=True)
        img = os.path.join(imgs, f"{i}.png")
        kind = i % 20
        if kind == 1:
            with open(img, "wb") as f:
                f.write(b"\x89PNG broken")
        else:
            Image.fromarray(block_image(5000 + i)).save(img, compress_level=1)
        title = f"Archive story {i}: {words(rng, 8)}"
        if kind == 0:
            page = f"<h1>{title}</h1><p>{words(rng, 20)}</p><img src=\"{img}\">"
        elif kind == 2:
            page = f'<meta property="og:image" content="{img}">'
        else:
            page = (f'<html><head><meta property="og:title" content="{title}">'
                    f'<meta property="og:image" content="{img}"></head>'
                    f"<body><h1>{title}</h1><p>{words(rng, 40)}</p></body>"
                    "</html>")
        with open(os.path.join(d, f"story{i:04d}.html"), "w") as f:
            f.write(page)
        if kind not in (1, 2):
            want["bs4"][title] = img
            if kind != 0:
                want["regex"][title] = img
    return want


def write_harmonize_sources(root: str, rng):
    """A CIFAKE tree (train/test × REAL/FAKE, 32² PNGs) and a Fakeddit TSV
    whose every fourth post has no image."""
    from PIL import Image
    n = 0
    for split in ("train", "test"):
        for sub in ("REAL", "FAKE"):
            d = os.path.join(root, "cifake", split, sub)
            os.makedirs(d)
            for i in range(40):
                Image.fromarray(rng.integers(0, 256, (32, 32, 3),
                                             dtype=np.uint8)).save(
                    os.path.join(d, f"{i}.png"))
                n += 1
    imgs = os.path.join(root, "fakeddit")
    os.makedirs(imgs)
    rows = []
    for i in range(160):
        if i % 4:
            with open(os.path.join(imgs, f"fd{i}.jpg"), "wb") as f:
                f.write(b"x")
        rows.append(f"fd{i}\t{words(rng, 6)}\t{i % 2}")
    tsv = os.path.join(root, "fakeddit.tsv")
    with open(tsv, "w") as f:
        f.write("id\tclean_title\t2_way_label\n" + "\n".join(rows) + "\n")
    return os.path.join(root, "cifake"), tsv, imgs, n + 120


def data_path_phase(rng, card):
    """Phase 29 (c): a generated archive of ARCHIVE_PAGES pages through
    the port's guardian_prep.main (15 workers): the article count, the
    CSVs (80/20 at the article level, one matched and one mismatched pair
    per article) and vector_db_seed.json; clip_detective.build_vault on
    the card; an engine on that vault (seeded weights, vision class and
    position embeddings zeroed: vault_params) whose analyze() of an
    article's own title and saved image ranks the article first with the
    gate open; data_prep.prepare_fusion_dataset over clip_train.csv and
    generated HC3 and WELFake CSVs; fusion_judge.train on its first
    PREP_FUSION_ROWS rows through that engine for PREP_EPOCHS epochs (K1
    36 × the sweep's programs, the engine's tree untouched); and
    harmonize_datasets on a generated CIFAKE tree and Fakeddit TSV. Rows/s
    of each prep step and the build's images/s printed. Returns K1's
    launches in the sweep."""
    import gc
    import importlib.util
    import pickle
    import pandas as pd
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.train import (
        clip_detective, data_prep, fusion_judge, guardian_prep)
    from misinfo_tpu_torch.utils.tree import clone_tree
    start = time.perf_counter()
    quiet = lambda *_: None     # noqa: E731
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    try:
        with contextlib.chdir(tmp):
            branch = ("bs4" if importlib.util.find_spec("bs4") is not None
                      else "regex")
            want = write_archive("archive", rng)[branch]
            t0 = time.perf_counter()
            guardian_prep.main(["--archive-dir", "archive"])
            prep_s = time.perf_counter() - t0
            with open("vector_db_seed.json", encoding="utf-8") as f:
                seed = json.load(f)
            train, val = (pd.read_csv(f"clip_{s}.csv")
                          for s in ("train", "val"))
            n = len(seed)
            n_val = int(n * 0.2)
            titles = {a["image_local_path"]: a["text_content"] for a in seed}
            pairs_ok = all(
                (df["label"] == 0).sum() == (df["label"] == 1).sum()
                and all((r.text == titles[r.image_path]) == (r.label == 0)
                        for r in df.itertuples()) for df in (train, val))
            print(f"phase 29 (c) guardian_prep.main ({branch} branch): "
                  f"{ARCHIVE_PAGES} pages -> {n} articles (want {len(want)})"
                  f" in {prep_s} s, {ARCHIVE_PAGES / prep_s} pages/s; "
                  f"clip_train {len(train)} rows, clip_val {len(val)}; "
                  f"pairs ok {pairs_ok} [{card}]", flush=True)
            if not (n == len(want) and {a["text_content"] for a in seed}
                    == set(want) and len(val) == 2 * n_val
                    and len(train) == 2 * (n - n_val) and pairs_ok
                    and not set(train.image_path) & set(val.image_path)):
                raise AssertionError("phase 29: guardian_prep's outputs")

            tree = vault_params()
            t0 = time.perf_counter()
            vault = clip_detective.build_vault(
                "vector_db_seed.json", "guardian_embeddings.npz",
                params=tree, log=quiet, device="cuda")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            eng, boot_s = vault_engine(tree, "guardian_embeddings.npz")
            art = seed[n // 2]
            report = eng.analyze(art["text_content"],
                                 art["image_local_path"], verbose=False)
            check_reports([report], "phase 29 analyze on the built vault")
            title, sim = top(report)
            gate = report["scores"]["vault_discrepancy"]
            print(f"phase 29 (c) build_vault: {vault.num_articles} rows in "
                  f"{build_s} s, {vault.num_articles / build_s} images/s; "
                  f"engine booted on it in {boot_s} s; analyze of "
                  f"{art['article_id']}'s title and image: top match "
                  f"{title == art['text_content']} at {sim}, gate {gate} "
                  f"[{card}]", flush=True)
            if not (vault.num_articles == n and title == art["text_content"]
                    and gate > 0.85):
                raise AssertionError("phase 29: the built vault's top match")

            for name in ("hc3", "welfake"):
                pd.DataFrame([{"text": words(rng, int(rng.integers(30, 120))),
                               "label": i % 2} for i in range(300)]
                             ).to_csv(f"{name}.csv", index=False)
            t0 = time.perf_counter()
            df = data_prep.prepare_fusion_dataset(
                "clip_train.csv", "hc3.csv", "welfake.csv",
                "Final_Fusion_Train.csv", log=quiet)
            fusion_s = time.perf_counter() - t0
            fusion_before = clone_tree(eng.params["fusion"])
            K1.launches = 0         # this path's run starts here
            with counting_runs(eng) as seen:
                res = fusion_judge.train(
                    "Final_Fusion_Train.csv", "fusion_out", engine=eng,
                    epochs=PREP_EPOCHS, max_samples=PREP_FUSION_ROWS,
                    log=quiet)
            launches = K1.launches  # read just after the sweep
            want_k1 = sum(PER_PROGRAM[v] for v in seen)
            intact = same_leaves(fusion_before, eng.params["fusion"])
            only_fusion = same_leaves(eng.params, res.params,
                                      ("roberta", "ai_head", "misinfo_head",
                                       "efficientnet", "clip"))
            print(f"phase 29 (c) prepare_fusion_dataset: {len(df)} rows "
                  f"({int(df['label'].sum())} fake) in {fusion_s} s, "
                  f"{len(df) / fusion_s} rows/s; fusion_judge on "
                  f"{PREP_FUSION_ROWS} of them, {PREP_EPOCHS} epochs: "
                  f"programs {seen}, K1 launches {launches} (want {want_k1}"
                  f" = 36 x programs), best accuracy {res.best_metric}; the "
                  f"engine's fusion leaves untouched {intact}, the other "
                  f"branches of the trained tree the engine's {only_fusion}",
                  flush=True)
            if not (seen and launches == want_k1 and intact and only_fusion
                    and len(df) > PREP_FUSION_ROWS):
                raise AssertionError("phase 29: the fusion judge's sweep")
            del eng, res, tree
            gc.collect()
            torch.cuda.empty_cache()

            cifake, tsv, imgs, n_items = write_harmonize_sources("h", rng)
            t0 = time.perf_counter()
            items = data_prep.harmonize_datasets(
                cifake, tsv, imgs, n_per_label=60, out_pkl="h.pkl",
                out_seed_json="h_seed.json", log=quiet)
            harm_s = time.perf_counter() - t0
            with open("h.pkl", "rb") as f:
                kept = pickle.load(f)
            with open("h_seed.json", encoding="utf-8") as f:
                genuine = json.load(f)
            labels = sorted(it["label"] for it in kept)
            print(f"phase 29 (c) harmonize_datasets: {n_items} items -> "
                  f"{len(kept)} balanced ({labels.count(0)} real, "
                  f"{labels.count(1)} fake), seed JSON {len(genuine)} in "
                  f"{harm_s} s, {n_items / harm_s} rows/s", flush=True)
            if not (kept == items and labels == [0] * 60 + [1] * 60
                    and genuine == [it for it in kept if it["label"] == 0]):
                raise AssertionError("phase 29: harmonize_datasets")
        print(f"phase 29 (c): {time.perf_counter() - start} s", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------- mesh serving (phase 30)

def one_card_mesh(data: int = 1, model: int = 1):
    """A data × model grid naming the one card once per position."""
    from misinfo_tpu_torch.core.config import MeshConfig
    from misinfo_tpu_torch.core.mesh import make_mesh
    return make_mesh(MeshConfig(data=data, model=model),
                     devices=["cuda:0"] * (data * model))


@contextlib.contextmanager
def counting_mesh_programs(S):
    """Count the mesh programs that search the vault (every kind but
    text_only) for the duration of the block."""
    real = S.mesh_program
    seen = {"visual": 0}

    def spy(params, batch, *, kind, **kw):
        if kind != "text_only":
            seen["visual"] += 1
        return real(params, batch, kind=kind, **kw)
    S.mesh_program = spy
    try:
        yield seen
    finally:
        S.mesh_program = real


def mesh_runners(engine) -> tuple:
    """An engine's runners, and how many of them hold a CUDA graph."""
    return (len(engine._runners),
            sum(r.graph is not None for r in engine._runners.values()))


def score_drift(a, b) -> float:
    return max(abs(x["scores"][k] - y["scores"][k]) for x, y in zip(a, b)
               for k in ("ai_score", "misinfo_score", "deepfake_score",
                         "clip_similarity", "vault_discrepancy",
                         "text_similarity", "fake_probability"))


def mesh_engine_phase(engine, vault_path, batch, b32, image, card):
    """Phase 30 (a), (d) and (f) on phase 4's weights (their f32 canonical
    tree) and vault. Returns K2's launches in (d)'s int8 run."""
    from misinfo_tpu_torch.core.config import ForensicsConfig, PrecisionConfig
    from misinfo_tpu_torch.core.mesh import make_mesh
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops.serving import deoptimize_params
    from misinfo_tpu_torch.serve import cli
    from misinfo_tpu_torch.serve import transcript as T
    start = time.perf_counter()
    tree = deoptimize_params(engine.params)
    base = ForensicsConfig(verbose=False)
    base = base.replace(paths=dataclasses.replace(base.paths,
                                                  vault_path=vault_path))
    real = F.MisinfoForensics

    def boot(precision, mesh=None, graphs=False):
        t0 = time.perf_counter()
        e = real(base.replace(precision=precision), DetectorConfig(),
                 params=tree, mesh=mesh, device="cuda", cuda_graphs=graphs)
        torch.cuda.synchronize()
        return e, time.perf_counter() - t0

    # (a) make_mesh() over the visible card: data=1 serves the b32 batch
    # as the engine without a mesh does (quant "auto" → "none" under a
    # mesh; the single engine is given "none"), both through CUDA graphs;
    # then data=2 over cuda:0 twice, one graph per data position, against
    # the same mesh run eagerly
    mesh1 = make_mesh()
    if mesh1.shape != {"data": 1, "model": 1}:
        raise AssertionError(f"make_mesh() on one card: {mesh1}")
    none = dataclasses.replace(base.precision, quant="none")
    single, boot_1 = boot(none, graphs=True)
    meshed, boot_m = boot(base.precision, mesh1, graphs=True)
    if meshed.quant != "none":
        raise AssertionError(f"quant under a mesh resolved to {meshed.quant}")
    want, got = single.analyze_batch(b32), meshed.analyze_batch(b32)
    check_reports(got, "phase 30 (a) mesh data=1")
    same = got == want
    vps = {"no mesh": verdicts_per_s(single, b32),
           "mesh data=1": verdicts_per_s(meshed, b32)}
    runs = mesh_runners(meshed)
    del single, meshed
    eager2, _ = boot(none, one_card_mesh(2))
    graph2, boot_2 = boot(none, one_card_mesh(2), graphs=True)
    want, got = eager2.analyze_batch(b32), graph2.analyze_batch(b32)
    same2 = got == want
    runs2 = mesh_runners(graph2)
    vps.update({"mesh data=2 eager": verdicts_per_s(eager2, b32),
                "mesh data=2 graphs": verdicts_per_s(graph2, b32)})
    print(f"phase 30 (a): make_mesh() → {mesh1}; b32 reports == the "
          f"engine without a mesh: {same} (runners, graphs: {runs}); "
          f"data=2 over cuda:0 twice, graphed per position == eager: "
          f"{same2} (runners, graphs: {runs2}); boots {boot_1:.1f} / "
          f"{boot_m:.1f} / {boot_2:.1f} s; verdicts/s {json.dumps(vps)} "
          f"[{card}]", flush=True)
    if not (same and same2 and runs[0] == runs[1] > 0
            and runs2[0] == runs2[1] > 0 and runs2[0] % 2 == 0):
        raise AssertionError("phase 30 (a): mesh reports or graphs")
    del eager2, graph2

    # (d) data=1 × model=2 over cuda:0 twice, f32 parity: heads and FFN
    # columns split, the o / mlp_out partials summed before the bias
    tp_mesh = one_card_mesh(1, 2)
    f32 = PrecisionConfig.highest()
    s32, _ = boot(f32)
    t32, boot_t = boot(f32, tp_mesh)
    want, got = s32.analyze_batch(batch), t32.analyze_batch(batch)
    check_reports(got, "phase 30 (d) model=2 f32")
    drift = score_drift(got, want)
    verdicts = all(a["verdict"] == b["verdict"] or abs(
        b["scores"]["fake_probability"] - 0.5) < 1e-3
        for a, b in zip(got, want))
    vps = {"f32 no mesh": verdicts_per_s(s32, b32, reps=1),
           "f32 model=2": verdicts_per_s(t32, b32, reps=1)}
    print(f"phase 30 (d): data=1 × model=2 f32 against the single-device "
          f"f32 engine: max score drift {drift} (limit 1e-3), verdicts "
          f"equal {verdicts}; boot {boot_t:.1f} s; b32 verdicts/s "
          f"{json.dumps(vps)} [{card}]", flush=True)
    if not (drift < 1e-3 and verdicts):
        raise AssertionError(f"phase 30 (d): model=2 drift {drift}")
    del s32, t32

    # (d) int8 under model=2: the column-split products per position, the
    # row-split inputs quantized with the group's abs-max (one more column,
    # padded to K + 64), all through K2. The first input of each K2 shape
    # is kept and the kernel held against its plain version on it; the
    # whole batch is served again with K2's plain version in its place
    i8 = dataclasses.replace(base.precision, quant="int8")
    si8, _ = boot(i8)
    ti8, _ = boot(i8, tp_mesh)
    want = si8.analyze_batch(batch)
    torch.cuda.synchronize()
    real_k2, first = K2.int8_dense, {}

    def keep(x, wq, w_scale, bias=None, **kw):
        key = (x.shape[-1], wq.shape[1], kw.get("out_dtype"))
        if key not in first:
            first[key] = (x.clone(), wq, w_scale, bias, kw)
        return real_k2(x, wq, w_scale, bias, **kw)
    with swapped((K2, "int8_dense", keep)):
        K1.launches = K2.launches = 0       # this path's run starts here
        got = ti8.analyze_batch(batch)
        torch.cuda.synchronize()
        k1, k2 = K1.launches, K2.launches  # read just after the path
    check_reports(got, "phase 30 (d) model=2 int8")
    drift = score_drift(got, want)
    errs = {f"K={k} N={n}": float((real_k2(x, w, s, b, **kw)
                                   - K2.int8_dense_plain(x, w, s, b, **kw))
                                  .abs().max())
            for (k, n, _), (x, w, s, b, kw) in first.items()}
    with swapped((K2, "int8_dense", K2.int8_dense_plain)):
        plain = ti8.analyze_batch(batch)
    print(f"phase 30 (d): data=1 × model=2 quant='int8' against the "
          f"single-device int8 engine (K1 FFNs there): max score drift "
          f"{drift} (limit 0.01); K2 launches {k2}, K1 {k1}; K2 against "
          f"its plain version at each of the run's shapes, max abs error "
          f"{json.dumps(errs)}; reports with K2's plain version == the "
          f"kernel's {plain == got} (max score drift "
          f"{score_drift(plain, got)}) [{card}]", flush=True)
    if not (drift < 0.01 and k2 > 0 and k1 == 0 and plain == got
            and not any(errs.values())):
        raise AssertionError(f"phase 30 (d) int8: drift {drift}, K2 {k2}, "
                             f"K1 {k1}, errors {errs}")
    del si8, ti8

    # (f) the CLI: --mesh data=1 serves and reaches the transcriber;
    # --mesh data=2 is make_mesh's ValueError on one card
    built = []

    def factory(config=None, device="cuda", mesh=None, **kw):
        built.append(real(config, DetectorConfig(), params=tree, mesh=mesh,
                          device=device, cuda_graphs=False))
        return built[-1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_cli_")
    png = png_path(image, os.path.join(tmp, "image.png"))
    out = os.path.join(tmp, "report.json")
    argv = ["--text", "a caption for the mesh", "--image", png, "--device",
            "cuda", "--quiet", "--vault", vault_path, "--output", out]
    try:
        with swapped((F, "MisinfoForensics", factory)):
            rc = cli.main(argv + ["--mesh", "data=1"])
            mesh_set = T._default_mesh is built[-1].mesh
            try:
                cli.main(argv + ["--mesh", "data=2"])
                refused = "not refused"
            except ValueError as e:
                refused = str(e)
    finally:
        T.reset_transcriber()
    with open(out) as f:
        report = json.load(f)
    check_reports([report], "phase 30 (f) CLI")
    print(f"phase 30 (f): CLI --mesh data=1 rc {rc}, engine mesh "
          f"{built[0].mesh.shape}, transcriber mesh set {mesh_set}, verdict "
          f"{report['verdict_text']}; --mesh data=2: {refused!r}; engines "
          f"built {len(built)}", flush=True)
    if (rc != 0 or not mesh_set or len(built) != 1
            or refused != "mesh 2x1 != 1 devices"):
        raise AssertionError("phase 30 (f): the CLI's --mesh")
    shutil.rmtree(tmp)
    print(f"phase 30 (a, d, f): {time.perf_counter() - start:.1f} s",
          flush=True)
    return k2


def mesh_vault_phase(params, path, reqs, plants, q32, card, host_vault):
    """Phase 30 (b) and (c) on phase 10's 262,144-row vault: data=2 over
    cuda:0 twice, the vault replicated on both positions against the
    vault row-sharded over them (vault_shard_min_rows below its rows), in
    f32 and int4; every boot reads ``host_vault``, phase 11's load of
    ``path``. Returns K10b's launches in (c)'s run."""
    from misinfo_tpu_torch.engine import signals as S
    from misinfo_tpu_torch.vault import int4 as K10
    from misinfo_tpu_torch.vault import store
    from misinfo_tpu_torch.vault.search import (
        vault_search, vault_search_sharded)
    start = time.perf_counter()
    mesh = one_card_mesh(2)
    def load_once(p):           # one host load for the four boots
        if p != path:
            raise AssertionError(f"phase 30 (b, c): a boot loaded {p}")
        return host_vault
    k10_run = 0
    with swapped((store.TruthVault, "load", load_once)):
        for dt in ("float32", "int4"):
            rep, boot_r = vault_engine(params, path, mesh=mesh,
                                       vault_dtype=dt)
            shd, boot_s = vault_engine(params, path, mesh=mesh,
                                       vault_dtype=dt,
                                       vault_shard_min_rows=VAULT_ROWS // 2)
            if rep._vault_sharded or not shd._vault_sharded:
                raise AssertionError(f"phase 30 {dt}: shard decision")
            want = rep.analyze_batch(reqs)
            torch.cuda.synchronize()
            with counting_mesh_programs(S) as seen:
                K10.launches = K10.launches_i8 = 0   # the run starts here
                got = shd.analyze_batch(reqs)
                torch.cuda.synchronize()
                k10 = (K10.launches, K10.launches_i8)  # read just after
            check_vault_reports(got, plants, f"phase 30 {dt} sharded")
            same = got == want
            # the replicated engine scores each position's 16 queries, the
            # sharded one all 32 against each shard (JAX's layouts): the
            # f32 product may round differently for another row count
            idx_same = all(
                [m["title"] for m in a["vault_matches"]]
                == [m["title"] for m in b["vault_matches"]]
                and a["verdict"] == b["verdict"] for a, b in zip(got, want))
            sim_diff = max(abs(x["similarity"] - y["similarity"])
                           for a, b in zip(got, want)
                           for x, y in zip(a["vault_matches"],
                                           b["vault_matches"]))
            rd, sd = rep._vault_device, shd._vault_device
            scale_r = rd.get("vault_scale")

            def full():
                return vault_search(
                    q32, rd["vault_emb"][0], rd["vault_valid"][0], top_k=5,
                    vault_scale=None if scale_r is None else scale_r[0])

            def sharded():
                return vault_search_sharded(
                    q32, sd["vault_emb"], sd["vault_valid"], mesh=mesh,
                    top_k=5, vault_scale=sd.get("vault_scale"))
            r1, r2 = full(), sharded()
            fn_same = (torch.equal(r1.top_idx, r2.top_idx)
                       and torch.equal(r1.top_sims, r2.top_sims))
            ms = {"replicated": cuda_ms(full, 10),
                  "sharded": cuda_ms(sharded, 10)}
            vps = {"replicated": verdicts_per_s(rep, reqs, reps=2),
                   "sharded": verdicts_per_s(shd, reqs, reps=2)}
            line = (f"phase 30 ({'b' if dt == 'float32' else 'c'}) {dt}: "
                    f"data=2 over cuda:0 twice, {VAULT_ROWS} rows in shards "
                    f"of {sd['vault_emb'][0].shape[0]}; analyze_batch of "
                    f"{len(reqs)}: top-k rows and verdicts equal the "
                    f"replicated engine's {idx_same}, max top-k sim "
                    f"difference {sim_diff} (limit 1e-6), reports == "
                    f"{same} (planted rows at top-1); vault_search of one "
                    f"B=32 batch, sharded against replicated: top-k "
                    f"torch.equal {fn_same}, ms {json.dumps(ms)}; "
                    f"verdicts/s {json.dumps(vps)}; boots {boot_r:.1f} / "
                    f"{boot_s:.1f} s")
            if dt == "int4":
                per_shard = all(torch.equal(
                    K10.int4_sims_i8(q32, p, s),
                    K10.int4_sims_i8_plain(q32, p, s))
                    for p, s in zip(sd["vault_emb"], sd["vault_scale"]))
                line += (f"; K10b launches {k10[1]} for {seen['visual']} "
                         f"vault programs × 2 shards, K10a {k10[0]}; each "
                         f"shard's K10b torch.equal to its plain version: "
                         f"{per_shard}")
                if k10 != (0, 2 * seen["visual"]) or not per_shard:
                    raise AssertionError(f"phase 30 (c): K10 {k10} for "
                                         f"{seen['visual']} programs")
                k10_run = k10[1]
            print(line + f" [{card}]", flush=True)
            if not (idx_same and sim_diff <= 1e-6 and fn_same
                    and (same or dt == "float32")):
                raise AssertionError(f"phase 30 {dt}: sharded differs from "
                                     "replicated")
            del rep, shd, rd, sd
    print(f"phase 30 (b, c): {time.perf_counter() - start:.1f} s",
          flush=True)
    return k10_run


def mesh_transcript_phase(weights, cfg, card):
    """Phase 30 (e): a 60 s clip (two windows) transcribed under data=2
    over cuda:0 twice and without a mesh in the same decode mode (pallas
    and quant "auto" resolve off under a mesh), at the full 448 decoder
    positions, the ladder's greedy rung and its sampled rung (t 0.2, one
    draw) recorded call by call: each decode's tokens torch.equal, or
    else torch.equal to the witness: each position's windows decoded
    without a mesh, in a batch of that size, on the same noise, so that a
    difference is the batch size's rounding and not the mesh's; every
    position draws the unsplit decode's noise; transcribe() texts
    equal."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.serve import transcript as T
    start = time.perf_counter()
    wav = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_wav60_"),
                       "clip60.wav")
    write_wav(wav, seconds=60.0)
    dc = dataclasses.replace(WhisperDecodeConfig(),
                             fallback_temperatures=(0.0, 0.2), best_of=1)
    plain = T.WhisperTranscriber(weights, config=cfg, device="cuda",
                                 decode_cfg=dataclasses.replace(
                                     dc, pallas="off", quant="none"),
                                 cuda_graphs=False)
    mesh = one_card_mesh(2)
    meshed = T.WhisperTranscriber(weights, config=cfg, decode_cfg=dc,
                                  mesh=mesh)
    if meshed.pallas or meshed.quant_kernels or meshed.quant:
        raise AssertionError("phase 30 (e): the mesh transcriber's mode")
    state = {"draws": None}
    calls = {"plain": [], "mesh": []}

    def recorded(real):
        def draw(shape, gen, dev):
            g = real(shape, gen, dev)
            if state["draws"] is not None:
                state["draws"].append(g.clone())
            return g
        return draw

    def spy(which, tr):
        real = tr._decode

        def decode(enc, prompt, temperature=0.0, seed=None):
            state["draws"] = []
            t0 = time.perf_counter()
            out = real(enc, prompt, temperature, seed)
            torch.cuda.synchronize()
            calls[which].append({
                "t": temperature, "seed": seed, "split": isinstance(enc, list),
                "tokens": out[0].clone(), "draws": state["draws"],
                "prompt": prompt, "s": time.perf_counter() - t0})
            state["draws"] = None
            return out
        return (tr, "_decode", decode)

    def alone(lo, hi, t, seed, prompt):
        """Windows lo:hi decoded without a mesh, drawing rows lo:hi of the
        whole batch's noise, as their data position does."""
        gumbel = None
        if t != 0:
            gen = torch.Generator(plain.device)
            gen.manual_seed(seed)

            def gumbel(step):
                return T.gumbel_noise((len(mels), cfg.vocab_size), gen,
                                      plain.device)[lo:hi]
        return W.decode_transcript(
            plain.params, None, cfg, plain.policy,
            prompt_tokens=prompt[lo:hi], temperature=t,
            enc_out=plain._encode(mels[lo:hi]),
            nospeech_id=plain.tokenizer.specials.no_speech,
            quant=plain.quant, gumbel=gumbel)[0]
    saved = os.environ.get("MISINFO_TPU_TRANSCRIPT_ISOLATION")
    os.environ["MISINFO_TPU_TRANSCRIPT_ISOLATION"] = "0"
    try:
        mels = plain._host_prep(wav)
        with swapped((W, "gumbel_noise", recorded(W.gumbel_noise)),
                     (T, "gumbel_noise", recorded(T.gumbel_noise)),
                     spy("plain", plain), spy("mesh", meshed)):
            texts = (plain.transcribe(wav), meshed.transcribe(wav))
        pc, mc = calls["plain"], calls["mesh"]
        same = [torch.equal(p["tokens"], m["tokens"]) for p, m in zip(pc, mc)]
        pieces = [(int(c[0]), int(c[-1]) + 1) for c in
                  torch.chunk(torch.arange(len(mels)), mesh.data)]
        # the witness, for each decode the mesh changed: each position's
        # tokens against its windows decoded without a mesh
        with torch.inference_mode():
            wit = [eq or all(
                torch.equal(m["tokens"][lo:hi],
                            alone(lo, hi, p["t"], p["seed"], p["prompt"]))
                for lo, hi in pieces)
                for (p, m), eq in zip(zip(pc, mc), same)]
    finally:
        if saved is None:
            del os.environ["MISINFO_TPU_TRANSCRIPT_ISOLATION"]
        else:
            os.environ["MISINFO_TPU_TRANSCRIPT_ISOLATION"] = saved
    same_calls = ([(c["t"], c["seed"]) for c in pc]
                  == [(c["t"], c["seed"]) for c in mc]
                  and all(c["split"] for c in mc))

    def noise_same(p, m):
        """The mesh call's draws (position 0's steps, then position 1's)
        each a prefix of the unsplit call's, row for row."""
        cut = [j for j, g in enumerate(m) if torch.equal(g, p[0])]
        segs = [m[lo:hi] for lo, hi in zip(cut, cut[1:] + [len(m)])]
        return len(segs) == mesh.data and all(
            len(seg) <= len(p) and all(torch.equal(g, p[i])
                                       for i, g in enumerate(seg))
            for seg in segs)
    s_noise = [noise_same(p["draws"], m["draws"])
               for p, m in zip(pc, mc) if p["t"] != 0]
    first = [None if eq else int((p["tokens"] != m["tokens"])
                                 .any(dim=0).nonzero()[0])
             for (p, m), eq in zip(zip(pc, mc), same)]
    walls = [(p["t"], round(p["s"], 3), round(m["s"], 3))
             for p, m in zip(pc, mc)]
    print(f"phase 30 (e): {len(mels)} windows split over data=2 by "
          f"transcribe() (every mesh decode split: {same_calls}), "
          f"{cfg.max_target_positions} decoder positions; the ladder's "
          f"decodes (t, seed) {[(c['t'], c['seed']) for c in pc]} on both; "
          f"tokens torch.equal to the unsplit decode {same} (first "
          f"differing steps {first}); the sampled draws' positions drew "
          f"the unsplit decode's noise {s_noise}; equal or else each "
          f"position's tokens torch.equal to the witness, its windows "
          f"decoded without a mesh (on the same noise): {wit}; "
          f"decode wall s (t, no mesh, mesh) "
          f"{walls}; transcribe() texts equal {texts[0] == texts[1]} "
          f"({len(texts[0])} chars); {time.perf_counter() - start:.1f} s "
          f"[{card}]", flush=True)
    if not (same_calls and pc[0]["t"] == 0 and s_noise and all(s_noise)
            and all(wit) and texts[0] == texts[1]):
        raise AssertionError("phase 30 (e): the mesh transcriber differs")
    shutil.rmtree(os.path.dirname(wav))


# ------------------------------------------------- host residue (phase 34)

_ONSETS = ("", "", "b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n",
           "p", "r", "s", "t", "v", "w", "y", "z", "bl", "br", "ch", "cl",
           "cr", "dr", "fl", "fr", "gl", "gr", "pl", "pr", "sc", "sh", "sk",
           "sl", "sm", "sn", "sp", "st", "str", "sw", "th", "tr", "wh")
_VOWELS = ("a", "e", "i", "o", "u", "a", "e", "i", "o", "ai", "ea", "ee",
           "ie", "oa", "oo", "ou", "y")
_CODAS = ("", "", "", "n", "r", "s", "t", "l", "m", "d", "ck", "ng", "nd",
          "nt", "rd", "rt", "st", "sh", "th", "x")
NON_ASCII = " — café naïve «Zürich» 東京 😀 "


def corpus_words(seed: int, n_types: int) -> list:
    """``n_types`` distinct lowercase pseudo-words of one to four syllables
    from a seed, shortest first: the order is each word's frequency rank
    (``corpus_texts`` draws them by a Zipf law over it)."""
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    while len(out) < n_types:
        w = "".join(_ONSETS[rng.integers(len(_ONSETS))]
                    + _VOWELS[rng.integers(len(_VOWELS))]
                    + _CODAS[rng.integers(len(_CODAS))]
                    for _ in range(1 + rng.binomial(3, 0.4)))
        if len(w) > 1 and w not in seen:
            seen.add(w)
            out.append(w)
    return sorted(out, key=len)


def seeded_bpe_assets(out_dir: str, n_vocab: int = 50_265,
                      seed: int = 34) -> tuple:
    """RoBERTa-form byte-level BPE assets from a seed, with no tokenizer
    library: ``vocab.json`` of ``n_vocab`` ids (<s> 0, <pad> 1, </s> 2,
    <unk> 3, GPT-2's 256 byte symbols, one token a merge, <mask> last) and
    ``merges.txt`` of ``n_vocab`` − 261 merges (50,004 at RoBERTa's
    50,265): the left-to-right merge chains of ``corpus_words``' words by
    rank, each with a leading space (Ġ), the first 3,000 also bare and
    capitalized, after the numbers 0-999. Returns (dir, the corpus's
    words)."""
    from misinfo_tpu_torch.preprocess.bpe import bytes_to_unicode
    b2u = bytes_to_unicode()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for b in range(256):
        vocab[b2u[b]] = len(vocab)
    n_merges = n_vocab - len(vocab) - 1
    merges = []
    words = corpus_words(seed, max(64, n_merges))

    def chain(text: str) -> bool:
        syms = [b2u[b] for b in text.encode("utf-8")]
        tok = syms[0]
        for c in syms[1:]:
            if tok + c not in vocab:
                if len(merges) == n_merges:
                    return False
                merges.append((tok, c))
                vocab[tok + c] = len(vocab)
            tok += c
        return True

    forms = ([f" {n}" for n in range(1000)] + [str(n) for n in range(1000)]
             + [f for r, w in enumerate(words)
                for f in ((f" {w}", w, f" {w.capitalize()}") if r < 3000
                          else (f" {w}",))])
    if all(chain(f) for f in forms):
        raise ValueError(f"{len(words)} words fill {len(merges)} of "
                         f"{n_merges} merges")
    vocab["<mask>"] = len(vocab)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)
    return out_dir, words


def corpus_texts(seed: int, words: list, n_texts: int, n_words: int,
                 non_ascii_every: int = 8) -> list:
    """``n_texts`` texts of ``n_words`` + i words drawn by a Zipf law over
    ``words``' ranks, in sentences (capitals, commas, full stops, a number
    now and then); every ``non_ascii_every``-th text carries NON_ASCII in
    its middle."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.07
    p /= p.sum()
    texts = []
    for i in range(n_texts):
        out, start = [], True
        for j, r in zip(rng.choice(len(words), n_words + i, p=p),
                        rng.random(n_words + i)):
            w = words[j].capitalize() if start else words[j]
            if r < 0.03:
                w += f" {int(r * 70_000)}"
            start = r > 0.93
            out.append(w + ("." if start else "," if r < 0.08 else ""))
        if non_ascii_every and i % non_ascii_every == non_ascii_every - 1:
            out.insert(len(out) // 2, NON_ASCII.strip())
        texts.append(" ".join(out))
    return texts


def encode_ms(tok, texts, max_len: int = 512, reps: int = 3) -> tuple:
    """Host ms of ``tok.batch(texts, max_len)``: the first call (fresh
    word caches) and the best of ``reps`` more (the same batch again)."""
    t0 = time.perf_counter()
    out = tok.batch(texts, max_len)
    fresh = (time.perf_counter() - t0) * 1e3
    again = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        tok.batch(texts, max_len)
        again = min(again, (time.perf_counter() - t0) * 1e3)
    return out, fresh, again


def host_residue_phase(vault_path: str, b32_phase4: list, image, card):
    """Phase 34: the port's host residue on the main path. (a) RoBERTa-form
    BPE assets from a seed; (b) the native encoder against the Python one
    on phase 4's b32 texts and on corpus texts of the same shape, each
    with four non-ASCII rows, at S 512: ids and masks equal, host ms a
    batch fresh and again; (c) an engine at full width with the assets:
    its tokenizer native, the b32 reports equal to the same engine's on
    the Python encoder, eager verdicts/s of both; (d) probe_link(),
    auto_policy() and from_env under MISINFO_TPU_HOST_POLICY=auto (the
    decision applied, an explicit MISINFO_TPU_DEVICE_RESIZE=0 winning),
    host_prep_report's link; (e) profile_trace around one analyze() names
    K1's ffn_up_kernel; nan_guard raises on a NaN made on the card and is
    silent outside."""
    from misinfo_tpu_torch.core.config import ForensicsConfig, ServingConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import cuda_build
    from misinfo_tpu_torch.preprocess import hostprobe
    from misinfo_tpu_torch.preprocess.native_bpe import NativeRobertaTokenizer
    from misinfo_tpu_torch.preprocess.tokenizer import RobertaTokenizer
    from misinfo_tpu_torch.utils.tracing import nan_guard, profile_trace

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bpe_")
    t0 = time.perf_counter()
    assets, words = seeded_bpe_assets(os.path.join(tmp, "roberta"))  # (a)
    vocab, merges = (os.path.join(assets, n)
                     for n in ("vocab.json", "merges.txt"))
    t_assets = time.perf_counter() - t0
    t0 = time.perf_counter()
    cuda_build.build_host("bpe_encoder")
    print(f"phase 34 (a): seeded assets ({len(words)} corpus words) "
          f"{t_assets:.2f} s; encoder build {time.perf_counter() - t0:.2f} s "
          "(cached where phase 2 built it)", flush=True)
    batches = {
        "phase 4's b32": [t + NON_ASCII if i % 8 == 7 else t
                          for i, t in enumerate(b32_phase4)],
        "corpus b32": corpus_texts(35, words, 32, 400)}
    for label, texts in batches.items():                      # (b)
        if sum(not t.isascii() for t in texts) != 4:
            raise AssertionError(f"phase 34 (b) {label}: want 4 non-ASCII")
        t0 = time.perf_counter()
        native = NativeRobertaTokenizer(vocab, merges)
        t_load = time.perf_counter() - t0
        python = RobertaTokenizer(vocab, merges)
        (n_ids, n_mask), n_fresh, n_again = encode_ms(native, texts)
        (p_ids, p_mask), p_fresh, p_again = encode_ms(python, texts)
        if not (np.array_equal(n_ids, p_ids)
                and np.array_equal(n_mask, p_mask)):
            bad = [i for i in range(len(texts))
                   if not np.array_equal(n_ids[i], p_ids[i])]
            raise AssertionError(f"phase 34 (b) {label}: native ids differ "
                                 f"from Python's in rows {bad}")
        print(f"phase 34 (b) {label}: ids and masks equal at S 512 "
              f"({int(n_mask.sum())} tokens, {native.num_threads} threads; "
              f"native load {t_load:.3f} s); host ms a batch, native fresh "
              f"{n_fresh:.2f} again {n_again:.2f}, Python fresh "
              f"{p_fresh:.2f} again {p_again:.2f} [{card}]", flush=True)

    cfg = ForensicsConfig(verbose=False)                      # (c)
    cfg = cfg.replace(paths=dataclasses.replace(
        cfg.paths, vault_path=vault_path, roberta_tokenizer_dir=assets))
    t0 = time.perf_counter()
    eng = MisinfoForensics(cfg, DetectorConfig(), device="cuda",
                           cuda_graphs=False)
    boot = time.perf_counter() - t0
    tok = eng.roberta_tokenizer
    if not (isinstance(tok, NativeRobertaTokenizer) and tok.native_available):
        raise AssertionError(f"phase 34 (c): the engine's tokenizer is "
                             f"{type(tok).__name__}")
    reqs = [{"text": t, "image": image} for t in batches["corpus b32"]]
    native_reports = eng.analyze_batch(reqs)
    check_reports(native_reports, "phase 34 (c)")
    vps_native = verdicts_per_s(eng, reqs)
    eng.roberta_tokenizer = RobertaTokenizer(vocab, merges)
    python_reports = eng.analyze_batch(reqs)
    vps_python = verdicts_per_s(eng, reqs)
    eng.roberta_tokenizer = tok
    if native_reports != python_reports:
        raise AssertionError("phase 34 (c): reports on the native encoder "
                             "differ from the Python encoder's")
    print(f"phase 34 (c): engine boot {boot:.2f} s with the native encoder; "
          f"b32 reports equal on both encoders; eager verdicts/s native "
          f"{vps_native}, Python {vps_python} [{card}]", flush=True)

    link = hostprobe.probe_link()                             # (d)
    decision = hostprobe.auto_policy()
    if link is None or set(link) != {
            "platform", "staging", "staged_h2d_ms_per_image",
            "crops_h2d_ms_per_image", "delta_ms_per_image"}:
        raise AssertionError(f"phase 34 (d): probe_link() = {link}")
    base = ServingConfig()
    with mock.patch.dict(os.environ, MISINFO_TPU_HOST_POLICY="auto"):
        auto = ForensicsConfig.from_env().serving
        with mock.patch.dict(os.environ, MISINFO_TPU_DEVICE_RESIZE="0"):
            explicit = ForensicsConfig.from_env().serving
    want = dataclasses.replace(base, **decision)
    if (auto.fast_decode, auto.device_resize) != (want.fast_decode,
                                                  want.device_resize):
        raise AssertionError(f"phase 34 (d): from_env gave fast_decode="
                             f"{auto.fast_decode}, device_resize="
                             f"{auto.device_resize} for {decision}")
    if explicit.device_resize or explicit.fast_decode != want.fast_decode:
        raise AssertionError("phase 34 (d): MISINFO_TPU_DEVICE_RESIZE=0 "
                             "did not win over the auto policy")
    if eng.host_prep_report().get("link") != link:
        raise AssertionError("phase 34 (d): host_prep_report() has no link")
    print(f"phase 34 (d): probe_link() {json.dumps(link)}; host probe "
          f"{json.dumps(hostprobe.probe_host_prep())}; auto_policy() "
          f"{decision} applied by from_env, MISINFO_TPU_DEVICE_RESIZE=0 wins "
          f"[{card}]", flush=True)

    trace_dir = os.path.join(tmp, "trace")                    # (e)
    with profile_trace(trace_dir):
        eng.analyze(batches["corpus b32"][0], image, verbose=False)
        torch.cuda.synchronize()
    traces = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, traces[0])) as f:
        named = f.read().count("ffn_up_kernel")
    if len(traces) != 1 or not named:
        raise AssertionError(f"phase 34 (e): traces {traces}, "
                             f"{named} mentions of ffn_up_kernel")
    x = torch.tensor([-1.0, 4.0], device="cuda")
    torch.log(x)                                 # silent outside the guard
    try:
        with nan_guard():
            torch.sqrt(x[1:])                    # no NaN: silent
            torch.log(x)
        raise AssertionError("phase 34 (e): nan_guard let a NaN through")
    except FloatingPointError as e:
        print(f"phase 34 (e): the trace names ffn_up_kernel {named} times; "
              f"nan_guard raised: {e}", flush=True)
    del eng
    shutil.rmtree(tmp)


_START = time.perf_counter()


def only_flash() -> int:
    """``--only 32``: phase 32 alone, on phase 4's default engine, vault and
    b32/S512 requests (no result lines)."""
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    card = card_line()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    vault_path = os.path.join(tmp, "vault.npz")
    make_vault(vault_path)
    cfg = ForensicsConfig(verbose=False)
    cfg = cfg.replace(paths=cfg.paths.__class__(vault_path=vault_path))
    engine = MisinfoForensics(cfg, DetectorConfig(), device="cuda",
                              cuda_graphs=False)
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
    b32 = [{"text": words(rng, 400 + i), "image": image} for i in range(32)]
    flash_checks(card)
    flash_engine_phase(engine, vault_path, b32, image, rng, card)
    tiny_detector_check(card)
    stamp("32")
    shutil.rmtree(tmp)
    return 0


def stamp(what: str) -> None:
    """The script's wall seconds so far, after phase ``what``."""
    print(f"[{time.perf_counter() - _START:.1f} s] after phase {what}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="write torch.profiler tables of the b32 batch and "
                    "of one greedy transcript decode here")
    ap.add_argument("--times", action="store_true",
                    help="print only the redesigned kernels' times")
    ap.add_argument("--parent", metavar="DIR",
                    help="with --times: also time the K4, K11 and K11-bwd "
                    "of the tree at DIR, interleaved with this tree's")
    ap.add_argument("--kernels",
                    default="attention,layer_norm,decode,int8,ffn,int4,flash,"
                    "flash_bwd",
                    help="with --times: which kernels to time, a comma list "
                    "of attention, layer_norm, decode, i8cc_layer, int8, ffn, "
                    "int4, flash, flash_bwd")
    ap.add_argument("--only", choices=["31", "32", "33", "34"],
                    help="run phase 31 (training over meshes of the card), "
                    "phase 32 (flash attention), phase 33 (its backward) or "
                    "phase 34 (the host residue) alone and stop there, "
                    "without the result lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.only == "31":
        card = card_line()
        print(card, flush=True)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        vault_path = os.path.join(tmp, "vault.npz")
        make_vault(vault_path)
        mesh_steps_phase(card)
        two_process_phase(vault_path, np.random.default_rng(2), card)
        model_group_phase(np.random.default_rng(3), card)
        stamp("31")
        shutil.rmtree(tmp)
        return 0
    if args.only == "32":
        return only_flash()
    if args.only == "33":
        return only_flash_bwd()
    if args.only == "34":
        card = card_line()
        print(card, flush=True)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        vault_path = os.path.join(tmp, "vault.npz")
        make_vault(vault_path)
        rng = np.random.default_rng(2)
        image = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
        host_residue_phase(vault_path, [words(rng, 400 + i)
                                        for i in range(32)], image, card)
        stamp("34")
        shutil.rmtree(tmp)
        return 0
    if args.times:
        card = card_line()
        print(card, flush=True)
        which = args.kernels.split(",")
        if "attention" in which:
            attention_times(card)
        if "layer_norm" in which:
            layer_norm_times(card, args.parent)
        if "decode" in which:
            decode_step_times(card, strict=False)
        if "i8cc_layer" in which:
            decode_step_times(card, strict=False, only_i8cc_layer=True)
        if "int8" in which:
            int8_times(card)
        if "ffn" in which:
            ffn_times(card)
        if "int4" in which:
            int4_times(card)
        if "flash" in which:
            flash_times(card, parent=args.parent)
        if "flash_bwd" in which:
            flash_bwd_times(card, parent=args.parent)
        return 0
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops import layer_step as K9
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess import native_bpe as NB
    from misinfo_tpu_torch.vault import int4 as K10
    from misinfo_tpu_torch.vault import int4_checks as IC

    card = card_line()
    print(card, flush=True)                                   # phase 1
    build_all([(m, "_library", "build_log")                   # phase 2
               for m in (K1, K2, K3, K5, K6, K7, K9, K10, K11)]
              + [(K3, "_ln_library", "ln_build_log"),
                 (K7, "_library_i8cc", "build_log_i8cc"),
                 (K11, "_bwd_library", "bwd_build_log"),
                 (NB, "_load_lib", None)])
    stamp("2")
    kernel_rows = check_kernel(card)                          # phase 3
    opt_rows = check_opt_in_kernels(card)                     # phase 15
    stamp("3, 15")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    vault_path = os.path.join(tmp, "vault.npz")
    make_vault(vault_path)
    cfg = ForensicsConfig(verbose=True)
    cfg = cfg.replace(paths=cfg.paths.__class__(vault_path=vault_path))
    engine = MisinfoForensics(cfg, DetectorConfig(), device="cuda",
                              cuda_graphs=False)
    if engine.quant != "int8_ffn":
        raise AssertionError(f"quant='auto' resolved to {engine.quant}")
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
    batch = ([{"text": words(rng, n), "image": image}
              for n in (270, 300, 330, 380)]                  # full, dense
             + [{"text": words(rng, n)} for n in (5, 9, 14, 20, 31, 40)]
             + [{"image": image}, {"image": image}])          # packed text

    K1.launches = 0           # the main path's run starts here
    report = engine.analyze(words(rng, 30), image, verbose=False)
    torch.cuda.synchronize()
    after_single = K1.launches
    reports = engine.analyze_batch(batch)
    torch.cuda.synchronize()
    main_launches = K1.launches     # read just after the main path
    check_reports([report], "analyze")
    check_reports(reports, "analyze_batch")
    want_batch = sum(PER_PROGRAM[v] for v in ("full", "text_only",
                                              "visual_only"))
    print(f"K1 launches: analyze {after_single} (want {PER_PROGRAM['full']})"
          f", analyze_batch {main_launches - after_single} "
          f"(want {want_batch})", flush=True)
    if (after_single != PER_PROGRAM["full"]
            or main_launches - after_single != want_batch):
        raise AssertionError("K1 launch count off the expected per-program "
                             "counts")

    full = batch[:4]
    with_kernel = engine.analyze_batch(full)
    with swapped((K1, "int8_ffn", K1.int8_ffn_plain)):
        with_plain = engine.analyze_batch(full)
    drift = max(abs(a["scores"][k] - b["scores"][k])
                for a, b in zip(with_kernel, with_plain)
                for k in ("ai_score", "misinfo_score", "deepfake_score",
                          "clip_similarity", "fake_probability"))
    print(f"engine kernel vs plain FFN: max score drift {drift} "
          "(limit 0.05)", flush=True)
    if not drift < 0.05:
        raise AssertionError(f"engine scores drift {drift} >= 0.05")

    text = words(rng, 30)
    engine.analyze(text, image, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        engine.analyze(text, image, verbose=False)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / 5 * 1e3
    b32 = [{"text": words(rng, 400 + i), "image": image} for i in range(32)]
    vps = verdicts_per_s(engine, b32)
    with swapped((K1, "int8_ffn", K1.int8_ffn_plain)):
        vps_plain = verdicts_per_s(engine, b32)
    vps_again = verdicts_per_s(engine, b32)
    print(f"single analyze latency: {single_ms} ms; full b32/S512: {vps} "
          f"verdicts/s, plain FFN {vps_plain}, kernel again {vps_again} "
          f"[{card}]", flush=True)
    if args.profile:
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        open(args.profile, "w").close()
    stamp("4")
    video_launches, group, seeded, clip_dir = video_phase(    # phase 25
        engine, rng, card)
    engine_surface(engine, batch, image, rng, card)           # phase 24
    stamp("25, 24")
    graph_phase(engine, batch, b32, text, image, group,       # phase 26
                seeded, card, args.profile)
    stamp("26")
    ep_launches = entry_points_phase(batch, vault_path, rng,  # phase 27
                                     card)
    stamp("27")
    train_launches = trainers_phase(engine, vault_path, rng,  # phase 28
                                    card)
    stamp("28")
    qkv_rows, qkv_launches = fused_qkv_phase(                 # 29 (a)
        engine, vault_path, batch, b32, card)
    prep_launches = data_path_phase(rng, card)                # 29 (c)
    stamp("29")
    tp_k2 = mesh_engine_phase(engine, vault_path, batch, b32,  # 30 (a, d,
                              image, card)                    # f)
    stamp("30 (a, d, f)")
    mesh_steps_phase(card)                                    # phase 31 (a)
    two_process_phase(vault_path, rng, card)                  # 31 (b, c)
    model_group_phase(rng, card)                              # 31 (d)
    stamp("31")
    shutil.rmtree(clip_dir)
    opt_launches = opt_in_engines(engine, vault_path, b32,   # phases 16-17
                                  image, rng, card, args.profile)
    stamp("16-17")
    flash_row, _ = flash_checks(card)                         # phase 32 (a)
    flash_launches = flash_engine_phase(engine, vault_path,   # phase 32 (b)
                                        b32, image, rng, card)
    tiny_detector_check(card)
    stamp("32")
    bwd_rows = flash_bwd_checks(card)                         # phase 33 (a)
    train_flash = flash_train_phase(card)                     # phase 33 (b)
    flash_launches += train_flash["forward"]
    stamp("33")
    decode_rows = check_decode_kernels(K6, K7)                # phase 5
    decode_step_times(card)
    decode_rows["cross_ffn_step_i8cc"] = check_i8cc_kernel(K7, card)    # 19
    decode_rows["layer_step"] = check_layer_kernel(K6, K7, K9, card)    # 20
    stamp("5, 19, 20")
    if args.profile:
        append_profile(args.profile, "full b32/S512 analyze_batch",
                       lambda: engine.analyze_batch(b32), rows=40)

    decode_launches = transcript_phases(engine, image, card,  # phases 6-8,
                                        args.profile)         # 18, 21-23
    stamp("6-8, 18, 21-23, 26-29 (transcriber), 30 (e)")
    del engine
    int4_rows = check_int4_kernels(K10, IC, card)             # phase 9
    int4_launches = vault_phases(card, vault_path,            # phases 10-14
                                 args.profile)                # and 30 (b, c)
    stamp("9-14, 30 (b, c)")
    host_residue_phase(vault_path, [r["text"] for r in b32],  # phase 34
                       image, card)
    stamp("34")

    err_k1 = max(r["err"] for r in kernel_rows.values())
    kernels = [{
        "name": name, "route": "cuda",
        "source": "misinfo_tpu_torch/csrc/int8_ffn.cu",
        "replaces": "misinfo_tpu/ops/pallas_int8.py:237",
        "launches": launches, "max_abs_err": err_k1,
        **{k: kernel_rows[shape][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}}
        for name, shape, launches in (
            ("int8_ffn", "roberta",
             main_launches + ep_launches + train_launches + prep_launches),
            ("int8_ffn_b32", "roberta_b32",
             main_launches + ep_launches + train_launches + prep_launches),
            ("int8_ffn_video", "clip_vision_video", video_launches))]
    replaces = {"self_attn_step": "misinfo_tpu/ops/pallas_decode.py:52",
                "self_attn_step_i8": "misinfo_tpu/ops/pallas_decode.py:148",
                "cross_ffn_step": "misinfo_tpu/ops/pallas_cross_ffn.py:125",
                "cross_ffn_step_i8": "misinfo_tpu/ops/pallas_cross_ffn.py:250",
                "cross_ffn_step_i8cc":
                    "misinfo_tpu/ops/pallas_cross_ffn.py:373",
                "layer_step": "misinfo_tpu/ops/pallas_layer.py:48"}
    for name, where in replaces.items():
        row = decode_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("misinfo_tpu_torch/csrc/"
                       f"{name.removesuffix('_i8')}.cu"),
            "replaces": where, "launches": decode_launches[name],
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    for name, line in (("int4_sims", 123), ("int4_sims_i8", 177)):
        row = int4_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "misinfo_tpu_torch/csrc/int4_sims.cu",
            "replaces": f"misinfo_tpu/vault/int4.py:{line}",
            "launches": int4_launches[name], "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    for name, src, where, launches in (
            ("int8_dense", "int8_dense.cu",
             "misinfo_tpu/ops/pallas_int8.py:123",
             opt_launches["int8_dense"] + tp_k2),
            ("fused_attention", "fused_attention.cu",
             "misinfo_tpu/ops/pallas_attention.py:32",
             opt_launches["fused_attention"]),
            ("layer_norm", "layer_norm.cu",
             "misinfo_tpu/ops/pallas_attention.py:115",
             opt_rows["layer_norm"]["launches"]),
            ("fused_ffn", "fused_ffn.cu", "misinfo_tpu/ops/pallas_ffn.py:59",
             opt_launches["fused_ffn"])):
        row = opt_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"misinfo_tpu_torch/csrc/{src}", "replaces": where,
            "launches": launches, "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "misinfo_tpu_torch/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "launches": flash_launches, "max_abs_err": flash_row["err"],
        **{k: flash_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}})
    for which, line in (("dkv", 1121), ("dq", 1456)):
        row = bwd_rows[which]
        kernels.append({
            "name": f"flash_attention_bwd_{which}", "route": "cuda",
            "source": "misinfo_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:"
                        f"{line}",
            "launches": train_flash[which], "max_abs_err": row["err"],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}})
    row = qkv_rows["roberta_b32"]
    kernels.append({
        "name": "int8_dense_qkv", "route": "cuda",
        "source": "misinfo_tpu_torch/csrc/int8_dense.cu",
        "replaces": "misinfo_tpu/ops/pallas_int8.py:123",
        "launches": qkv_launches, "max_abs_err": row["err"],
        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}})
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    if WhisperTranscriber._POOL is not None:      # the host-prep worker
        WhisperTranscriber._POOL.shutdown()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
