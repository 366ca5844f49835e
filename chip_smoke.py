"""Smoke run of the PyTorch/CUDA port on one CUDA card: builds the kernels, checks them, serves, trains and
validates the flagship, runs the drone-video pipeline (tracking, pose, geo) over synthetic video, tracks a panning
clip with BoT-SORT and its camera-motion compensation, tiles a 4K frame, drives the
command line over image files, an MJPEG AVI and a rect-validated dataset, trains and validates a pose model,
predicts with, trains and validates an instance segmentation model and an oriented box model, does the same
with the YOLO11 and YOLO12 families, and with the classifiers (yolov8s-cls, yolo11s-cls, yolo12s-cls and the
ResNet-50 and ResNet-18 trunks), predicts with and trains the YOLOv3, v5, v6, P6, Ghost and YOLOv9 yamls and YOLOv10,
the NMS-free end-to-end detector, runs the analytics apps over tracks (counting, regions, queues, speed, distance,
heatmap, parking, alarm, zone, workout counting, a mask overlay, the browser app) and the gait study, and exports the
flagship to TorchScript and ONNX, then predicts, validates and serves through those artifacts.

    python3 chip_smoke.py

Phases, one JSON line each (with the seconds it took), flushed as they end:

1. preflight: torch, CUDA, nvcc and the card (name and power limit from nvidia-smi);
2. build: compiles the greedy-NMS kernels (`drone_yolo_tpu_torch/csrc/greedy_nms.cu`), the
   stride-2 conv backward (`csrc/s2_bwd.cu`) and the BN statistics (`csrc/bn_stats.cu`) with
   nvcc, in parallel, and prints the three ptxas reports, the build's seconds, the NMS
   bitmask's workspace bytes at predict's and validation's K, and the tensor-core instructions
   (HMMA, HGMMA) of each stride-2 kernel by `cuobjdump -sass` (or that the toolkit has no
   cuobjdump): the bf16 kernels must have them;
3. kernel_vs_plain: greedy NMS, B=8 at K in {128, 640, 1024, 4096, 8192} and B=1 at K=12288,
   IoU thresholds {0.45, 0.7}: the bitmask kernel's words against `suppression_words_reference`
   (image by image), the keep mask of the two kernels against `greedy_keep_reference`, and (up
   to K = 4096) against `sweep_reference` over the kernel's words: all equal, and every case
   must both keep and suppress. The stride-2 backward
   kernel against `s2_bwd_reference` at every dense stride-2 site of the flagship (batch 8,
   640 px: 8 with k=3, 4 with k=1), in float32 (TF32 off) and bfloat16, within `S2_TOL`. The
   BN-statistics kernel against `bn_stats_reference` at all 77 train-mode BN inputs of the
   flagship (batch 8, 640 px), in bfloat16 and float32, within `BN_RTOL` and `BN_ATOL`, and the
   `bn_stats` Function's gradient against autograd of the plain version at the largest site;
4. slice: `YOLO("yolov8s-p2-repvgg-sf.yaml")` at full width and depth, seed 0, on the card,
   fused, bfloat16, predicts on batches of 1 and 8 synthetic 720x1280 BGR frames, then once
   more with conf=0.0 so that all 1024 candidates per image are valid, then on a mixed batch
   of a 720x1280 and a 1080x1920 frame (the uint8 letterbox). Launch counts are set to 0
   before these calls and read after them. Checks: the NMS step with the kernel equals the
   same step with the plain keep on the card; the uint8 letterbox of both mixed frames on the
   card equals the same function on the CPU exactly; the float32 decoded predictions (TF32
   off, weights redrawn so activations stay O(1)) match the port on the CPU, boxes in pixels
   and scores relative to their size; per-image times and img/s at batch 1 and 8;
5. train: `BaseTrainer` on the flagship at full width and depth, 80 classes, imgsz 640, batch 8,
   bfloat16 autocast, SGD with one optimizer step per batch (nbs 8), seed 0: 6 steps on a
   synthetic batch with s2grad="cuda", the same 6 steps from the same init with stock
   autograd, and again with s2grad="cuda" and bnstats="cuda". Counts are set to 0 before each
   run and read after it: the kernel runs must call the stride-2 backward 8 (k=3) and 4 (k=1)
   times per step, every call through the bf16 tensor-core implementation, the stock run
   never; the third run must call the BN-statistics kernel 77 times per step (1 launch
   each), the other two never. Checks: finite losses, each step's
   loss within `TRAIN_LOSS_RTOL` of the stock run's; step ms, img/s and peak memory of each
   run, then the three paths timed again in turns (kernel, stock, both, both, stock, kernel; 5 steps each);
6. validate: `trainer.validate()` on the third run's EMA weights, over 4 synthetic batches of 8
   at 640 px with 80 classes, at conf 0.001 and again at conf 0.0 (all 4096 multi-label
   candidates of each image valid: the NMS kernel's real work), counts set to 0 before each.
   Checks: K = 4096 in both, one NMS call (two launches) per batch, the NMS step with the kernel equal to
   the step with the plain keep on the same predictions, P, R, mAP50 and mAP50-95 finite and in
   [0, 1]; the validator's per-image times and img/s;
7. kernels: each kernel's time at the main path's shapes against its plain version, its
   bound and the library call where there is one (cuDNN's `convolution_backward` at the
   stride-2 sites, `torch.batch_norm_stats` at the BN sites); greedy NMS with its two
   launches' device times apart; the stride-2 backward also at each of the 12 sites against
   cuDNN there, with TFLOP/s, GB/s and the share of the bound; the BN statistics at each of
   the 77 sites (timed once per distinct shape) against `torch.batch_norm_stats`, with the
   share of the bound;
8. profile: the device busy share and the device time by kernel of batch-8 predicts, of
   train steps with the stride-2 kernel, and of train steps with both kernels (torch.profiler);
9. loop: the epoch loop over a dataset on disk. 16 train and 16 val images of the dense
   small-object proxy (`tools/dense_dataset.py:make_dense_image`, 320 px, 90-140 objects of
   4-12 px, 6 classes, seed 1) written as JPEG by the port's encoder at quality 95, with labels
   and data.yaml, in a temporary directory. Run A: `YOLO("yolov8s-p2-repvgg-sf.yaml").train(...)`
   at full width and depth, imgsz 320, batch 8, nbs 8, SGD, default augmentation, close_mosaic 1,
   cache="ram", 4 loader threads, s2grad="cuda", bnstats="cuda", bf16 autocast, 2 epochs, EMA
   validation each epoch. Run B: a trainer that resumes A's resume_state.npz with epochs 3.
   Counts are set to 0 before each run and read after it. Checks: finite losses; 12 stride-2
   calls (8 k=3, 4 k=1) and 77 BN-statistics calls a step, one NMS call (two launches) a val
   batch; P, R, mAP50, mAP50-95 in [0, 1]; results.csv, last.npz, best.npz and
   resume_state.npz written, and `YOLO(last.npz)` predicting on the card; B starting at epoch 2
   with params, SGD momentum and EMA bitwise equal to A's final state, and running one epoch;
   the JPEG round trip of the dataset within `JPEG_MEAN_ERR`. Printed: seconds per epoch, train
   img/s, the share of the epoch spent waiting on the loader, decode ms per 320 and 640 px
   image, augmentation ms per sample, validation seconds, peak card memory, checkpoint bytes, and
   the cost of the train-batch plots (`plot_cost`; the later training phases run with plots=False);
10. track: the drone-video analytics path. `DroneVideoPipeline` with the flagship (tracking) and
   `yolov8s-pose.yaml` (nc 1, 17 keypoints) at full width and depth, fused, bfloat16, and a
   `GeoConverter`, over 64 synthetic 1080x1920 frames of 60 textured rectangles that move, enter and
   leave (`moving_frames`, seed 3), imgsz 640, conf 0.25, ByteTrack (bytetrack.yaml, named). Random weights score near
   sigmoid(-13), below ByteTrack's thresholds, so each model's class logits are spread to follow
   the image (`scored_weights`, gain 30) and shifted so that 5% of frame 0's anchors score above
   0.25 (`calibrated_weights`). Pass A holds the keep mask of every NMS call of both models (the
   pose model's carries 51 keypoint columns) against `greedy_keep_reference` on the same
   candidates; pass B, the timed run with NMS counts set to 0 before it and read after it,
   prints frames/s of detect + track + pose + geo, per-stage ms a frame (the predictor's
   preprocess, inference and postprocess, the tracker's update, the pose model's predict, the geo
   conversion, the rest), the track count and the CSV's rows; pass C gives frames/s of detect +
   track + geo without the pose model; then the device's busy share over 8 steps of the full
   pipeline (torch.profiler), and `BYTETracker.update` alone on detection streams of 50, 200 and
   500 targets (`detection_stream`, 60 frames each);
11. botsort: BoT-SORT with sparse optical-flow camera-motion compensation (GMC) on the card, and tiled inference.
   A panning clip (`panning_frames`, seed 23): 64 1920x1080 frames, each a window of a larger textured canvas with the
   track cell's moving rectangles, warped on the card by `ops/image.py:warp_affine_u8` by a similarity that moves
   3-20 px and turns up to 0.1 degree a frame; the track cell's flagship, pose model, calibrated weights (on the
   clip's first frame), conf and geo. Pass A runs `DroneVideoPipeline(tracker="botsort.yaml")` with pose: every
   keep mask against `greedy_keep_reference`, NMS calls = frames + pose calls with two launches each (counts set to
   0 before it, read after it); the GMC of the CPU over the clip's first 16 frames (a thread beside the weights'
   calibration and pass A) against the card's:
   corners (`GMC_CORNER_SHARE`), the tracker's status from equal corner lists (`GMC_STATUS_SHARE`), warps
   (`GMC_LIN_TOL`, `GMC_T_TOL` px); every card warp against the clip's known motion (`KNOWN_T_TOL` px on the
   translation, `KNOWN_ROT_TOL` rad); the card's GMC steps must get card tensors. Pass B: frames/s of detect +
   BoT-SORT + geo and of detect + BoT-SORT + pose + geo; GMC ms a frame by step (grey and resize, corners, flow,
   RANSAC; each synchronised; over 16 frames), `BOTSORT.update` ms a frame; the device's idle share over 3 steps of the full
   pipeline (torch.profiler); ByteTrack over the same clip, ids and track lengths beside BoT-SORT's (a finding, not
   a check). Pass C: `ops/tiling.py:tiled_inference` of one 2160x3840 frame (`moving_frames`, seed 29, 240
   rectangles; RGB) through the flagship's predictor (fused, bf16), 640 px crops with gap 128: 32 windows in two
   batches of 16; every keep mask (the crops' B = 16 calls and the merge's B = 1) against the plain keep, 3 NMS calls
   and 6 launches; ms a frame split into crop and upload, forward and NMS, and merge (the median of 5 after one);
12. entry: the normal entry points. Inputs written by the port's encoders in a temp dir: a directory of 6
   frames (`moving_frames`, seed 5: JPEG at 1920x1080, 1080x1920 and 1280x720, PNG at 1280x720), one MJPEG
   AVI of 6 1080p frames at 30000/1001 frames/s (`data/avi.py:AviWriter`, quality 95), and
   16 dense-proxy images cropped to 8 aspect ratios (`write_mixed_val`). The flagship's weights are
   `calibrated_weights` saved by `YOLO.save` with train_args imgsz 640. Through `cfg.entrypoint` strings, with no
   imgsz: (a) predict over the directory with save_txt and save_crop (max_det 4), (b) track over clip.avi (the
   default tracker, BoT-SORT), then `DroneVideoPipeline.run("clip.avi")`, (c) val over the mixed set (rect, the
   facade's default) and with rect=False. Every NMS keep mask of (a)-(c) is held against `greedy_keep_reference`, counts set to 0 before
   them and read after them. Checks: one label file per image, crops written, track ids, the CSV of
   run("clip.avi") byte-equal to that of `step` over the frames decoded from the payloads, each rect batch at
   its planned shape and at most `rect_max_shapes` shapes, square batches at 640. Printed: decode ms per 1080p
   JPEG, 720p and 1080p PNG and AVI frame, run frames/s from the AVI against step frames/s from memory, val img/s
   rect against square, predict img/s from the directory at batch 1 and 8, the host seconds of (a) by part
   (loading and decoding, the predictor's stages, save_txt, save_crop) and each stage's seconds, each beside the
   nvidia-smi line;
13. draw: `save=True`. The flagship at 640 px, bf16, `calibrated_weights` (0.4% of the clip's first frame's
   anchors above conf 0.25), predicts with save=True over the entry phase's directory and its AVI, then without save
   over the AVI; yolov8s-seg, -pose (on the AVI's first 2 frames; 1% above conf) and -obb (2 frames of rotated
   rectangles at 1024 px) predict one batch of 2 each with save=True and without. Every greedy-NMS keep mask is
   held against `greedy_keep_reference`, counts set to 0 before the phase and read after it. Checks: one image per source image
   under its name, each read back by the port's decoders at its source's shape, the PNG byte-equal to the port's
   encoding of `Results.plot()`, clip.avi read back by `AviReader` with the source's frame count and rate, each
   task's masks, keypoints or oriented boxes drawn. Printed per model: plot ms and encode ms per frame (host seconds
   inside `Results.plot` and the encoders), predict frames/s with save=True against save=False, each beside the
   nvidia-smi line;
14. pose: pose training and validation. `yolov8s-pose.yaml` (nc 1, 17 keypoints) at full width and depth: the
   stride-2 backward kernel against `s2_bwd_reference` at its 7 dense k=3 sites and the BN-statistics kernel against
   `bn_stats_reference` at all its 63 train-mode BN inputs (the keypoint branch's 6 of 51 channels among them), in
   bfloat16 and float32 at batch 8, 640 px; then a seeded dataset of 16 train and 8 val images of 17-keypoint
   figures (`write_pose_dataset`, the port's JPEG encoder, COCO's `flip_idx`), `YOLO("yolov8s-pose.yaml").train(...)`
   2 epochs at batch 8, 640 px, bf16 autocast, SGD, default augmentation, cache="ram", both kernels, with the EMA
   validated each epoch, and `YOLO(last.npz).val(...)` in rect batches. Every NMS keep mask of those validations is
   held against `greedy_keep_reference`. Counts are set to 0 before each run and read after it. Checks: 7 stride-2
   calls (k=3) and 63 BN-statistics calls a step, one NMS call (two launches) a val batch at K = 4096, the loss
   items finite, `pose_loss` and `kobj_loss` in results.csv, the metrics in [0, 1]; then 15 steps (30 before the
   export phase) on one fixed
   batch (the val split's first 8 images, letterboxed) at a constant lr, whose `pose_loss` must end below its first
   value. Printed: step ms and img/s of the fixed batch, its device idle share (torch.profiler), epoch seconds and
   the data-wait share, validation img/s, peak card memory, each beside the nvidia-smi line;
15. segment: instance segmentation. `yolov8s-seg.yaml` (nc 80, 32 prototypes) at full width and depth: the stride-2
   backward kernel against `s2_bwd_reference` at its 7 dense k=3 sites and the BN-statistics kernel against
   `bn_stats_reference` at the 9 BN inputs the detect part lacks (Proto's 3 at 80x80 and 160x160, cv4's 6), in
   bfloat16 and float32 at batch 8, 640 px, and timed there against the plain version and `torch.batch_norm_stats`;
   a seeded dataset of 8 train and 8 val images of 2-12 filled polygons (`write_seg_dataset`, the port's `fill_poly`
   and JPEG encoder, nc 80); predict on 1080x1920 frames (`moving_frames`) at batch 1 and 8 with `calibrated_weights`
   (0.2% of frame 0's anchors above conf 0.25): every image's masks at the frame's shape; then
   `YOLO("yolov8s-seg.yaml").train(...)` 1 epoch at batch 8, 640 px, bf16 autocast, SGD, default augmentation,
   cache="ram", both kernels, with the EMA validated, and `YOLO(last.npz).val(...)` in rect batches. Every NMS keep
   mask (predict K = 1024 and validation K = 4096, 32 coefficient columns riding) is held against
   `greedy_keep_reference`. Counts are set to 0 before each run and read after it. Checks: 7 stride-2 calls (k=3)
   and 66 BN-statistics calls a step (57 of the detect part, cv4's 6, Proto's 3), one NMS call (two launches) a
   val batch, the loss items finite, box and mask metrics in [0, 1]; then 15 steps (30 before the export phase) on
   one fixed batch (the val
   split's 8 images, letterboxed) at a constant lr, whose `seg_loss` must end below its first value. Printed:
   predict img/s and masks per image, step ms and img/s of the fixed batch, its device idle share, epoch seconds and
   the data-wait share, validation img/s, box and mask mAP, peak card memory, each beside the nvidia-smi line;
16. obb: oriented boxes. `yolov8s-obb.yaml` (nc 15, DOTA-v1's class count) at full width and depth and DOTA's
   training size, 1024 px: the stride-2 backward kernel against `s2_bwd_reference` at its 7 dense k=3 sites (layer
   0's dw a sum of 2,097,152 products) and the BN-statistics kernel against `bn_stats_reference` at all its 63
   train-mode BN inputs (the angle branch cv4's 6 among them), in bfloat16 and float32 at batch 8, and one step's
   calls of each timed against the plain versions, cuDNN's `convolution_backward` and `torch.batch_norm_stats`; a
   seeded dataset of 8 train and 8 val images of 8-40 rotated rectangles of 12-160 px, aspect 1-4
   (`write_obb_dataset`: the port's `fill_poly` and JPEG encoder, YOLO-OBB corner labels); predict on 1024x1024
   frames of rotated rectangles at batch 1 and 8 with `calibrated_weights` (2% of frame 0's anchors above conf
   0.25): every image's oriented boxes finite, above conf, with their corners; then
   `YOLO("yolov8s-obb.yaml").train(...)` 1 epoch at batch 8, bf16 autocast, SGD, default augmentation, cache="ram",
   both kernels, with the EMA validated, and `YOLO(last.npz).val(...)` in rect batches. Rotated NMS is the JAX
   package's fast NMS by probiou in plain tensor operations, so the greedy-NMS kernel must not be called. Counts are
   set to 0 before each run and read after it. Checks: 7 stride-2 calls (k=3) and 63 BN-statistics calls a step, no
   NMS kernel call, the loss items finite, the metrics in [0, 1]; then 15 steps (30 before the export phase) on one
   fixed batch (the val split's
   8 images, letterboxed) at a constant lr, whose `box_loss` must end below its first value. Printed: predict img/s
   and oriented boxes per image, step ms and img/s of the fixed batch, its device idle share, epoch seconds and the
   data-wait share, validation img/s, peak card memory, the kernels' errors against the tolerance and their times,
   each beside the nvidia-smi line;
17. families: the YOLO11 and YOLO12 families (C3k2, C2PSA attention, A2C2f area attention, the depthwise class
   branch). `yolo11s.yaml` and `yolo12s.yaml` (nc 80) at full width: both train kernels against their plain versions
   at the 7 dense k=3 stride-2 sites (yolo11s layers 0, 1, 3, 5, 7, 17, 20; yolo12s 0, 1, 3, 5, 7, 15, 18) and at
   every train-mode BN input (81 and 113), bf16 and float32, batch 8, 640 px, then one bf16 step's calls timed
   against the plain versions, cuDNN's `convolution_backward` (each of yolo11s's sites alone too) and
   `torch.batch_norm_stats`; predict with `calibrated_weights` on 720x1280 frames (`moving_frames`) at batch 1 and 8;
   the float32 forward on the card against the CPU (TF32 off, `spread_weights`); 5 steps (10 before the export phase)
   on one synthetic batch with both kernels and 5 stock from the same init (batch 8, 640 px, bf16 autocast, SGD at a
   constant lr): the loss
   falling in both, the first 3 within `TRAIN_LOSS_RTOL`, step ms, img/s and the device idle share of a profiled
   step; one epoch from disk over 8 + 8 dense-proxy JPEGs at 640 px (`write_dense_dataset`) with both kernels and
   rect val of `last.npz`. Then `yolo11s-pose`, `yolo11s-seg`, `yolo11s-obb` (1024 px) and `yolo12s-seg`: predict at
   batch 8 and 5 fixed-batch steps with both kernels, each loss finite and falling. Every greedy-NMS keep mask is
   held against `greedy_keep_reference`. Counts are set to 0 before each run and read after it: 7 stride-2 calls and
   one BN call per BN input a step, one NMS call a predict or val batch (none for obb);
18. classify: image classification. `yolov8s-cls.yaml` (nc 1000, ImageNet-1k) at its published width, 224 px: both
   train kernels against their plain versions at its 5 dense k=3 stride-2 sites (layers 0, 1, 3, 5, 7; 3 -> 32 ...
   256 -> 512) and its 26 train-mode BN inputs, bf16 and float32 at batch 64, each kind's calls of a step and each site
   alone timed against the plain version and cuDNN's `convolution_backward` (the BN inputs against
   `torch.batch_norm_stats`); predict with `classifier_weights` on 64 synthetic 720x1280 frames at batch 1 and 32
   (img/s, per-stage ms); the float32 probabilities on the card against the CPU's on 4 frames (TF32 off: the inputs
   equal, top-1 equal, probabilities within `CLS_PROB_RTOL`/`CLS_PROB_ATOL`); 10 steps on one synthetic batch of 64
   with both kernels and 10 stock (bf16 autocast, SGD at a constant lr): the loss falling in both, the first 3
   within `TRAIN_LOSS_RTOL`, step ms, img/s and the device idle share of a profiled step; one epoch from disk over
   a 10-class image folder in imagenet10's layout (`write_cls_folder`: 8 train and 4 val JPEGs a class of mixed
   aspect) at batch 16 with both kernels, then val of `last.npz`: top-1 and top-5 in [0, 1], peak card memory, the
   data-wait share. Then yolo11s-cls, yolo12s-cls, yolov8-cls-resnet50 and yolo11-cls-resnet18: both kernels at
   their sites (5 k=3 for the families; 3 k=3 and 3 k=1 for each ResNet trunk, the 1x1 stride-2 shortcuts up to
   1024 -> 2048 at 14 px) and BN inputs (ResNet-50's last 2048 channels at 7 px), each site alone against cuDNN;
   predict at batch 32; 3 fixed-batch steps with both kernels against 3 stock within `TRAIN_LOSS_RTOL`. Counts are
   set to 0 before each run and read after it: the stride-2 and BN calls of every step exactly, no greedy-NMS call;
19. zoo: the YOLOv3, v5, v6, P6, Ghost and YOLOv9 (GELAN) yamls (`ZOO_CELL`; nc 80, batch 8, random weights from a
   seed). `yolov9c.yaml` at 640 px: both train kernels against their plain versions at its 2 dense k=3 stride-2 sites
   (layers 0 and 1; ADown's stride-2 convs see the odd map of their 2x2 mean and are not sites) and its 154 BN inputs
   (RepConv's two branches among them), bf16 and float32, each kind's calls timed against cuDNN and
   `torch.batch_norm_stats`; predict with `calibrated_weights` on 720x1280 frames at batch 1 and 8; the float32
   forward on the card against the CPU's and fused against unfused (`BOX_ATOL_PX`, `SCORE_RTOL`); 5 fixed-batch
   bf16 steps (10 before the export phase; SGD at a constant lr of 0.01) with both kernels and 5 stock (ms, img/s, the
   idle share of a profiled
   step); one epoch over 8 + 8 dense-proxy JPEGs with both kernels, then rect val of `last.npz`. `yolov8s-p6.yaml`
   at 1280 px (predict on 1080x1920 frames at batch 1 and 8; 9 sites, the P6 level's downsample among them) and
   `yolov8s-ghost-p2.yaml` (predict at batch 8; GhostConv's cv1 sites): the same kernel and float32 checks, 5 bf16
   steps with both kernels. The 16 others (yolov3-tiny, yolov3, yolov3-spp, yolov5s, yolov5s-p6, yolov6s,
   yolov8s-ghost, yolov8s-ghost-p6, yolov8s-pose-p6, yolov8s-seg-p6, yolov9t, s, m, e, yolov9c-seg, yolov9e-seg;
   1280 px for the P6 yamls): both train kernels against their plain versions at their sites and BN inputs as
   above (`kernel_site_checks`; a shape checked at an earlier model's site is not checked again), predict at batch 8
   on the random init at conf 0 (32 detections an image) and 1 bf16 step with both kernels (2 before the export
   phase), their stride-2 calls
   timed against the plain version and cuDNN. Every detection model also takes one float32 backward (TF32 off, batch
   2) with both kernels and one stock against a float64 one (`float64_grad_errors`): the first losses within
   `TRAIN_LOSS_RTOL`, the kernels' largest gradient error within 2x stock's (two bf16 runs part at the first step,
   and two float32 runs a step or two later, as TAL's assignments and max pools follow the last digits: the step
   losses are readings). Counts are set to 0 before each run and read after it: the
   stride-2 (k=3, k=1) and BN calls of every step exactly as the model's sites and BN inputs, one NMS call a predict
   or val batch, every keep mask equal to `greedy_keep_reference`; the bf16 loss of the 5- and 10-step runs falling
   below its first value;
20. v10: YOLOv10, the NMS-free end-to-end detector (`V10_CELL`; nc 80, 640 px, batch 8, published widths and depths,
   random weights from a seed). `yolov10s.yaml`: both train kernels against their plain versions at its 4 dense k=3
   stride-2 sites (layers 0, 1, 3, 17; SCDown's stride-2 convs are depthwise and stay with cuDNN) and its 99 BN
   inputs, bf16 and float32, each kind's calls timed against cuDNN's `convolution_backward` and
   `torch.batch_norm_stats` and each site alone against cuDNN; predict with `calibrated_weights` (the one-to-one
   head's class logits) on 720x1280 frames at batch 1 and 8, fused and bf16; the float32 one-to-one decoded maps on
   the card against the CPU's (TF32 off, `spread_weights`, fused: `BOX_ATOL_PX`, `SCORE_RTOL`) and the top-300
   detections row by row where the scores are untied (`v10_fp32_checks`); 10 fixed-batch bf16 steps with both kernels
   and 10 stock (SGD at a constant lr): the E2E loss finite and falling in both, step ms, img/s, the idle share of
   profiled steps; one epoch from disk over 8 + 8 dense-proxy JPEGs with both kernels, then rect val of `last.npz`
   (P, R, mAP50, mAP50-95 in [0, 1]). Then `yolov10n`, `m`, `b`, `l` and `x`: both kernels at their site and BN shapes
   not checked at an earlier v10 model, predict at batch 8 and 2 fixed-batch steps with both kernels (3 before the
   export phase), losses finite.
   Counts are set to 0 before each run and read after it: 4 k=3 stride-2 calls and one BN-statistics call per BN
   input a step, and no greedy-NMS call anywhere (the head's top-k takes its place: `ops/nms.py:end2end_detections`);
21. solutions: the analytics layer over tracks (`drone_yolo_tpu_torch/solutions/`, `SOLUTIONS_CELL`). The flagship
   at full width (fused, bf16, 640 px, batch 1, `calibrated_weights`: 1.5% of frame 0's anchors above conf 0.25)
   over the track cell's 1080x1920 `moving_frames` cut to their first 2 (the cut is printed), ByteTrack (named in the
   facade's overrides, as in the track cell) anew for each app: `ObjectCounter` with a line across the middle and with a central polygon,
   `RegionCounter` with the two halves, `QueueManager`, `SpeedEstimator` and `DistanceCalculation` (metres per pixel
   from the track cell's `GeoConverter` GSD at 80 m), `Heatmap` (PARULA), `ParkingManagement` with a 4x8 grid of
   slots, `SecurityAlarm` (more than 50 tracks), `TrackZone` and `Analytics`; `AIGym` on `yolov8s-pose.yaml` and
   `InstanceSegmentation` on `yolov8s-seg.yaml` (calibrated as in the draw phase) over the same frames; `Inference`
   under a fake UI (`fake_streamlit`: video upload, tracking on, the flagship saved as an npz) over an MJPEG AVI of 2
   720x1280 crops that the phase writes, read by the port's `FrameCapture`; then `GaitStudy` over 28 synthetic
   walkers (`make_walker`, a copy of the gait test's) on the host. Every NMS keep mask is held against
   `greedy_keep_reference` (inside the track ms: ~1.4 ms a frame), counts set to 0 before each app and read after
   it. Checks: one NMS call (two launches) a frame for every app; every returned frame at its source's shape; a
   line or polygon counter's IN + OUT at most the tracks it saw; each frame's region counts summing to at most its
   boxes; the heatmap finite and not all zero; the speeds finite; the analytics series one entry a frame, summing
   to the last frame's tracks; the app showing every frame of the AVI in both panes; the gait report with every
   `FEATURE_NAMES` key for every walker. Printed: each app's frames/s and its ms a frame split into track (the
   facade's track or predict), drawing (the Annotator, `Results.plot`, the colormap and blend) and the app's own
   logic (the rest), its counts; the host's drawing costs alone (`drawing_cost`: a box label, a 30-point history,
   the heatmap's colormap and blend of a 1080p frame); the gait study's seconds, cross-validated accuracy and the
   forest's fit seconds;
22. export: export and AutoBackend (`EXPORT_CELL`). The flagship at full width (nc 80), 640 px, batch 8,
   `calibrated_weights` on the first of 8 720x1280 frames (0.2% of its anchors above conf 0.25): `YOLO.export` to
   torchscript in bfloat16 (`half=True`) and in float32 and to onnx (each with its npz and `.json` sidecar); each
   reloaded by `AutoBackend` on the card (the ONNX file by the port's graph runner, `nn/onnx_graph.py`); the float32
   artifacts' raw predictions against the eager fused float32 forward (TF32 off: boxes within `BOX_ATOL_PX`, scores
   within `EXPORT_SCORE_ATOL`); `YOLO(path).predict` at batch 8 for each, counts set to 0 before and read after: one
   greedy-NMS call (two launches) each; a local KServe-v2 REST server (`kserve_server`, stdlib `http.server`) serving
   the float32 torchscript module on the card, and `YOLO("http://127.0.0.1:<port>/flagship").predict` equal to the
   direct call's detections with one NMS call; `YOLO(float32 torchscript).val` (square batches at the artifact's batch
   and size) on 8 dense-proxy JPEGs against the eager model's val in float32 with rect=False: the metrics within
   `EXPORT_MAP_ATOL` and every detection's class equal and score within `EXPORT_SCORE_ATOL` (the random weights
   score no true positive).
   Every keep mask of the phase is held against `greedy_keep_reference`. Printed: ms per image at batch 8 of the
   eager bf16 forward, the bf16 and float32 torchscript, the ONNX runner in float32 and the served round trip, each
   beside the nvidia-smi line, export seconds and artifact bytes;
23. imports: neither JAX, nor the JAX package, nor cv2, PIL, yaml, sklearn, matplotlib, streamlit, google.protobuf,
   onnx or grpc was imported, with the modules of every path (apps, solutions, trackers, the pose, segment, obb and
   classify predictors, trainers and validators, the loaders, `ops/rotated.py`, the ONNX writer and runner, the
   KServe-v2 client) loaded.

Then the nvidia-smi line, the `kernels` JSON line, and last `{"ok": true, "device": ...}`.

`python3 chip_smoke.py accuracy [seed ...]` instead trains the flagship with the port's
`YOLO.train` at the JAX package's ablation settings (`tools/flagship_parity.py:216-286` with the
`HYPS` of `:43-70`, amp): 192 train and 96 val images of the dense proxy, 40 epochs, from the
init of each seed (0 and 1 by default; the ablation's is 0); then `YOLO.val` at conf 0.001, IoU
0.7 in float32; prints one JSON line per seed with mAP50-95, mAP50, the wall time and results.csv.

Greedy NMS is two launches a call (a suppression bitmask over many CTAs, then a sweep, one
CTA per image), the BN statistics one: the checks of the main path count NMS calls, and
the `kernels` line gives launches.
Any failure ends the script with a traceback and a non-zero exit code. Without a CUDA
card it exits with code 1 before any phase.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

FLAGSHIP = "yolov8s-p2-repvgg-sf.yaml"
FRAME_HW = (720, 1280)
# H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores, bf16 dense tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
TRAIN = dict(batch=8, imgsz=640, nc=80, steps=6)
# stride-2 backward, kernel vs plain on the same inputs. float32: tests/test_conv_s2.py:115-116 (both sum in
# float32, in different orders). bfloat16: tests/test_conv_s2.py:51-67 (both sum the same bf16 inputs in float32;
# dx is rounded to bf16 once, so the two may differ by one bf16 step).
# Those were set for reductions of ~100 terms; dw at the flagship's sites sums up to 819,200 products (layer 0,
# batch 8), whose float32 sums in two orders differ by ~1e-6 of the largest entry (1.8e-3 at a largest |dw| near
# 2,700 in the first chip run): atol grows by S2_SUM_FLOOR x the largest |plain| entry. The float32 cases also
# report both versions' distance from a float64 evaluation.
S2_TOL = {"float32": {"dx": dict(rtol=1e-5, atol=1e-4), "dw": dict(rtol=1e-4, atol=1e-3)},
          "bfloat16": {"dx": dict(rtol=0.05, atol=0.05), "dw": dict(rtol=0.05, atol=0.15)}}
S2_SUM_FLOOR = 2e-6
# the 6 bf16 steps with the kernel against the 6 with stock autograd: the first step's forward is the same; the
# backward differs by bf16 rounding (cuDNN's bf16 dw against the kernel's float32 sums), which moves later losses
# by far less than this
TRAIN_LOSS_RTOL = 2e-2
IOU_OPS = 14  # per IoU and compare: 4 min/max, 2 sub, 2 clamp, mul, add, sub, add, div, compare
# (B, K): predict's K = 1024, validate's K = 4096 (pre_nms_topk), two K above it
NMS_CASES = tuple((8, k) for k in (128, 640, 1024, 4096, 8192)) + ((1, 12288),)
NMS_SWEEP_PLAIN_MAX_K = 4096  # sweep_reference loops over the rows in Python: K launches of a few small ops
# BN statistics, kernel vs plain on the same inputs, per channel: both sum the same values in float32 in different
# orders (sums of up to 819,200 terms at the flagship's largest site), so the difference is held to BN_RTOL of the
# sum of |x| (for the sums) or of x^2 (for the sums of squares), plus BN_ATOL; the result is no scale for a sum
# that cancels.
BN_RTOL, BN_ATOL = 1e-5, 1e-6
BN_OPS = 3  # per element: add to the sum, multiply and add to the sum of squares
VAL = dict(batches=4, batch=8, imgsz=640, nc=80, pre_nms_topk=4096)
# float32 decoded predictions, card (TF32 off) vs CPU, with weights spread to O(1) activations:
# the two sum in different orders, ~1e-5 relative at the head; a box coordinate is stride
# (<= 32) x a DFL expectation over 16 bins. The class priors keep scores near sigmoid(-13), where
# a score's relative error is its logit's absolute error, so scores are held to a relative one.
BOX_ATOL_PX = 1e-2
SCORE_RTOL = 1e-4
# the loop phase: the dense small-object proxy of the JAX package's ablation (tools/flagship_parity.py:216)
# 3 epochs before the v10 phase; 32 train images before the export phase
LOOP = dict(n_train=16, n_val=16, imgsz=320, batch=8, epochs=2, nc=6, seed=1, obj_px=(4, 12), workers=4)
# mean absolute error of the dataset's JPEG round trip (quality 95, 4:2:0) per channel value: chroma subsampling
# of 4-12 px saturated objects on a noisy background costs ~6.5 (the same for cv2's encoder at quality 95)
JPEG_MEAN_ERR = 10.0
# the JAX package's ablation hyperparameters (tools/flagship_parity.py:43-70) for the port's keys; classify-only
# keys (erasing, auto_augment) are left out
ABLATION = dict(epochs=40, batch=8, imgsz=320, seed=0, optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937,
                weight_decay=0.0005, warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1, nbs=8, box=7.5,
                cls=0.5, dfl=1.5, mosaic=0.0, mixup=0.0, copy_paste=0.0, scale=0.0, translate=0.0, degrees=0.0,
                shear=0.0, perspective=0.0, fliplr=0.5, flipud=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                multi_scale=False, rect=False, cos_lr=False, close_mosaic=0, patience=10_000, amp=True)

# the track phase: the drone-video pipeline (detect + ByteTrack + pose + geo) over synthetic 1080p video. Random weights
# score near sigmoid(-13), under ByteTrack's thresholds, so each model's class logits are spread to follow the image
# (`scored_weights`, gain CLS_GAIN) and shifted so that SHARE_ABOVE_CONF of frame 0's anchors score above conf.
TRACK_CELL = dict(frames=64, hw=(1080, 1920), objects=60, obj_px=(24, 120), seed=3, imgsz=640, conf=0.25,
                  pose_model="yolov8s-pose.yaml", cls_gain=30.0, share_above_conf=0.05,
                  geo=dict(lat=31.2304, lon=121.4737, altitude_m=80.0, yaw_deg=15.0, pitch_deg=90.0))
TRACKER_TARGETS = (50, 200, 500)  # BYTETracker.update alone on detection streams of this many targets
# the botsort phase: the track cell's models, weights, conf and geo over a panning clip (`panning_frames`: 64 1080p
# frames, 3-20 px and up to 0.1 degree a frame), then tiled inference of one 4K frame (32 windows of 640 px, gap 128)
BOTSORT_CELL = dict(seed=23, shift=(3.0, 20.0), max_rot_deg=0.1, cpu_frames=16, timed_frames=16,
                    tiled=dict(hw=(2160, 3840), crop=640, gap=128, batch=16, objects=240, seed=29))
# the card's GMC against the CPU's on the clip's first `cpu_frames` frames (the CPU's takes ~0.4 s a 1080p frame, in a
# thread beside pass A): the corner lists and the tracker's status (the two compute the same integer and float32
# operations in the same order), the warps
GMC_CORNER_SHARE, GMC_STATUS_SHARE, GMC_LIN_TOL, GMC_T_TOL = 0.995, 0.99, 1e-3, 0.02
# the card's warps against the clip's known motion. A warp's translation is its displacement at pixel (0, 0), about
# 1100 px from the frame's centre, where a rotation error of 1e-4 rad alone moves it 0.11 px; and the moving rectangles'
# corners that RANSAC's 3 px (6 px at full scale) keep as inliers pull the least-squares fit. The JAX package's GMC
# (cv2, on the CPU) misses this clip's translation by up to 0.274 px (27 of 64 frames above 0.1 px; its centre by up
# to 0.120 px) and its rotation by up to 1.38e-4 rad, so translations are held to 0.5 px, rotations to 2e-4 rad
KNOWN_T_TOL, KNOWN_ROT_TOL = 0.5, 2e-4
# the entry phase: one MJPEG AVI of 6 1080p frames (16 before the pose phase, 8 before the v10 phase) at 30000/1001
# frames/s; a directory of 6 frames (12 before the families phase): the AVI's first 2 (JPEG 1920x1080), then JPEG
# 1080x1920 and 1280x720 and PNG 1280x720; a mixed-aspect val set of 16 dense-proxy images (32 before) at 640 px. The
# predict over the directory keeps 4 detections an image (10 before; max_det), whose crops it writes: the port's numpy
# JPEG encoder writes each crop on the host, and the crops of 1080p frames are large
ENTRY_CELL = dict(dir_from_avi=2, frames=(("jpg", (1920, 1080), 2), ("jpg", (720, 1280), 1), ("png", (720, 1280), 1)),
                  avi_frames=6, avi_hw=(1080, 1920), avi_rate=(30000, 1001), objects=40, obj_px=(24, 120), seed=5,
                  imgsz=640, conf=0.25, cls_gain=30.0, share_above_conf=0.05, crop_max_det=4, val_images=16,
                  val_batch=8, val_nc=6)
# the pose phase: yolov8s-pose (nc 1, 17 keypoints) trained and validated at full width on a seeded dataset of figures
# (`write_pose_dataset`), batch 8, 640 px, bf16 autocast, SGD, both kernels, default augmentation; then 15 steps on one
# fixed batch at a constant lr (warmup_epochs 0), whose pose loss must fall
POSE_CELL = dict(model="yolov8s-pose.yaml", n_train=16, n_val=8, imgsz=640, batch=8, epochs=2, seed=7, workers=4,
                 fixed_steps=15)
# the segment phase: yolov8s-seg (nc 80, 32 prototypes) at full width on a seeded dataset of polygons
# (`write_seg_dataset`): predict on 1080p frames at batch 1 and 8 with calibrated weights, one epoch from disk at
# batch 8, 640 px, bf16 autocast, SGD, both kernels, rect val of last.npz; then 15 steps on one fixed batch at a
# constant lr, whose mask loss must fall
SEG_CELL = dict(model="yolov8s-seg.yaml", nc=80, n_train=8, n_val=8, imgsz=640, batch=8, seed=11, workers=4,
                fixed_steps=15, frames_hw=(1080, 1920), cls_gain=30.0, share_above_conf=0.002, conf=0.25)
# the obb phase: yolov8s-obb (nc 15, DOTA-v1's class count) at full width and DOTA's training size, 1024 px, on a seeded
# dataset of rotated rectangles (`write_obb_dataset`): predict on 1024x1024 frames at batch 1 and 8 with calibrated
# weights, one epoch from disk at batch 8, bf16 autocast, SGD, both kernels, rect val of last.npz; then 15 steps on
# one fixed batch at a constant lr, whose box loss must fall
OBB_CELL = dict(model="yolov8s-obb.yaml", nc=15, n_train=8, n_val=8, imgsz=1024, batch=8, seed=13, workers=4,
                fixed_steps=15, objects=(8, 40), obj_px=(12, 160), frames=8, cls_gain=30.0, share_above_conf=0.02,
                conf=0.25)
# the families phase: yolo11s and yolo12s (nc 80, 640 px) with calibrated weights: predict on 720x1280 frames at batch
# 1 and 8, the float32 forward on the card against the CPU, 5 fixed-batch steps with both kernels and 5 stock (30
# before the classify phase, 10 before the export phase, which took their time), one epoch from disk over dense-proxy
# JPEGs with rect val of last.npz; then yolo11s-pose, -seg, -obb (1024 px) and yolo12s-seg: predict at batch 8 and 5 fixed-batch steps with
# both kernels, each task's loss falling
FAMILY_CELL = dict(models=("yolo11s.yaml", "yolo12s.yaml"), nc=80, imgsz=640, batch=8, frames=8, fixed_steps=5,
                   n_train=8, n_val=8, data_nc=6, obj_px=(6, 24), seed=17, workers=4, cls_gain=30.0,
                   share_above_conf=0.002, conf=0.25,
                   tasks=(("yolo11s-pose.yaml", 640), ("yolo11s-seg.yaml", 640), ("yolo11s-obb.yaml", 1024),
                          ("yolo12s-seg.yaml", 640)), task_steps=5)
FAMILY_S2_LAYERS = {"yolo11s.yaml": ["0", "1", "3", "5", "7", "17", "20"],
                    "yolo12s.yaml": ["0", "1", "3", "5", "7", "15", "18"]}
# the zoo phase: the v3, v5, v6, P6, Ghost and YOLOv9 yamls (nc 80, or 1 for the pose model), batch 8, fixed-batch
# steps by SGD at a constant lr of 0.01, epochs at the default schedule. yolov9c at 640 px: both train kernels against
# their plain versions at its sites and BN inputs, predict on 720x1280 frames at batch 1 and 8, the float32 forward on
# the card against the CPU's and fused against unfused, 5 bf16 steps with both kernels and 5 stock, one epoch over
# 8 + 8 dense-proxy JPEGs and rect val of last.npz. yolov8s-p6 at 1280 px (predict on 1080x1920 frames at batch 1 and
# 8) and yolov8s-ghost-p2 (batch 8): the kernel and float32 checks and 5 bf16 steps. The 16 others: predict at batch 8
# and 1 bf16 step (3 before the v10 phase, 2 before the export phase; yolov9c's 10 + 10 steps 5 + 5 since then), their
# stride-2 calls timed against the plain version and cuDNN. Every
# model: both train kernels against their plain versions at each site and BN input shape not checked at an earlier
# model. Every detection model: one float32 backward with both kernels and one stock, each against a float64 one
ZOO_CELL = dict(nc=80, batch=8, seed=31, conf=0.25, cls_gain=30.0, share_above_conf=0.002, task_share_above_conf=0.02,
                workers=4,
                main=("yolov9c.yaml", 640, FRAME_HW, (1, 8), 5), n_train=8, n_val=8, data_nc=6, obj_px=(6, 24),
                checked=(("yolov8s-p6.yaml", 1280, (1080, 1920), (1, 8), 5), ("yolov8s-ghost-p2.yaml", 640, FRAME_HW,
                                                                               (8,), 5)),
                others=tuple((name, 1280 if "p6" in name else 640) for name in (
                    "yolov3-tiny.yaml", "yolov3.yaml", "yolov3-spp.yaml", "yolov5s.yaml", "yolov5s-p6.yaml",
                    "yolov6s.yaml", "yolov8s-ghost.yaml", "yolov8s-ghost-p6.yaml", "yolov8s-pose-p6.yaml",
                    "yolov8s-seg-p6.yaml", "yolov9t.yaml", "yolov9s.yaml", "yolov9m.yaml", "yolov9e.yaml",
                    "yolov9c-seg.yaml", "yolov9e-seg.yaml")), other_steps=1, frames=8)
# the v10 phase: YOLOv10, the NMS-free end-to-end detector (nc 80, 640 px, published widths and depths, random
# weights from a seed). yolov10s: both train kernels against their plain versions at its 4 dense k=3 stride-2 sites
# (layers 0, 1, 3, 17; SCDown's stride-2 convs are depthwise: cuDNN's) and its 99 BN inputs; predict with calibrated
# weights on 720x1280 frames at batch 1 and 8 (fused, bf16), the float32 one-to-one maps and detections on the card
# against the CPU's, 10 fixed-batch steps with both kernels and 10 stock (SGD at a constant lr), one epoch from disk
# over 8 + 8 dense-proxy JPEGs with val of last.npz. Then yolov10n, m, b, l and x: their new site and BN shapes
# against the plain versions, predict at batch 8 and 2 fixed-batch steps with both kernels (3 before the export
# phase). No NMS call anywhere
V10_CELL = dict(model="yolov10s.yaml", others=("yolov10n.yaml", "yolov10m.yaml", "yolov10b.yaml", "yolov10l.yaml",
                                               "yolov10x.yaml"),
                nc=80, imgsz=640, batch=8, frames=8, fixed_steps=10, other_steps=2, n_train=8, n_val=8, data_nc=6,
                obj_px=(6, 24), seed=37, workers=4, cls_gain=30.0, share_above_conf=0.002, other_share=0.02, conf=0.25)
V10_S2_LAYERS = ["0", "1", "3", "17"]  # every v10 scale's dense k=3 stride-2 convs
# the draw phase: the flagship (640 px, bf16, weights calibrated so that a share of 0.004 of the anchors of the clip's
# first frame pass conf 0.25) predicts with save=True over the entry phase's directory (JPEG 1920x1080 x2, 1080x1920,
# 1280x720, PNG 1280x720) and its 6-frame 1080p MJPEG AVI, and again without save over the AVI; then yolov8s-seg,
# -pose (on the AVI's first 2 frames) and -obb (2 frames of rotated rectangles at 1024 px) one batch of 2 each with
# save=True and without. The pose model's one class spreads its logits little: at a share of 0.004 its best scores
# sit within bf16 rounding of conf and none passes, so it takes 0.01
DRAW_CELL = dict(imgsz=640, conf=0.25, cls_gain=30.0, share_above_conf=0.004, seed=19, task_frames=2,
                 tasks=(("yolov8s-seg.yaml", 640, 0.004), ("yolov8s-pose.yaml", 640, 0.01),
                        ("yolov8s-obb.yaml", 1024, 0.004)))
ENTRY_VAL_ASPECTS = ((1.0, 1.0), (0.5625, 1.0), (1.0, 0.5625), (0.75, 1.0), (1.0, 0.75), (0.6, 1.0), (1.0, 0.8),
                     (0.9, 1.0))
# the classify phase: yolov8s-cls (nc 1000, ImageNet-1k) at its published width and 224 px: predict on 64 synthetic
# 720x1280 frames at batch 1 and 32, the float32 probabilities on the card against the CPU's; 10 fixed-batch steps at
# batch 64 with both kernels and 10 stock; one epoch from disk over a 10-class image folder in imagenet10's layout
# (train/<wnid>/*.JPEG, val/<wnid>/*.JPEG; 8 train and 4 val images a class of mixed aspect) at batch 16, and val of
# last.npz. Then yolo11s-cls, yolo12s-cls, the ResNet-50 and the ResNet-18 trunks: predict at batch 32 and 3
# fixed-batch steps with the kernels against 3 stock. The class logits are spread (the linear's weights x linear_gain
# after `spread_weights`) so that the top class stands clear of float32 rounding.
CLASSIFY_CELL = dict(model="yolov8s-cls.yaml", imgsz=224, batch=64, frames=64, predict_batch=32, fixed_steps=10,
                     n_train=8, n_val=4, epoch_batch=16, workers=4, seed=23, linear_gain=10.0, cpu_frames=4,
                     others=("yolo11s-cls.yaml", "yolo12s-cls.yaml", "yolov8-cls-resnet50.yaml", "yolo11-cls-resnet18.yaml"),
                     other_steps=3)
# (k=3 sites, k=1 sites) of each classifier at 224 px: the five P1-P5 downsampling convs; a ResNet trunk's first block
# of layers 2-4 (its 3x3 and its 1x1 shortcut, both stride 2); the 7x7 stems are not sites (`ops/conv_s2.py:covers`)
CLASSIFY_S2 = {"yolov8s-cls.yaml": (5, 0), "yolo11s-cls.yaml": (5, 0), "yolo12s-cls.yaml": (5, 0),
               "yolov8-cls-resnet50.yaml": (3, 3), "yolo11-cls-resnet18.yaml": (3, 3)}
# the first ten ImageNet-1k classes' WordNet ids, the folder names of the classify phase's dataset
IMAGENET_WNIDS = ("n01440764", "n01443537", "n01484850", "n01491361", "n01494475", "n01496331", "n01498041",
                  "n01514668", "n01514859", "n01518878")
# float32 probabilities, card (TF32 off) vs CPU: the two sum in different orders (~1e-6 relative a layer); a
# probability's relative error is about its logit's absolute error, here logits of a few units
CLS_PROB_RTOL, CLS_PROB_ATOL = 1e-3, 1e-7

# the solutions phase: the analytics apps over tracks (`drone_yolo_tpu_torch/solutions/`) on the track cell's 1080p
# frames, cut from 64 to `frames` to fit the phase's 90 s: every app draws every box on the host (~7 ms a box label on
# the host of an H100 machine, where 6 frames with BoT-SORT took 87.5 s alone and 5 frames 104 s in a whole script;
# 4 frames with ByteTrack 46.7 s, then 2 to make room for the v10 phase).
# The flagship's weights are calibrated so that a share of 0.015 of frame 0's anchors pass conf 0.25 (~60 boxes a
# frame, a VisDrone frame's density; the track cell's 0.05 gives ~300); the pose and segment models as in the draw
# phase. ByteTrack tracks every app, as in the track cell: with BoT-SORT, the facade's default, each app's new tracker
# captures its optical flow's CUDA graphs anew (a frame shape and point-count bucket each), so over a few frames the
# captures, not the apps, set the track time (the botsort phase measures BoT-SORT over 64 frames). The GSD at 80 m
# gives metres per pixel. The browser app runs under a fake UI over an MJPEG AVI of `app_frames` 720x1280 crops of the
# frames; the gait study over 28 synthetic walkers in two groups
SOLUTIONS_CELL = dict(frames=2, tracker="bytetrack.yaml", share_above_conf=0.015, line_width=2, fps=30.0,
                      parking_grid=(4, 8), alarm_records=50,
                      task_models={"AIGym": ("yolov8s-pose.yaml", 0.01),
                                   "InstanceSegmentation": ("yolov8s-seg.yaml", 0.004)}, app_frames=2,
                      app_hw=(720, 1280), walkers=28, gait_seed=2)

# the export phase: the flagship at full width (scale s, nc 80), 640 px, batch 8, weights calibrated on the first of 8
# 720x1280 frames (0.2% of its anchors above conf 0.25): exported to torchscript in bfloat16 (half) and in float32 and
# to onnx, each reloaded by AutoBackend on the card; predict through YOLO(path) at batch 8; the float32 torchscript and
# the eager model (float32, rect=False) validate 8 dense-proxy JPEGs; a local KServe-v2 REST server (stdlib
# http.server) serves the float32 torchscript module to YOLO("http://127.0.0.1:<port>/flagship")
EXPORT_CELL = dict(imgsz=640, batch=8, frames=8, seed=43, cls_gain=30.0, share_above_conf=0.002, conf=0.25, n_val=8,
                   data_nc=6, obj_px=(6, 24), reps=5, endpoint="flagship")
EXPORT_SCORE_ATOL = 1e-4  # float32 artifacts against the eager float32 forward: the class scores, absolute (boxes: BOX_ATOL_PX)
EXPORT_MAP_ATOL = 1e-4  # the float32 torchscript's val metrics against the eager float32 model's

T0 = time.perf_counter()


def emit(phase: str, t_start: float, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "s": round(time.perf_counter() - t_start, 3)}), flush=True)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def clustered_boxes(rng: np.random.Generator, b: int, k: int, n_cls: int = 3, clusters: int = 12) -> torch.Tensor:
    """(b, k, 4) float32 xyxy boxes around a few centres per image, so that greedy NMS both keeps
    and suppresses, offset by class * 7680. Shared with the tests."""
    centres = rng.random((b, clusters, 2)) * 200
    pick = rng.integers(0, clusters, (b, k))
    c = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(10, 40, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + rng.integers(0, n_cls, (b, k, 1)) * 7680.0
    return torch.from_numpy(boxes.astype(np.float32))


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILER_FALLBACKS = []  # the per-site calls of device_ms whose traces recorded no device time: timed by CUDA events


def device_ms(fn, reps: int, tries: int = 5, fallback: bool = False) -> tuple[float, str]:
    """(mean device milliseconds per call, "profiler"): the summed durations of the kernels and copies that `reps`
    calls of `fn` run (torch.profiler, after one warm-up call), without the gaps in which the card waits for the
    host. A trace that recorded no device activity at all (seen in long runs, for a few microseconds of work) is
    taken again, up to `tries` times; then it is an error, unless `fallback` (only for the rows of one site alone):
    the call is then timed by CUDA events (`cuda_ms`, which also counts the card's waits for the host), returned as
    (ms, "cuda_events"), counted in PROFILER_FALLBACKS and printed."""
    for _ in range(tries):
        ms = profile_device(fn, steps=reps)["device_ms_per_step"]
        if ms > 0:
            return ms, "profiler"
    if not fallback:
        raise AssertionError(f"torch.profiler recorded no device time in {tries} traces of {reps} calls")
    ms = cuda_ms(fn, reps, warmup=1)
    PROFILER_FALLBACKS.append(ms)
    print(f"chip_smoke: torch.profiler recorded no device time in {tries} traces; CUDA events: {ms:.6f} ms",
          file=sys.stderr, flush=True)
    return ms, "cuda_events"


def kernel_times(fn, reps: int, prefix: str = "", site: bool = False) -> dict:
    """`fn`'s device time per call (`device_ms`) as `<prefix>ms`, and its time by CUDA events around back-to-back
    calls (`cuda_ms`, which also counts the card's waits for the host) as `<prefix>event_ms`. For one site alone
    (`site`), `<prefix>ms` may come from CUDA events, and `<prefix>ms_source` says where it came from."""
    ms, source = device_ms(fn, reps, fallback=site)
    out = {f"{prefix}ms": ms, f"{prefix}event_ms": cuda_ms(fn, reps, warmup=1)}
    if site:
        out[f"{prefix}ms_source"] = source
    return out


def ious_needed(off_boxes, valid, keep, thr) -> int:
    """IoUs a sequential greedy sweep computes on this data: for each kept row i, the j > i still alive."""
    from drone_yolo_tpu_torch.ops.nms import iou_matrix

    adj = torch.triu(iou_matrix(off_boxes) > thr, 1)
    kept_rows = (keep[:, :, None] & adj).int()
    suppressed_before = kept_rows.cumsum(1) - kept_rows  # kept suppressors of j among rows < i
    upper = torch.ones_like(adj[0]).triu(1)
    alive = valid[:, None, :] & (suppressed_before == 0) & upper
    return int((alive & keep[:, :, None]).sum())


def synthetic_batch(rng: np.random.Generator, batch: int, imgsz: int, nc: int, n_max: int = 24, val: bool = False) -> dict:
    """A train batch in the collate format: uint8 RGB frames, 1..n_max GT boxes per image of 4-64 px sides
    (at most imgsz/2) with random classes, padded to `round_label_slots(n_max, 1.0)` slots; with `val` also
    `ori_shapes` (imgsz, imgsz) and `ratio_pads` (1.0, (0.0, 0.0)) per image, as the validator reads them.
    Shared with the tests."""
    from drone_yolo_tpu_torch.data.dataset import round_label_slots

    slots = round_label_slots(n_max, 1.0)
    cls = np.zeros((batch, slots), np.float32)
    boxes = np.zeros((batch, slots, 4), np.float32)
    mask = np.zeros((batch, slots), np.float32)
    for i in range(batch):
        n = int(rng.integers(1, n_max + 1))
        wh = rng.uniform(4, min(64, imgsz / 2), (n, 2))
        xy = rng.uniform(0, imgsz - wh)
        boxes[i, :n] = np.concatenate([xy, xy + wh], 1)
        cls[i, :n] = rng.integers(0, nc, n)
        mask[i, :n] = 1.0
    img = rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    out = {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}
    if val:
        out.update(ori_shapes=[(imgsz, imgsz)] * batch, ratio_pads=[(1.0, (0.0, 0.0))] * batch)
    return out


def synthetic_pose_batch(rng: np.random.Generator, batch: int, imgsz: int, nc: int, nk: int, n_max: int = 24,
                         val: bool = False) -> dict:
    """`synthetic_batch` with `keypoints` (B, M, nk, 3): per GT box nk points uniform inside it, of visibility 2
    (70%), 1 (15%) or 0 (15%), zeros in the padded slots. Shared with the tests."""
    out = synthetic_batch(rng, batch, imgsz, nc, n_max, val)
    boxes = out["bboxes"]
    u = rng.random((*boxes.shape[:2], nk, 2))
    xy = boxes[:, :, None, :2] + u * (boxes[:, :, None, 2:] - boxes[:, :, None, :2])
    vis = rng.choice([2.0, 1.0, 0.0], size=(*boxes.shape[:2], nk, 1), p=[0.7, 0.15, 0.15])
    out["keypoints"] = (np.concatenate([xy, vis], -1) * out["mask"][:, :, None, None]).astype(np.float32)
    return out


def synthetic_seg_batch(rng: np.random.Generator, batch: int, imgsz: int, nc: int, n_max: int = 24) -> dict:
    """`synthetic_batch` with `masks` (B, imgsz / 4, imgsz / 4) int32, the collated overlap index mask: each live
    slot's box filled with its slot + 1 at mask ratio 4, later slots on top. Shared with the tests."""
    out = synthetic_batch(rng, batch, imgsz, nc, n_max)
    masks = np.zeros((batch, imgsz // 4, imgsz // 4), np.int32)
    for i in range(batch):
        for j in np.flatnonzero(out["mask"][i]):
            x1, y1, x2, y2 = (out["bboxes"][i, j] / 4).astype(int)
            masks[i, y1:y2 + 1, x1:x2 + 1] = j + 1
    out["masks"] = masks
    return out


# A standing figure's 17 COCO keypoints in its unit box (x right, y down), facing the camera: nose, eyes, ears,
# shoulders, elbows, wrists, hips, knees, ankles, each pair the person's left first (the image's right), and the
# limbs drawn between them
FIGURE_KPTS = np.array([[0.50, 0.06], [0.55, 0.04], [0.45, 0.04], [0.60, 0.06], [0.40, 0.06], [0.72, 0.22],
                        [0.28, 0.22], [0.82, 0.38], [0.18, 0.38], [0.88, 0.52], [0.12, 0.52], [0.64, 0.55],
                        [0.36, 0.55], [0.66, 0.76], [0.34, 0.76], [0.68, 0.97], [0.32, 0.97]])
FIGURE_LIMBS = ((5, 6), (5, 7), (7, 9), (6, 8), (8, 10), (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14),
                (14, 16), (0, 1), (0, 2), (1, 3), (2, 4))
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def write_pose_dataset(root: Path, n_train: int, n_val: int, size: int, seed: int) -> Path:
    """A seeded pose dataset of 17-keypoint figures (nc 1): per image 1-6 figures of 10-47% of its height on a noisy
    background, each a skeleton drawn between its keypoints (jittered 3% of the box) with a disc at each joint, written
    by the port's JPEG encoder at quality 95 with pose labels (`cls cx cy w h` and 17 `x y v`, v 2 or, 10% of the
    points, 1) and a data.yaml with `kpt_shape: [17, 3]` and COCO's `flip_idx`. Returns the yaml path."""
    from drone_yolo_tpu_torch.data.jpeg import encode_jpeg

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = (rng.random((size, size, 3)) * 50 + 80).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 7))):
                h = float(rng.uniform(0.1, 0.47) * size)
                w = h * float(rng.uniform(0.4, 0.6))
                x0, y0 = rng.uniform(0, size - w), rng.uniform(0, size - h)
                pts = (FIGURE_KPTS + rng.normal(0, 0.03, FIGURE_KPTS.shape)).clip(0, 1) * [w, h] + [x0, y0]
                color = rng.integers(0, 256, 3)
                r = max(2, int(h / 60))
                for a, b in FIGURE_LIMBS:
                    for t in np.linspace(0, 1, int(np.hypot(*(pts[a] - pts[b]))) + 2):
                        cx, cy = (pts[a] + t * (pts[b] - pts[a])).astype(int)
                        img[max(cy - r, 0):cy + r + 1, max(cx - r, 0):cx + r + 1] = color
                for cx, cy in pts.astype(int):
                    img[max(cy - 2 * r, 0):cy + 2 * r + 1, max(cx - 2 * r, 0):cx + 2 * r + 1] = 255 - color
                lo, hi = pts.min(0) - r, pts.max(0) + r
                lo, hi = lo.clip(0, size), hi.clip(0, size)
                vis = np.where(rng.random(17) < 0.1, 1, 2)
                row = [0, *((lo + hi) / 2 / size), *((hi - lo) / size)]
                row += [v for (x, y), vi in zip(pts / size, vis) for v in (x, y, vi)]
                rows.append(" ".join(f"{v:.6f}" if isinstance(v, float) else str(v) for v in row))
            (root / "images" / split / f"{split}_{i:04d}.jpg").write_bytes(encode_jpeg(img, quality=95))
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nkpt_shape: [17, 3]\n"
                         f"flip_idx: {COCO_FLIP_IDX}\nnames:\n  0: person\n")
    return yaml_path


def write_seg_dataset(root: Path, n_train: int, n_val: int, size: int, seed: int, nc: int) -> Path:
    """A seeded polygon dataset of `nc` classes: per image 2-12 filled polygons (5-16 vertices around a centre, radii
    jittered, so many are concave) of 3-30% of the image on a noisy background, drawn by the port's `fill_poly` and
    written by its JPEG encoder at quality 95, with segment labels (`cls x1 y1 x2 y2 ...`, normalized) and a data.yaml.
    Returns the yaml path."""
    from drone_yolo_tpu_torch.data.jpeg import encode_jpeg
    from drone_yolo_tpu_torch.ops.polygon import fill_poly

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = (rng.random((size, size, 3)) * 50 + 80).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(2, 13))):
                k = int(rng.integers(5, 17))
                ang = np.sort(rng.uniform(0, 2 * np.pi, k))
                r = rng.uniform(0.015, 0.15) * size * rng.uniform(0.5, 1.0, (k, 1))
                pts = (rng.uniform(0.1, 0.9, 2) * size + np.stack([np.cos(ang), np.sin(ang)], 1) * r).clip(0, size - 1)
                mask = fill_poly(np.zeros((size, size), np.uint8), [pts.astype(np.int32)], 1).astype(bool)
                img[mask] = rng.integers(0, 256, 3)
                rows.append(f"{int(rng.integers(0, nc))} " + " ".join(f"{v / size:.6f}" for v in pts.reshape(-1)))
            (root / "images" / split / f"{split}_{i:04d}.jpg").write_bytes(encode_jpeg(img, quality=95))
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnc: {nc}\n")
    return yaml_path



def rotated_rect_image(rng: np.random.Generator, size: int, n_range, px_range, nc: int):
    """A size x size BGR uint8 image of rotated rectangles on a noisy background, as an aerial view shows vehicles,
    ships and planes: n in `n_range` rectangles of long side in `px_range` and aspect 1-4 at any angle, each filled by
    the port's `fill_poly` in a random colour, corners clipped to the frame. Returns (image, [(cls, corners (4, 2)
    float32 pixels)]). Shared with the tests."""
    from drone_yolo_tpu_torch.ops.polygon import fill_poly

    img = (rng.random((size, size, 3)) * 50 + 80).astype(np.uint8)
    out = []
    for _ in range(int(rng.integers(n_range[0], n_range[1] + 1))):
        w = float(rng.uniform(*px_range))
        h = w / float(rng.uniform(1.0, 4.0))
        c, ang = rng.uniform(0, size, 2), float(rng.uniform(0, np.pi))
        dx, dy = np.array([-w, w, w, -w]) / 2, np.array([-h, -h, h, h]) / 2
        pts = c + np.stack([dx * np.cos(ang) - dy * np.sin(ang), dx * np.sin(ang) + dy * np.cos(ang)], 1)
        pts = pts.clip(0, size - 1).astype(np.float32)
        if np.ptp(pts[:, 0]) < 2 or np.ptp(pts[:, 1]) < 2:  # clipped to a sliver of the edge
            continue
        mask = fill_poly(np.zeros((size, size), np.uint8), [np.round(pts).astype(np.int32)], 1).astype(bool)
        img[mask] = rng.integers(0, 256, 3)
        out.append((int(rng.integers(0, nc)), pts))
    return img, out


def write_obb_dataset(root: Path, n_train: int, n_val: int, size: int, seed: int, nc: int, n_range, px_range) -> Path:
    """A seeded oriented-box dataset of `nc` classes (`rotated_rect_image`), written by the port's JPEG encoder at
    quality 95 with YOLO-OBB labels (`cls x1 y1 x2 y2 x3 y3 x4 y4`, normalized) and a data.yaml. Returns the yaml
    path."""
    from drone_yolo_tpu_torch.data.jpeg import encode_jpeg

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, objs = rotated_rect_image(rng, size, n_range, px_range, nc)
            rows = [f"{c} " + " ".join(f"{v / size:.6f}" for v in pts.reshape(-1)) for c, pts in objs]
            rgb = np.ascontiguousarray(img[..., ::-1])
            (root / "images" / split / f"{split}_{i:04d}.jpg").write_bytes(encode_jpeg(rgb, quality=95))
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnc: {nc}\n")
    return yaml_path


def synthetic_obb_batch(rng: np.random.Generator, batch: int, imgsz: int, nc: int, n_max: int = 12,
                        slots: int = 32) -> dict:
    """A collate-format OBB batch of `batch` images of rotated rectangles (`rotated_rect_image`, 1 to n_max a
    frame, 8-40% of imgsz): `segments_list` (their corners), the boxes their extents. Shared with the tests."""
    out = {"img": np.zeros((batch, imgsz, imgsz, 3), np.uint8), "cls": np.zeros((batch, slots), np.float32),
           "bboxes": np.zeros((batch, slots, 4), np.float32), "mask": np.zeros((batch, slots), np.float32),
           "segments_list": []}
    for i in range(batch):
        img, objs = rotated_rect_image(rng, imgsz, (1, n_max), (0.08 * imgsz, 0.4 * imgsz), nc)
        objs = objs[:slots]
        out["img"][i] = img[..., ::-1]
        out["segments_list"].append([pts for _, pts in objs])
        for j, (c, pts) in enumerate(objs):
            out["cls"][i, j], out["mask"][i, j] = c, 1.0
            out["bboxes"][i, j] = [*pts.min(0), *pts.max(0)]
    return out

def write_dense_dataset(root: Path, n_train: int, n_val: int, size: int, seed: int, nc: int, obj_px) -> tuple[Path, dict]:
    """The dense small-object proxy (`tools/dense_dataset.py:make_dense_image`, numpy only) written by the port's JPEG
    encoder at quality 95, with YOLO labels and data.yaml, as `make_dense_dataset` lays it out. Returns the yaml path
    and the round trip's mean and largest absolute error over all images."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from dense_dataset import CLASSES, make_dense_image

    from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    rng = np.random.default_rng(seed)
    err_sum, err_max, n_val_px = 0.0, 0, 0
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, labels = make_dense_image(rng, size=size, nc=nc, obj_px=obj_px)
            data = encode_jpeg(img, quality=95)
            (root / "images" / split / f"{split}_{i:04d}.jpg").write_bytes(data)
            err = np.abs(decode_jpeg(data).astype(np.int64) - img)
            err_sum, err_max, n_val_px = err_sum + float(err.sum()), max(err_max, int(err.max())), n_val_px + err.size
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text(
                "".join(f"{c} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n" for c, x, y, w, h in labels))
    names = "".join(f"  {i}: {CLASSES[i][0]}\n" for i in range(nc))
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnc: {nc}\nnames:\n{names}")
    return yaml_path, {"mean_abs_err": err_sum / n_val_px, "max_abs_err": err_max}


def write_cls_folder(root: Path, n_train: int, n_val: int, seed: int) -> Path:
    """An image folder in imagenet10's layout (`IMAGENET_WNIDS`): per class a hue, stripes at a class angle and noise,
    in images of mixed size and aspect, written by the port's JPEG encoder at quality 90."""
    from drone_yolo_tpu_torch.data.jpeg import encode_jpeg

    rng = np.random.default_rng(seed)
    shapes = ((192, 256), (256, 192), (224, 224), (180, 320), (320, 180), (240, 300))
    for split, n in (("train", n_train), ("val", n_val)):
        for c, wnid in enumerate(IMAGENET_WNIDS):
            d = root / split / wnid
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                h, w = shapes[int(rng.integers(len(shapes)))]
                yy, xx = np.mgrid[0:h, 0:w]
                ang = c * np.pi / len(IMAGENET_WNIDS)
                stripes = 60 * np.sin((xx * np.cos(ang) + yy * np.sin(ang)) / (4 + c))
                hue = np.array([np.cos(2 * np.pi * c / 10 + k * 2.1) for k in range(3)]) * 70 + 128
                img = np.clip(hue + stripes[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
                (d / f"{wnid}_{i:04d}.JPEG").write_bytes(encode_jpeg(img, quality=90))
    return root


def classifier_weights(state_dict: dict, rng: np.random.Generator, gain: float) -> dict:
    """`spread_weights`, then `Classify`'s linear weights scaled by `gain`: logits of a few units that follow the image,
    so that the top class stands clear of rounding."""
    out = spread_weights(state_dict, rng)
    for name, t in out.items():
        if name.endswith("linear.weight"):
            out[name] = t * gain
    return out


def synthetic_cls_batch(rng: np.random.Generator, batch: int, imgsz: int, nc: int) -> dict:
    """A classifier's collate-format batch: random uint8 RGB images and random labels."""
    return {"img": rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8),
            "cls": rng.integers(0, nc, batch).astype(np.int32)}


def accuracy(seeds: list[int]) -> None:
    """`YOLO.train` at the ablation settings on 192 + 96 dense-proxy images, then `YOLO.val` at conf 0.001: one JSON
    line per init seed (the ablation's seed is 0)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    from drone_yolo_tpu_torch import YOLO

    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
    tmp = Path(tempfile.mkdtemp(prefix="chip_accuracy_"))
    try:
        t = time.perf_counter()
        data, round_trip = write_dense_dataset(tmp / "dense", 192, 96, 320, seed=1, nc=6, obj_px=(4, 12))
        data_s = time.perf_counter() - t
        for seed in seeds:
            t = time.perf_counter()
            model = YOLO(FLAGSHIP)
            model.train(data=str(data), workers=4, cache="ram", project=str(tmp / "runs"), name=f"seed{seed}",
                        exist_ok=True, s2grad="cuda", bnstats="cuda", **{**ABLATION, "seed": seed})
            train_s = time.perf_counter() - t
            t = time.perf_counter()
            metrics = model.val(data=str(data), imgsz=320, batch=8, conf=0.001, iou=0.7, max_det=300, dtype="float32",
                                verbose=False)
            val_s = time.perf_counter() - t
            epochs = model.trainer.epoch_stats
            print(json.dumps({"phase": "accuracy", "model": FLAGSHIP, "nvidia_smi": smi, "hyps": {**ABLATION, "seed": seed},
                              "map50_95": metrics["metrics/mAP50-95(B)"], "map50": metrics["metrics/mAP50(B)"],
                              "metrics": metrics, "jax_ablation_json": {"map50_95": 0.8825, "map50": 0.9908},
                              "train_s": train_s, "val_s": val_s, "dataset_s": data_s, "jpeg_round_trip": round_trip,
                              "epoch_s_median": float(np.median([e["train_s"] for e in epochs])),
                              "data_wait_share": sum(e["data_wait_s"] for e in epochs) / sum(e["train_s"] for e in epochs),
                              "results_csv": (model.trainer.save_dir / "results.csv").read_text()}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def bn_stats_errors(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> dict:
    """The largest difference of (s, q) from `bn_stats_reference(x)` per channel, and the largest ratio of that
    difference to its tolerance BN_RTOL * (sum |x| or sum x^2) + BN_ATOL (<= 1 passes). Shared with the tests."""
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats_reference

    with torch.no_grad():
        s_p, q_p = bn_stats_reference(x)
        xf = x.float()
        scales = (xf.abs().sum((0, 2, 3)), q_p)
    out = {}
    for name, got, want, scale in (("sum", s, s_p, scales[0]), ("sumsq", q, q_p, scales[1])):
        err = (got - want).abs()
        out[f"{name}_err"] = float(err.max())
        out[f"{name}_err_over_tol"] = float((err / (BN_RTOL * scale + BN_ATOL)).max())
    return out


# the BN scale of the last conv of an attention block's residual branches (Attention's and AAttn's `proj`, PSABlock's
# `ffn.1`, ABlock's `mlp.1`), which `spread_weights` takes down 10x
RESIDUAL_BRANCH_BN = re.compile(r"\.(attn\.proj|ffn\.1|mlp\.1)\.bn\.weight$")


def spread_weights(state_dict: dict, rng: np.random.Generator) -> dict:
    """A redrawn float32 state dict of an unfused model whose activations stay O(1) through the
    depth: LeCun-normal kernels, BN statistics away from identity; the biases of the head's last
    convs (the box and class priors) stay. The attention blocks' residual branches end in a BN scale
    of 0.05-0.15 (`RESIDUAL_BRANCH_BN`): at 0.5-1.5 each of yolo12s's ABlocks adds an O(1) branch to
    its input, the activations and attention logits grow through the stack until the softmax picks by
    rounding, and float32 forwards on two devices no longer agree. Shared with the tests."""
    out = {}
    for name, t in state_dict.items():
        if name.endswith("weight") and t.ndim == 4:
            v = rng.standard_normal(t.shape) * math.sqrt(1.0 / np.prod(t.shape[1:]))
        elif name.endswith("running_var") or (name.endswith("weight") and t.ndim == 1):
            v = rng.uniform(0.5, 1.5, t.shape)
        elif name.endswith("running_mean") or (name.endswith("bias") and (".bn." in name or "rbr_identity" in name)):
            v = rng.normal(0.0, 0.1, t.shape)
        else:
            v = t.cpu().numpy()
        if RESIDUAL_BRANCH_BN.search(name):
            v = v * 0.1
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def scored_weights(state_dict: dict, rng: np.random.Generator, cls_bias: float, cls_gain: float) -> dict:
    """`spread_weights`, then the last conv of each level's class branch (`cv3.<i>.2`, and a v10 head's
    `one2one_cv3.<i>.2`) with its weights scaled by
    `cls_gain` and its biases set to `cls_bias`: class logits that follow the image, spread around `cls_bias`, instead of
    scores near sigmoid(-13). A random model whose detections a tracker follows. Shared with the tests."""
    out = spread_weights(state_dict, rng)
    for name, t in out.items():
        if re.search(r"\.(one2one_)?cv3\.\d+\.2\.bias$", name):
            out[name] = torch.full_like(t, cls_bias)
        elif re.search(r"\.(one2one_)?cv3\.\d+\.2\.weight$", name):
            out[name] = t * cls_gain
    return out


def moving_frames(rng: np.random.Generator, n: int, hw: tuple[int, int], n_objects: int, size=(8, 40),
                  background=None):
    """`n` BGR uint8 frames of `n_objects` textured rectangles moving at constant velocity over a fixed textured
    background (or over `background`, an (h, w, 3) uint8 image); an object enters at a random frame and leaves at a
    random later one, so tracks are born and die. The texture keeps neighbouring anchors from scoring exactly alike.
    Shared with the tests. A generator when `background` is given (its frames are large)."""
    h, w = hw
    if background is None:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        bg = np.stack([90 + 30 * np.sin(xx / w * 6.3 + c) + 20 * np.cos(yy / h * 4.1 + c) for c in range(3)], -1)
        bg = np.clip(bg + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
    else:
        bg = background
    wh = rng.integers(size[0], size[1] + 1, (n_objects, 2))
    xy = rng.uniform(0, 1, (n_objects, 2)) * (np.array([w, h]) - wh)
    vel = rng.normal(0, 1.5, (n_objects, 2)) * max(h, w) / 640
    patches = [np.clip(rng.integers(0, 256, 3) + rng.normal(0, 25, (bh, bw, 3)), 0, 255).astype(np.uint8)
               for bw, bh in wh]
    start = rng.integers(0, max(1, n // 2), n_objects)
    stop = np.minimum(n, start + rng.integers(n // 4 + 1, n + 1, n_objects))

    def frame(f: int) -> np.ndarray:
        img = bg.copy()
        for j in np.flatnonzero((start <= f) & (f < stop)):
            x1, y1 = np.floor(xy[j] + vel[j] * (f - start[j])).astype(int)
            bw, bh = wh[j]
            cx1, cy1, cx2, cy2 = max(x1, 0), max(y1, 0), min(x1 + bw, w), min(y1 + bh, h)
            if cx1 < cx2 and cy1 < cy2:
                img[cy1:cy2, cx1:cx2] = patches[j][cy1 - y1:cy2 - y1, cx1 - x1:cx2 - x1]
        return img

    frames = (frame(f) for f in range(n))
    return frames if background is not None else list(frames)


def similarity(angle: float, centre, shift) -> np.ndarray:
    """(2, 3) float64 warp: a rotation by `angle` (radians, counterclockwise in image axes) about `centre`, then a
    translation by `shift`."""
    c, s = math.cos(angle), math.sin(angle)
    r = np.array([[c, -s], [s, c]])
    return np.concatenate([r, (np.asarray(centre) - r @ np.asarray(centre) + np.asarray(shift))[:, None]], 1)


def panning_frames(rng: np.random.Generator, n: int, hw: tuple[int, int], n_objects: int, size=(8, 40),
                   shift=(3.0, 20.0), max_rot_deg: float = 0.1, device="cpu"):
    """A camera that pans and turns over ground: `n` BGR uint8 frames (h, w), each a window of a larger textured
    canvas (fields and roofs: rectangles of flat colour, some noise) with `n_objects` of `moving_frames`' textured
    rectangles moving over it, warped by `ops/image.py:warp_affine_u8` on `device`. From one frame to the next the
    view moves by `shift[0]`-`shift[1]` px (its heading turns slowly) and turns by up to `max_rot_deg` degrees.
    Returns (frames, motions): motions[i] is the (2, 3) float64 warp of frame i-1's pixels to frame i's (the
    identity for frame 0). Shared with the tests."""
    from drone_yolo_tpu_torch.ops.image import warp_affine_u8

    h, w = hw
    steps = rng.uniform(*shift, n)
    heading = rng.uniform(0, 2 * math.pi) + np.cumsum(rng.normal(0, 0.25, n))
    turns = np.deg2rad(rng.uniform(-max_rot_deg, max_rot_deg, n))
    steps[0] = turns[0] = 0.0
    centre = np.array([w / 2, h / 2])
    # the camera's rotation and position on the canvas, frame by frame (frame pixel p sees canvas pixel pose @ p)
    poses, pose = [], np.eye(3)
    for i in range(n):
        motion = np.vstack([similarity(turns[i], centre, steps[i] * np.array([math.cos(heading[i]),
                                                                              math.sin(heading[i])])), [0, 0, 1]])
        pose = pose @ np.linalg.inv(motion)
        poses.append(pose)
    corners = np.array([[x, y, 1.0] for x in (0, w) for y in (0, h)]).T
    seen = np.concatenate([(p @ corners)[:2] for p in poses], 1)
    lo = np.floor(seen.min(1)) - 2
    ch, cw = (np.ceil(seen.max(1)) + 2 - lo).astype(int)[::-1]
    yy, xx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    canvas = np.stack([90 + 30 * np.sin(xx / 97 + c) + 20 * np.cos(yy / 61 + c) for c in range(3)], -1)
    for _ in range(int(ch * cw / 1500)):
        bh, bw = rng.integers(8, 90, 2)
        y0, x0 = rng.integers(0, ch - bh), rng.integers(0, cw - bw)
        canvas[y0:y0 + bh, x0:x0 + bw] = rng.uniform(20, 235, 3)
    canvas = np.clip(canvas + rng.normal(0, 5, canvas.shape), 0, 255).astype(np.uint8)
    objects = moving_frames(rng, n, (ch, cw), n_objects, size, background=canvas)
    to_canvas = np.array([[1, 0, -lo[0]], [0, 1, -lo[1]], [0, 0, 1]])
    frames, motions = [], []
    for i, img in enumerate(objects):
        src = torch.from_numpy(img).to(device)
        frames.append(warp_affine_u8(src, np.linalg.inv(to_canvas @ poses[i])[:2], (w, h)).cpu().numpy())
        motions.append(np.linalg.inv(poses[i]) @ poses[i - 1] if i else np.eye(3))
    return frames, [m[:2] for m in motions]


def detection_stream(rng: np.random.Generator, n_frames: int = 120, n_targets: int = 48, hw=(720, 1280)):
    """Per frame (xyxy float32 (n, 4), scores float32 (n,), classes float32 (n,)): targets of 20-80 px moving at
    constant velocity with jitter, each alive between a random birth and death, detected with probability 0.85 (a
    fifth of them at a low score in (0.11, 0.25)), plus up to 4 clutter boxes a frame. Shared with the tests."""
    h, w = hw
    birth = rng.integers(0, max(n_frames - 10, 1), n_targets)
    death = np.minimum(n_frames, birth + rng.integers(10, max(n_frames, 11), n_targets))
    wh = rng.uniform(20, 80, (n_targets, 2))
    xy0 = rng.uniform(0, 1, (n_targets, 2)) * (np.array([w, h]) - wh)
    vel = rng.normal(0, 3, (n_targets, 2))
    cls = rng.integers(0, 3, n_targets)
    frames = []
    for f in range(n_frames):
        boxes, scores, classes = [], [], []
        for t in np.flatnonzero((birth <= f) & (f < death)):
            if rng.random() > 0.85:
                continue  # missed
            c = xy0[t] + vel[t] * (f - birth[t]) + rng.normal(0, 1.5, 2)
            s = wh[t] * rng.uniform(0.95, 1.05, 2)
            boxes.append([*c, *(c + s)])
            scores.append(rng.uniform(0.11, 0.25) if rng.random() < 0.2 else rng.uniform(0.3, 0.95))
            classes.append(cls[t])
        for _ in range(int(rng.integers(0, 5))):
            c = rng.uniform(0, 1, 2) * np.array([w - 40, h - 40])
            boxes.append([*c, *(c + rng.uniform(10, 40, 2))])
            scores.append(rng.uniform(0.05, 0.4))
            classes.append(rng.integers(0, 3))
        order = rng.permutation(len(boxes))
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4)[order], np.asarray(scores, np.float32)[order],
                       np.asarray(classes, np.float32)[order]))
    return frames


def sass_counts(library: Path) -> dict:
    """Tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma) per kernel of a built library, by `cuobjdump -sass`
    from nvcc's toolkit; {"cuobjdump": "absent"} where the toolkit has none. Kernels are named as in the source,
    with their template arguments."""
    from drone_yolo_tpu_torch.ops.cuda_build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return {"cuobjdump": "absent"}
    counts, name = {}, None
    for line in sh(str(tool), "-sass", str(library)).splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            mangled = fn.group(1)
            m = re.search(r"s2_d[wx]_[a-z]+", mangled)  # the source name: lower case, up to the mangling's next capital
            name = m.group(0) if m else mangled
            args = re.findall(r"Li(\d+)E", mangled)
            name += f"<{','.join(args)}>" if args else ""
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in counts[name]:
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def profile_device(fn, steps: int, top: int = 15) -> dict:
    """torch.profiler over `steps` calls of `fn` (after one warm-up call): device busy share and the kernels that take
    the time. Only the device's activity is traced: the host's ops would only be dropped below, and tracing them
    costs seconds over a large model's step."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3
    rows = []
    for evt in prof.key_averages():  # device-side events only: kernels and copies, not the ops that launch them
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue  # a user annotation on the device (Optimizer.step) spans kernels counted on their own
        dev_us = getattr(evt, "self_device_time_total", None)
        dev_us = evt.self_cuda_time_total if dev_us is None else dev_us
        rows.append({"name": evt.key[:90], "calls": evt.count, "device_ms": dev_us / 1e3 / steps})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms * steps / wall_ms, "top": rows[:top]}


def s2_sites(model, batch: int, imgsz: int) -> list[dict]:
    """The convs of `model` that the stride-2 backward covers (`ops.conv_s2.covers`) in a train-mode forward of a
    (batch, 3, imgsz, imgsz) image, in forward order: name, k, the shapes of x, w and dy, and whether dx is needed.
    Traced on the meta device (no arithmetic)."""
    from drone_yolo_tpu_torch.nn import modules as M
    from drone_yolo_tpu_torch.ops.conv_s2 import covers

    sites = []

    def hook(conv, args, name):
        x = args[0]
        if covers(conv, x):
            k = conv.kernel_size[0]
            sites.append({"name": name, "k": k, "x": tuple(x.shape), "w": tuple(conv.weight.shape),
                          "dy": (x.shape[0], conv.out_channels, x.shape[2] // 2, x.shape[3] // 2),
                          "need_dx": x.requires_grad})

    handles = []
    for n, m in model.named_modules():
        if isinstance(m, M.Conv):  # a Conv's site is named by the Conv
            handles.append(m.register_forward_pre_hook(lambda m, a, name=n: hook(m.conv, a, name)))
        elif isinstance(m, M.BasicBlock):  # a TorchVision block's convs by their own names
            convs = {"conv1": m.conv1, "conv2": m.conv2, **({"downsample.0": m.downsample[0]} if m.downsample else {})}
            handles += [c.register_forward_pre_hook(lambda c, a, name=f"{n}.{cn}": hook(c, a, name))
                        for cn, c in convs.items()]
    state = {k: torch.empty_like(v, device="meta").requires_grad_(v.requires_grad)
             for k, v in model.state_dict(keep_vars=True).items()}
    was_training = model.training
    try:
        model.train()
        with M.collect_bn_stats():
            torch.func.functional_call(model, state, (torch.empty(batch, 3, imgsz, imgsz, device="meta"),))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return sites


def bn_sites(model, batch: int, imgsz: int) -> list[dict]:
    """The train-mode BatchNorms of `model` in a forward of a (batch, 3, imgsz, imgsz) image, in forward order:
    name and input shape. Traced on the meta device (no arithmetic)."""
    from drone_yolo_tpu_torch.nn import modules as M

    sites = []
    handles = [m.register_forward_pre_hook(lambda m, a, name=n: sites.append({"name": name, "x": tuple(a[0].shape)}))
               for n, m in model.named_modules() if isinstance(m, M.BatchNorm2d)]
    state = {k: torch.empty_like(v, device="meta") for k, v in model.state_dict(keep_vars=True).items()}
    was_training = model.training
    try:
        model.train()
        with M.collect_bn_stats():
            torch.func.functional_call(model, state, (torch.empty(batch, 3, imgsz, imgsz, device="meta"),))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return sites


def site_input(shape, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """A BN input on the card: normals of mean 0.5 and scale 2 (a conv output's spread), cast to `dtype`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)


def s2_site_inputs(site: dict, dtype: torch.dtype, seed: int):
    """Random x, w, dy of a site on the card: unit normals, w scaled by 1/sqrt(fan-in)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(site["x"], generator=g, device="cuda").to(dtype)
    w = (torch.randn(site["w"], generator=g, device="cuda") / math.sqrt(np.prod(site["w"][1:]))).to(dtype)
    dy = torch.randn(site["dy"], generator=g, device="cuda").to(dtype)
    return x, w, dy


def s2_cost(site: dict) -> tuple[int, int]:
    """(bytes, operations) of one bf16 backward at a site: x, w, dy read once, dx (when needed) and the float32 dw
    written once; 2 operations per multiply-add, B*Ho*Wo*Co*Ci*k*k of them for dw and again for dx."""
    b, ci, h, w = site["x"]
    numel = lambda shape: int(np.prod(shape))  # noqa: E731
    n_bytes = 2 * (numel(site["x"]) + numel(site["w"]) + numel(site["dy"])) + 4 * numel(site["w"])
    macs = numel(site["dy"]) * ci * site["k"] ** 2
    if site["need_dx"]:
        n_bytes += 2 * numel(site["x"])
    return n_bytes, 2 * macs * (2 if site["need_dx"] else 1)


def check_loop_counts(c: dict, steps: int, val_batches: int, run: str, n_bn: int, n_sites: dict) -> None:
    """A loop run's kernel counts: every step calls the stride-2 backward at each site and the BN statistics at each
    BN input, every val batch calls greedy NMS once (two launches)."""
    from drone_yolo_tpu_torch.ops import cuda_s2bwd
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS

    want_s2 = {cuda_s2bwd.NAMES[k]: steps * n_sites[k] for k in KINDS}
    if c["s2_calls"] != want_s2 or c["bn_calls"] != steps * n_bn:
        raise AssertionError(f"run {run}: {c}, expected stride-2 calls {want_s2} and {steps * n_bn} BN calls "
                             f"for {steps} steps")
    if c["nms_calls"] != val_batches or c["launches"]["greedy_nms"] != 2 * val_batches:
        raise AssertionError(f"run {run}: {c['nms_calls']} NMS calls ({c['launches']['greedy_nms']} launches) for "
                             f"{val_batches} val batches")


def plot_cost(tr) -> dict:
    """The host work that `plots=True` (the default) adds to a training run: the seconds `train` waited at its end for
    the threads that drew and encoded its first three batches (`join_s`), and the seconds one such plot takes with
    nothing else running (`one_plot_s`: `plot_training_samples` of a synthetic batch of the run's size, to
    train_batch99.jpg). The three plots run beside the epoch's first steps and hold the GIL while they draw, so the
    epoch's seconds hold up to about 3 x `one_plot_s` of them."""
    batch = synthetic_batch(np.random.default_rng(99), tr.batch_size, tr.args.imgsz, len(tr.model.names))
    t0 = time.perf_counter()
    tr.plot_training_samples(batch, 99).join()
    return {"batches_drawn": len(tr.plot_threads), "join_s": tr.plot_join_s,
            "one_plot_s": time.perf_counter() - t0}


def run_loop(n_bn: int, n_sites: dict) -> dict:
    """Phase 9: runs A and B of the epoch loop (see the module docstring), their checks and their numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.cfg import get_train_cfg
    from drone_yolo_tpu_torch.data.build import build_yolo_dataset
    from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from drone_yolo_tpu_torch.data.utils import check_det_dataset
    from drone_yolo_tpu_torch.engine.checkpoint import read_resume_state
    from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from dense_dataset import make_dense_image

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        s2 = dict(cuda_s2bwd.s2_bwd_cuda.calls)
        s2_launches = dict(cuda_s2bwd.s2_bwd_cuda.launches)
        return {"s2_calls": s2, "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
                "nms_calls": cuda_nms.greedy_keep_cuda.calls,
                "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches, "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                             **{cuda_s2bwd.NAMES[k]: s2_launches.get(cuda_s2bwd.NAMES[k], 0) for k in KINDS}}}

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    try:
        data, round_trip = write_dense_dataset(tmp / "dense", LOOP["n_train"], LOOP["n_val"], LOOP["imgsz"],
                                               seed=LOOP["seed"], nc=LOOP["nc"], obj_px=LOOP["obj_px"])
        if not round_trip["mean_abs_err"] <= JPEG_MEAN_ERR:
            raise AssertionError(f"JPEG round trip of the dataset: {round_trip}, mean bound {JPEG_MEAN_ERR}")
        decode_ms = {}
        for size in (320, 640):
            blob = encode_jpeg(make_dense_image(np.random.default_rng(size), size=size)[0], quality=95)
            decode_jpeg(blob)  # the Huffman tables' lookup is built once
            t0 = time.perf_counter()
            for _ in range(5):
                decode_jpeg(blob)
            decode_ms[f"{size}px"] = (time.perf_counter() - t0) / 5 * 1e3
        cfg = get_train_cfg(overrides=dict(imgsz=LOOP["imgsz"], cache="ram"))  # default augmentation
        info = check_det_dataset(data)
        ds = build_yolo_dataset(cfg, info["train"], LOOP["batch"], info, mode="train")
        for i in range(len(ds)):
            ds.load_image(i)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        aug_ms = (time.perf_counter() - t0) / len(ds) * 1e3
        del ds

        common = dict(data=str(data), imgsz=LOOP["imgsz"], batch=LOOP["batch"], nbs=LOOP["batch"], optimizer="SGD",
                      close_mosaic=1, cache="ram", workers=LOOP["workers"], s2grad="cuda", bnstats="cuda", amp=True,
                      project=str(tmp / "runs"), exist_ok=True)
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = YOLO(FLAGSHIP)
        metrics_a = model.train(name="a", epochs=LOOP["epochs"], **common)
        wall_a = time.perf_counter() - t0
        counts_a = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        a = model.trainer
        nb, val_nb = a.nb, math.ceil(LOOP["n_val"] / LOOP["batch"])
        check_loop_counts(counts_a, LOOP["epochs"] * nb, LOOP["epochs"] * val_nb, "A", n_bn, n_sites)
        losses = np.array([e["loss_items"] for e in a.epoch_stats])
        if not (np.isfinite(losses).all() and len(a.epoch_stats) == LOOP["epochs"]):
            raise AssertionError(f"run A: {len(a.epoch_stats)} epochs, loss items {losses}")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics_a.values()):
            raise AssertionError(f"run A: metrics out of [0, 1]: {metrics_a}")
        files = {f: (a.wdir / f).stat().st_size for f in ("last.npz", "best.npz", "resume_state.npz")}
        if not (a.save_dir / "results.csv").is_file() or len((a.save_dir / "results.csv").read_text().splitlines()) != 1 + LOOP["epochs"]:
            raise AssertionError("run A: results.csv missing or not one row per epoch")
        final_a = a.train_state()

        reset()
        b = BaseTrainer(overrides=dict(model=FLAGSHIP, name="b", epochs=LOOP["epochs"] + 1,
                                       resume=str(a.wdir / "resume_state.npz"), **common))
        b._setup_train()
        start_b = b.train_state()
        for part in ("params", "ema"):
            if not all(torch.equal(start_b[part][k].cpu(), final_a[part][k].detach().cpu()) for k in final_a[part]):
                raise AssertionError(f"run B: resumed {part} differ from run A's final state")
        if not all(torch.equal(start_b["opt"]["momentum"][k].cpu(), final_a["opt"]["momentum"][k].cpu())
                   for k in final_a["opt"]["momentum"]):
            raise AssertionError("run B: resumed SGD momentum differs from run A's final state")
        if (b.start_epoch, start_b["step"], start_b["count"]) != (LOOP["epochs"], final_a["step"], final_a["count"]):
            raise AssertionError(f"run B: starts at epoch {b.start_epoch}, step {start_b['step']}, count {start_b['count']}")
        b._do_train()
        counts_b = counts()
        check_loop_counts(counts_b, nb, val_nb, "B", n_bn, n_sites)
        if [e["epoch"] for e in b.epoch_stats] != [LOOP["epochs"]]:
            raise AssertionError(f"run B ran epochs {[e['epoch'] for e in b.epoch_stats]}, expected [{LOOP['epochs']}]")
        _, saved_epoch = read_resume_state(b.wdir / "resume_state.npz")
        if saved_epoch != LOOP["epochs"]:
            raise AssertionError(f"run B saved epoch {saved_epoch}")

        reset()
        last = YOLO(a.wdir / "last.npz")
        frame = decode_jpeg(next((data.parent / "images" / "val").glob("*.jpg")).read_bytes())[..., ::-1]
        res = last.predict(np.ascontiguousarray(frame), imgsz=LOOP["imgsz"], conf=0.0, verbose=False)
        if not (len(res) == 1 and res[0].boxes.data.shape[1] == 6 and np.isfinite(res[0].boxes.data).all()):
            raise AssertionError("YOLO(last.npz) predictions on the card are not finite (n, 6) boxes")
        epochs = a.epoch_stats + b.epoch_stats
        train_s = [e["train_s"] for e in epochs]
        launches = {k: counts_a["launches"][k] + counts_b["launches"][k] for k in counts_a["launches"]}
        return {"model": FLAGSHIP, "dataset": {**LOOP, "jpeg_quality": 95, "round_trip": round_trip,
                                               "round_trip_mean_bound": JPEG_MEAN_ERR},
                "metrics_a": metrics_a, "metrics_b": b.metrics, "epochs": epochs,
                "epoch_s": train_s, "epoch_s_median": float(np.median(train_s)),
                "train_img_per_s": sum(e["images"] for e in epochs) / sum(train_s),
                "data_wait_share": sum(e["data_wait_s"] for e in epochs) / sum(train_s),
                "val_s": [e["val_s"] for e in epochs], "decode_ms_per_image": decode_ms,
                "augment_ms_per_sample": aug_ms, "peak_memory_gb": peak_gb, "checkpoint_bytes": files,
                "run_a_wall_s": wall_a, "resume": {"start_epoch": b.start_epoch, "bitwise_equal": True},
                "predict_last_npz_n_det": len(res[0].boxes), "plots": {"a": plot_cost(a), "b": plot_cost(b)},
                "counts": {"a": counts_a, "b": counts_b, "launches": launches}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def calibrated_weights(facade, frame: np.ndarray, seed: int, gain: float, share: float, conf: float, imgsz: int) -> float:
    """Load `scored_weights` into the facade's unfused model with the class bias at which `share` of the anchors of
    `frame` (letterboxed to imgsz) score above `conf` by their best class. Returns that bias."""
    from drone_yolo_tpu_torch.ops.letterbox import letterbox

    model = facade.ensure_variables(imgsz=imgsz)
    base = {k: v.cpu() for k, v in model.state_dict().items()}
    model.load_state_dict(scored_weights(base, np.random.default_rng(seed), 0.0, gain))
    x = letterbox(torch.from_numpy(frame).to(facade.device).flip(-1).permute(2, 0, 1)[None].float() / 255.0,
                  (imgsz, imgsz))
    with torch.inference_mode():  # the maps the predictor decodes: a v10 head's one-to-one ones
        head = model.head
        maps = head.one2one_maps(model.head_input(x)) if hasattr(head, "one2one_maps") else model(x, raw=True)
    reg = 4 * model.head.reg_max
    best = torch.cat([m[:, reg:reg + model.nc].flatten(2) for m in maps], 2).amax(1).flatten().float()
    bias = math.log(conf / (1.0 - conf)) - float(torch.quantile(best, 1.0 - share))
    model.load_state_dict(scored_weights(base, np.random.default_rng(seed), bias, gain))
    return bias


def run_track() -> dict:
    """Phase 10: the drone-video pipeline on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.apps import DroneVideoPipeline, GeoConverter
    from drone_yolo_tpu_torch.ops import cuda_nms
    from drone_yolo_tpu_torch.ops import nms as nms_ops
    from drone_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack
    from drone_yolo_tpu_torch.trackers.track import load_tracker_cfg

    c = TRACK_CELL
    h, w = c["hw"]
    frames = moving_frames(np.random.default_rng(c["seed"]), c["frames"], c["hw"], c["objects"], c["obj_px"])
    det, pose = YOLO(FLAGSHIP), YOLO(c["pose_model"])
    biases = {name: calibrated_weights(m, frames[0], seed, c["cls_gain"], c["share_above_conf"], c["conf"], c["imgsz"])
              for seed, (name, m) in enumerate(((FLAGSHIP, det), (c["pose_model"], pose)))}
    geo = GeoConverter(**c["geo"], image_width_px=w, image_height_px=h)

    def pipeline(with_pose: bool) -> DroneVideoPipeline:
        """A new pipeline whose trackers start afresh, as for a new video."""
        for m in (det, pose):
            if m.predictor is not None:
                m.predictor.__dict__.pop("trackers", None)
        STrack.reset_id()
        return DroneVideoPipeline(det, pose if with_pose else None, geo, imgsz=c["imgsz"], conf=c["conf"],
                                  tracker="bytetrack.yaml")

    # pass A: every keep mask of both models' NMS against the plain keep on the same candidates
    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        plain = nms_ops.greedy_keep_reference(boxes, valid, iou_thres)
        checks.append({"K": int(boxes.shape[1]), "valid": int(valid.sum()), "kept": int(keep.sum()),
                       "equal": bool(torch.equal(keep, plain))})
        return keep

    nms_ops.greedy_keep = checked_keep
    try:
        pipe, steps_a = pipeline(True), []
        for f in frames:
            first = len(checks)
            steps_a.append(pipe.step(f))
            for j, ch in enumerate(checks[first:]):  # a step runs the detector's NMS, then the pose model's
                ch["model"] = ("detector", "pose")[j]
    finally:
        nms_ops.greedy_keep = kernel_keep
    n_pose = sum("pose" in o for o in steps_a)
    if not all(ch["equal"] for ch in checks) or len(checks) != len(frames) + n_pose:
        raise AssertionError(f"track: {sum(not ch['equal'] for ch in checks)} of {len(checks)} keep masks differ from "
                             f"the plain keep ({len(frames)} frames, {n_pose} pose calls)")
    if n_pose < len(frames) - 1 or not any(ch["valid"] > ch["kept"] > 0 for ch in checks):
        raise AssertionError(f"track: {n_pose} pose calls in {len(frames)} frames, or no NMS call kept and suppressed")
    det_checks, pose_checks = ([ch for ch in checks if ch["model"] == m] for m in ("detector", "pose"))

    # pass B: the timed run, detect + track + pose + geo, with host timers around the tracker, pose and geo
    stage = defaultdict(float)

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stage[key] += time.perf_counter() - t
        return run

    update = BYTETracker.update
    BYTETracker.update = timed(update, "tracker_update")
    pipe = pipeline(True)
    pose.predict, geo.pixel_to_latlon = timed(pose.predict, "pose"), timed(geo.pixel_to_latlon, "geo")
    try:
        cuda_nms.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        speeds = [pipe.step(f)["results"].speed for f in frames]
        wall_full = time.perf_counter() - t
        nms_calls, nms_launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
    finally:
        BYTETracker.update = update
        del pose.predict, geo.pixel_to_latlon
    if nms_calls != len(frames) + n_pose or nms_launches != 2 * nms_calls:
        raise AssertionError(f"track: {nms_calls} NMS calls ({nms_launches} launches) for {len(frames)} frames and "
                             f"{n_pose} pose calls")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_track_"))
    try:
        pipe.export_csv(tmp / "tracks.csv")
        csv_rows = len((tmp / "tracks.csv").read_text().splitlines()) - 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = sum(len(v) for v in pipe.trajectories.values())
    if csv_rows != rows or len(pipe.trajectories) == 0:
        raise AssertionError(f"track: {csv_rows} CSV rows for {rows} trajectory points of {len(pipe.trajectories)} tracks")
    lens = [len(v) for v in pipe.trajectories.values()]

    # pass C: detect + track + geo without the pose model
    pipe_c = pipeline(False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for f in frames:
        pipe_c.step(f)
    wall_det = time.perf_counter() - t

    # the device's busy share over steps of the full pipeline (torch.profiler)
    pipe_d, it = pipeline(True), itertools.cycle(frames)
    prof = profile_device(lambda: pipe_d.step(next(it)), steps=3, top=8)  # ~8,000 traced launches a step

    # BYTETracker.update alone
    tracker_alone = {}
    args = load_tracker_cfg("bytetrack.yaml")
    for n in TRACKER_TARGETS:
        stream = detection_stream(np.random.default_rng(n), n_frames=60, n_targets=n, hw=c["hw"])
        tracker, ms = BYTETracker(args), []
        for boxes, scores, cls in stream:
            t = time.perf_counter()
            out = tracker.update(boxes, scores, cls)
            ms.append((time.perf_counter() - t) * 1e3)
        tracker_alone[str(n)] = {"update_ms_mean": float(np.mean(ms[5:])), "update_ms_median": float(np.median(ms[5:])),
                                 "detections_per_frame": float(np.mean([len(s[0]) for s in stream])),
                                 "tracks_last_frame": len(out)}

    n = len(frames)
    per_frame = {k: float(np.mean([s[k] for s in speeds])) for k in ("preprocess", "inference", "postprocess")}
    per_frame.update({k: stage[k] * 1e3 / n for k in ("tracker_update", "pose", "geo")})
    per_frame["other"] = wall_full * 1e3 / n - sum(per_frame.values())
    return {"detector": FLAGSHIP, "pose_model": c["pose_model"], "cell": c, "class_bias": biases, "dtype": "bfloat16",
            "fused": True, "fps_detect_track": n / wall_det, "fps_detect_track_pose": n / wall_full,
            "stage_ms_per_frame": per_frame, "pose_ms_per_call": stage["pose"] * 1e3 / max(n_pose, 1),
            "pose_calls": n_pose, "tracks": len(pipe.trajectories), "csv_rows": csv_rows,
            "track_len": {"median": float(np.median(lens)), "max": max(lens)},
            "tracks_per_frame_last": len(steps_a[-1]["tracks"]),
            "nms_keep_checks": {"calls": len(checks), "all_equal_plain": True,
                                "detector_valid_median": float(np.median([ch["valid"] for ch in det_checks])),
                                "detector_kept_median": float(np.median([ch["kept"] for ch in det_checks])),
                                "pose_valid_median": float(np.median([ch["valid"] for ch in pose_checks])),
                                "pose_kept_median": float(np.median([ch["kept"] for ch in pose_checks])),
                                "K": sorted({ch["K"] for ch in checks})},
            "nms_calls": nms_calls, "nms_launches": nms_launches,
            "profile": {k: prof[k] for k in ("steps", "wall_ms_per_step", "device_ms_per_step", "device_idle_share", "top")},
            "bytetrack_update_alone": tracker_alone}


def run_botsort() -> dict:
    """Phase 11: BoT-SORT with camera-motion compensation over a panning clip, and tiled inference (see the module
    docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.apps import DroneVideoPipeline, GeoConverter
    from drone_yolo_tpu_torch.ops import cuda_nms, flow, tiling
    from drone_yolo_tpu_torch.ops import nms as nms_ops
    from drone_yolo_tpu_torch.trackers import gmc as gmc_mod
    from drone_yolo_tpu_torch.trackers.bot_sort import BOTSORT
    from drone_yolo_tpu_torch.trackers.byte_tracker import STrack

    c, b = TRACK_CELL, BOTSORT_CELL
    h, w = c["hw"]
    dev = torch.device("cuda")
    t_gen = time.perf_counter()
    frames, motions = panning_frames(np.random.default_rng(b["seed"]), c["frames"], c["hw"], c["objects"], c["obj_px"],
                                     b["shift"], b["max_rot_deg"], device=dev)
    gen_s = time.perf_counter() - t_gen
    n_cpu = min(b["cpu_frames"], len(frames))

    # the motion compensation's steps, recorded on each side (card outputs copied to the host)
    rec = {"card": defaultdict(list), "cpu": defaultdict(list)}
    steps = {"corners": "good_features_to_track", "flow": "calc_optical_flow_pyr_lk",
             "ransac": "estimate_affine_partial_2d"}
    plain_steps = {k: getattr(flow, fn) for k, fn in steps.items()}

    def recording(key, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            side = "card" if a[0].is_cuda else "cpu"
            if side == "card" and not all(x.is_cuda for x in a if torch.is_tensor(x)):
                raise AssertionError(f"botsort: {key} on the card was given a host tensor")
            rec[side][key].append(tuple(x.cpu() if torch.is_tensor(x) else x for x in
                                        (out if isinstance(out, tuple) else (out,))))
            return out
        return run

    def cpu_gmc() -> list:
        g = gmc_mod.GMC(device="cpu")
        return [g.apply(f) for f in frames[:n_cpu]]

    # the CPU's GMC over the same frames, in a thread beside the untimed work (the weights, pass A)
    for k, fn in steps.items():
        setattr(flow, fn, recording(k, plain_steps[k]))
    pool = ThreadPoolExecutor(1)
    cpu_job = pool.submit(cpu_gmc)
    det, pose = YOLO(FLAGSHIP), YOLO(c["pose_model"])
    biases = {name: calibrated_weights(m, frames[0], seed, c["cls_gain"], c["share_above_conf"], c["conf"], c["imgsz"])
              for seed, (name, m) in enumerate(((FLAGSHIP, det), (c["pose_model"], pose)))}
    geo = GeoConverter(**c["geo"], image_width_px=w, image_height_px=h)
    stage_s = {"clip": gen_s, "weights": time.perf_counter() - t_gen - gen_s}

    def pipeline(with_pose: bool, tracker: str = "botsort.yaml") -> DroneVideoPipeline:
        """A new pipeline whose trackers start afresh, as for a new video."""
        for m in (det, pose):
            if m.predictor is not None:
                m.predictor.__dict__.pop("trackers", None)
        STrack.reset_id()
        return DroneVideoPipeline(det, pose if with_pose else None, geo, imgsz=c["imgsz"], conf=c["conf"],
                                  tracker=tracker)

    # pass A: BoT-SORT with pose; every keep mask against the plain keep
    checks, kernel_keep = [], nms_ops.greedy_keep
    card_warps = []

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        plain = nms_ops.greedy_keep_reference(boxes, valid, iou_thres)
        checks.append({"B": int(boxes.shape[0]), "K": int(boxes.shape[1]), "valid": int(valid.sum()),
                       "kept": int(keep.sum()), "cuda": bool(boxes.is_cuda), "equal": bool(torch.equal(keep, plain))})
        return keep

    apply = gmc_mod.GMC.apply

    def recorded_apply(self, raw_frame, detections=None):
        out = apply(self, raw_frame, detections)
        if self.device.type == "cuda":
            card_warps.append(out)
        return out

    nms_ops.greedy_keep, gmc_mod.GMC.apply = checked_keep, recorded_apply
    t_pass = time.perf_counter()
    try:
        cuda_nms.reset_counts()
        pipe_a = pipeline(True)
        steps_a = [pipe_a.step(f) for f in frames]
        nms_a = {"calls": cuda_nms.greedy_keep_cuda.calls, "launches": cuda_nms.greedy_keep_cuda.launches}
        stage_s["pass_a"] = time.perf_counter() - t_pass
        cpu_warps = cpu_job.result()
        stage_s["cpu_gmc_wait"] = time.perf_counter() - t_pass - stage_s["pass_a"]
    finally:
        pool.shutdown()
        nms_ops.greedy_keep, gmc_mod.GMC.apply = kernel_keep, apply
        for k, fn in steps.items():
            setattr(flow, fn, plain_steps[k])
    n_pose = sum("pose" in o for o in steps_a)
    if not isinstance(det.predictor.trackers[0], BOTSORT) or len(card_warps) != len(frames):
        raise AssertionError(f"botsort: {type(det.predictor.trackers[0]).__name__} tracker, {len(card_warps)} card "
                             f"warps for {len(frames)} frames")
    if not all(ch["equal"] and ch["cuda"] for ch in checks) or len(checks) != len(frames) + n_pose:
        raise AssertionError(f"botsort: {sum(not ch['equal'] for ch in checks)} of {len(checks)} keep masks differ "
                             f"from the plain keep ({len(frames)} frames, {n_pose} pose calls)")
    if nms_a["calls"] != len(frames) + n_pose or nms_a["launches"] != 2 * nms_a["calls"]:
        raise AssertionError(f"botsort: {nms_a} NMS calls and launches for {len(frames)} frames and {n_pose} pose "
                             "calls")
    # the card's GMC against the CPU's: corners, the tracker's status from the same previous corners, warps
    corners = {"card": [x[0] for x in rec["card"]["corners"]][:n_cpu], "cpu": [x[0] for x in rec["cpu"]["corners"]]}
    if len(rec["card"]["corners"]) != len(frames) or len(corners["cpu"]) != n_cpu:
        raise AssertionError(f"botsort: corners of {len(corners['card'])} card and {len(corners['cpu'])} CPU frames")
    corner_same = sum(int((a == b_).all(-1).sum()) if a.shape == b_.shape else 0
                      for a, b_ in zip(corners["card"], corners["cpu"]))
    corner_total = sum(len(b_) for b_ in corners["cpu"])
    same_lists = [i for i in range(n_cpu) if torch.equal(corners["card"][i], corners["cpu"][i])]
    status_same = status_total = 0
    flow_err = 0.0
    for j, ((pc, sc), (pp, sp)) in enumerate(zip(rec["card"]["flow"], rec["cpu"]["flow"])):
        if j in same_lists:  # frame j's corners went into the flow to frame j + 1 on both sides
            status_same += int((sc == sp).sum())
            status_total += len(sp)
            both = (sc[:, 0] == 1) & (sp[:, 0] == 1)
            flow_err = max(flow_err, float((pc - pp).abs()[both].max()) if both.any() else 0.0)
    lin_err = max(float(np.abs(a[:, :2] - b_[:, :2]).max()) for a, b_ in zip(card_warps, cpu_warps))
    t_err = max(float(np.abs(a[:, 2] - b_[:, 2]).max()) for a, b_ in zip(card_warps, cpu_warps))
    known_t = [float(np.abs(a[:, 2] - m[:, 2]).max()) for a, m in zip(card_warps, motions)]
    known_rot = [abs(math.atan2(a[1, 0], a[0, 0]) - math.atan2(m[1, 0], m[0, 0])) for a, m in zip(card_warps, motions)]
    centre = np.array([w / 2, h / 2, 1.0])
    known_centre = [float(np.abs(a @ centre - m @ centre).max()) for a, m in zip(card_warps, motions)]
    gmc_check = {"cpu_frames": n_cpu, "corners_equal": corner_same, "corners": corner_total,
                 "corner_lists_equal": len(same_lists),
                 "status_equal": status_same, "status_points": status_total, "flow_max_px": flow_err,
                 "warp_linear_max": lin_err, "warp_translation_max_px": t_err,
                 "known_translation_max_px": max(known_t), "known_translation_median_px": float(np.median(known_t)),
                 "known_centre_max_px": max(known_centre), "known_rotation_max_rad": max(known_rot),
                 "ransac_inliers_median": float(np.median([int(x[1].sum()) for x in rec["card"]["ransac"]])),
                 "tolerances": {"corners_share": GMC_CORNER_SHARE, "status_share": GMC_STATUS_SHARE,
                                "warp_linear": GMC_LIN_TOL, "warp_translation_px": GMC_T_TOL,
                                "known_translation_px": KNOWN_T_TOL, "known_rotation_rad": KNOWN_ROT_TOL}}
    if (corner_same < GMC_CORNER_SHARE * corner_total or status_same < GMC_STATUS_SHARE * status_total
            or lin_err > GMC_LIN_TOL or t_err > GMC_T_TOL):
        raise AssertionError(f"botsort: the card's GMC differs from the CPU's: {gmc_check}")
    if max(known_t) > KNOWN_T_TOL or max(known_rot) > KNOWN_ROT_TOL:
        raise AssertionError(f"botsort: the card's warps miss the clip's known motion: {gmc_check}")

    # pass B: timed, detect + BoT-SORT + geo, then with pose; GMC's steps and BOTSORT.update timed apart
    stage = defaultdict(float)

    def timed(fn, key, sync=False):
        def run(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                stage[key] += time.perf_counter() - t
        return run

    t_pass = time.perf_counter()
    fps = {}
    for with_pose in (False, True):
        pipe_b = pipeline(with_pose)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for f in frames:
            pipe_b.step(f)
        fps["detect_botsort_pose_geo" if with_pose else "detect_botsort_geo"] = len(frames) / (time.perf_counter() - t)
    botsort_tracks = {tid: len(v) for tid, v in pipe_b.trajectories.items()}
    update, preprocess = BOTSORT.update, gmc_mod.GMC.preprocess
    BOTSORT.update = timed(update, "update")
    gmc_mod.GMC.preprocess = timed(preprocess, "gray_resize", sync=True)
    for k, fn in steps.items():
        setattr(flow, fn, timed(plain_steps[k], k, sync=True))
    try:
        pipe_t = pipeline(False)
        for f in frames[:b["timed_frames"]]:
            pipe_t.step(f)
    finally:
        BOTSORT.update, gmc_mod.GMC.preprocess = update, preprocess
        for k, fn in steps.items():
            setattr(flow, fn, plain_steps[k])
    n = min(b["timed_frames"], len(frames))
    gmc_ms = {k: stage[k] * 1e3 / n for k in ("gray_resize", "corners", "flow", "ransac")}
    pipe_d, it = pipeline(True), itertools.cycle(frames)
    prof = profile_device(lambda: pipe_d.step(next(it)), steps=3, top=8)  # ~8,000 traced launches a step

    stage_s["pass_b"] = time.perf_counter() - t_pass
    # ByteTrack over the same clip: track lengths and ids beside BoT-SORT's (a finding, not a check)
    t_pass = time.perf_counter()
    pipe_bt = pipeline(False, "bytetrack.yaml")
    for f in frames:
        pipe_bt.step(f)
    lens = {"botsort": list(botsort_tracks.values()), "bytetrack": [len(v) for v in pipe_bt.trajectories.values()]}
    trackers = {k: {"ids": len(v), "track_len_median": float(np.median(v)) if v else 0.0,
                    "track_len_max": max(v, default=0)} for k, v in lens.items()}

    stage_s["bytetrack"] = time.perf_counter() - t_pass
    # pass C: tiled inference of one 4K frame, 32 windows in two batches of 16, through the detector's predictor
    t_pass = time.perf_counter()
    tc = b["tiled"]
    frame4k = np.ascontiguousarray(moving_frames(np.random.default_rng(tc["seed"]), 1, tc["hw"], tc["objects"],
                                                 c["obj_px"])[0][..., ::-1])  # RGB, as tiled_inference takes it
    predictor = det.predictor
    spans = []

    def forward(variables, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predictor.inference(batch)
        torch.cuda.synchronize()
        spans.append((t0, time.perf_counter()))
        return out

    def tiled():
        spans.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tiling.tiled_inference(forward, None, frame4k, crop_size=tc["crop"], gap=tc["gap"],
                                     max_crop_batch=tc["batch"], iou=predictor.args.iou, max_det=predictor.args.max_det,
                                     device=predictor.device)
        t1 = time.perf_counter()
        return out, {"total": t1 - t0, "crop_upload": spans[0][0] - t0,
                     "forward_nms": sum(e - s for s, e in spans), "merge": t1 - spans[-1][1]}

    checks.clear()
    nms_ops.greedy_keep = checked_keep
    try:
        cuda_nms.reset_counts()
        merged, _ = tiled()
        nms_c = {"calls": cuda_nms.greedy_keep_cuda.calls, "launches": cuda_nms.greedy_keep_cuda.launches}
    finally:
        nms_ops.greedy_keep = kernel_keep
    n_windows = len(tiling.get_windows(tc["hw"], tc["crop"], tc["gap"]))
    if (n_windows, [ch["B"] for ch in checks]) != (32, [tc["batch"], tc["batch"], 1]) or not all(
            ch["equal"] and ch["cuda"] for ch in checks) or nms_c != {"calls": 3, "launches": 6}:
        raise AssertionError(f"tiled: {n_windows} windows, NMS calls {checks}, counts {nms_c}")
    if not (len(merged) and np.isfinite(merged).all() and merged.shape[1] == 6 and (merged[:, 4] >= c["conf"]).all()):
        raise AssertionError(f"tiled: merged detections {merged.shape}, finite {np.isfinite(merged).all()}")
    times = [tiled()[1] for _ in range(6)][1:]
    tiled_ms = {k: float(np.median([t[k] for t in times])) * 1e3 for k in times[0]}
    stage_s["pass_c"] = time.perf_counter() - t_pass
    return {"detector": FLAGSHIP, "pose_model": c["pose_model"], "cell": {**b, "frames": len(frames), "hw": c["hw"],
                                                                          "objects": c["objects"]},
            "class_bias": biases, "dtype": "bfloat16", "fused": True, "stage_s": stage_s,
            "gmc_check": gmc_check,
            "nms_keep_checks": {"calls": len(checks) + len(frames) + n_pose, "all_equal_plain": True},
            "nms_pass_a": nms_a, "pose_calls": n_pose, "fps": fps, "gmc_ms_per_frame": gmc_ms,
            "gmc_ms_per_frame_sum": sum(gmc_ms.values()), "botsort_update_ms_per_frame": stage["update"] * 1e3 / n,
            "association_ms_per_frame": (stage["update"] - sum(stage[k] for k in gmc_ms)) * 1e3 / n,
            "profile": {k: prof[k] for k in ("steps", "wall_ms_per_step", "device_ms_per_step", "device_idle_share",
                                             "top")},
            "trackers": trackers,
            "tiled": {"hw": tc["hw"], "windows": n_windows, "batches": 2, "merged": len(merged),
                      "merge_K": checks[-1]["K"], "merge_kept": checks[-1]["kept"], "ms_per_frame": tiled_ms,
                      "nms": nms_c},
            "nms_calls": nms_a["calls"] + nms_c["calls"], "nms_launches": nms_a["launches"] + nms_c["launches"],
            "nms_launches_tiled": nms_c["launches"], "nms_launches_botsort": nms_a["launches"]}


def write_mixed_val(root: Path, n: int, size: int, nc: int, seed: int) -> Path:
    """A val set of the dense proxy in mixed aspect ratios: `make_dense_image` at `size`, cropped from the top left to
    each of ENTRY_VAL_ASPECTS (h, w fractions) in turn, the labels of the objects whose centre stays inside clipped to
    the crop; written by the port's JPEG encoder (quality 95) with data.yaml. Returns the yaml path."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from dense_dataset import CLASSES, make_dense_image

    from drone_yolo_tpu_torch.data.jpeg import encode_jpeg

    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img, labels = make_dense_image(rng, size=size, nc=nc, obj_px=(6, 24))
        fh, fw = ENTRY_VAL_ASPECTS[i % len(ENTRY_VAL_ASPECTS)]
        h, w = int(size * fh), int(size * fw)
        rows = []
        for c, x, y, bw, bh in labels:
            x1, y1 = max((x - bw / 2) * size, 0), max((y - bh / 2) * size, 0)
            x2, y2 = min((x + bw / 2) * size, w), min((y + bh / 2) * size, h)
            if x * size < w and y * size < h and x2 > x1 and y2 > y1:
                rows.append(f"{c} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}\n")
        (root / "images" / "val" / f"val_{i:04d}.jpg").write_bytes(encode_jpeg(np.ascontiguousarray(img[:h, :w]), 95))
        (root / "labels" / "val" / f"val_{i:04d}.txt").write_text("".join(rows))
    (root / "images" / "train" / "t.jpg").write_bytes(encode_jpeg(np.zeros((64, 64, 3), np.uint8)))
    names = "".join(f"  {i}: {CLASSES[i][0]}\n" for i in range(nc))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n{names}")
    return root / "data.yaml"


@contextlib.contextmanager
def host_seconds(targets: dict):
    """Host seconds spent in each of `targets` ({name: (owner, attribute)}, functions or methods) while the block
    runs, summed per name into the yielded dict; the originals are put back after."""
    spent = defaultdict(float)
    saved = {name: (owner, attr, getattr(owner, attr)) for name, (owner, attr) in targets.items()}

    def wrap(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return run

    for name, (owner, attr, fn) in saved.items():
        setattr(owner, attr, wrap(name, fn))
    try:
        yield spent
    finally:
        for owner, attr, fn in saved.values():
            setattr(owner, attr, fn)


def run_entry(smi: str, keep: Path) -> dict:
    """Phase 12: the normal entry points on the card (see the module docstring), their checks and their numbers. Its
    inputs clip.avi and frames/ are copied to `keep` for the draw phase."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.apps import DroneVideoPipeline, GeoConverter
    from drone_yolo_tpu_torch.cfg import entrypoint, get_val_cfg
    from drone_yolo_tpu_torch.data.avi import AviReader, AviWriter, read_avi
    from drone_yolo_tpu_torch.data.build import build_yolo_dataset
    from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from drone_yolo_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
    from drone_yolo_tpu_torch.data.png import decode_png, encode_png
    from drone_yolo_tpu_torch.data.utils import check_det_dataset
    from drone_yolo_tpu_torch.data.loaders import LoadImagesAndVideos
    from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from drone_yolo_tpu_torch.engine.results import Results
    from drone_yolo_tpu_torch.engine.validator import DetectionValidator
    from drone_yolo_tpu_torch.ops import cuda_nms
    from drone_yolo_tpu_torch.ops import nms as nms_ops
    from drone_yolo_tpu_torch.trackers.byte_tracker import STrack

    c = ENTRY_CELL
    stage_s, t_stage = {}, [time.perf_counter()]

    def lap(name: str) -> float:
        """Seconds since the last lap, kept under `name`."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[name] = now - t_stage[0]
        t_stage[0] = now
        return stage_s[name]

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    try:
        # inputs, written by the port's encoders: the AVI's payloads (its first frames also stand as the directory's
        # landscape 1080p JPEGs), the other frames of the directory, the mixed-aspect val set
        rng = np.random.default_rng(c["seed"])
        clip_frames = moving_frames(rng, c["avi_frames"], c["avi_hw"], c["objects"], c["obj_px"])
        clip = tmp / "clip.avi"
        with AviWriter(clip, fps=c["avi_rate"][0] / c["avi_rate"][1]) as writer:
            for f in clip_frames:
                writer.write(f)
        with AviReader(clip) as reader:
            payloads = [reader.payload(i) for i in range(len(reader))]
        fps = read_avi(clip).fps
        src = tmp / "frames"
        src.mkdir()
        blobs = list(payloads[:c["dir_from_avi"]])
        for fmt, (h, w), n in c["frames"]:
            for f in moving_frames(rng, n, (h, w), c["objects"], c["obj_px"]):
                rgb = np.ascontiguousarray(f[..., ::-1])
                blobs.append(encode_jpeg(rgb, 95) if fmt == "jpg" else encode_png(rgb))
        for i, blob in enumerate(blobs):
            (src / f"{i:02d}.{'png' if blob.startswith(PNG_SIGNATURE) else 'jpg'}").write_bytes(blob)
        val_yaml = write_mixed_val(tmp / "val", c["val_images"], c["imgsz"], c["val_nc"], c["seed"])
        shutil.copy(clip, keep / "clip.avi")
        shutil.copytree(src, keep / "frames")
        lap("inputs")

        # the weights: calibrated to detect, saved by YOLO.save with train_args imgsz 640 (no imgsz on the command line)
        det = YOLO(FLAGSHIP)
        bias = calibrated_weights(det, clip_frames[0], 0, c["cls_gain"], c["share_above_conf"], c["conf"], c["imgsz"])
        det.overrides["imgsz"] = c["imgsz"]
        npz = tmp / "flagship.npz"
        det.save(npz)
        geo = GeoConverter(**TRACK_CELL["geo"], image_width_px=c["avi_hw"][1], image_height_px=c["avi_hw"][0])
        runs = tmp / "runs"
        lap("weights")

        returned = []

        def keep_return(fn):
            def run(*a, **kw):
                returned.append(fn(*a, **kw))
                return returned[-1]
            return run

        def cli(args: str):
            """The command line on the flagship's npz; returns what the facade's mode returned."""
            modes = {m: getattr(YOLO, m) for m in ("predict", "track", "val")}
            for m, fn in modes.items():
                setattr(YOLO, m, keep_return(fn))
            try:
                entrypoint(f"dyt-torch {args} model={npz} project={runs} verbose=False")
            finally:
                for m, fn in modes.items():
                    setattr(YOLO, m, fn)
            return returned[-1]

        # (a)-(c) through the command line and run("clip.avi"), every NMS keep mask against the plain keep
        checks, kernel_keep, val_shapes = [], nms_ops.greedy_keep, []
        check_s = [0.0]

        def checked_keep(boxes, valid, iou_thres):
            keep = kernel_keep(boxes, valid, iou_thres)
            t0 = time.perf_counter()
            checks.append({"K": int(boxes.shape[1]), "B": int(boxes.shape[0]), "valid": int(valid.sum()),
                           "kept": int(keep.sum()), "equal": bool(torch.equal(keep, nms_ops.greedy_keep_reference(
                               boxes, valid, iou_thres)))})
            check_s[0] += time.perf_counter() - t0
            return keep

        preprocess = DetectionValidator.preprocess

        def recorded(self, batch):
            val_shapes[-1].append(tuple(batch["img"].shape[1:3]))
            return preprocess(self, batch)

        nms_ops.greedy_keep, DetectionValidator.preprocess = checked_keep, recorded
        cuda_nms.reset_counts()
        try:
            with host_seconds({"load_and_decode": (LoadImagesAndVideos, "__next__"),
                               "setup_model": (DetectionPredictor, "setup_model"),
                               "preprocess": (DetectionPredictor, "preprocess"),
                               "inference": (DetectionPredictor, "inference"),
                               "postprocess": (DetectionPredictor, "postprocess"),
                               "save_txt": (Results, "save_txt"), "save_crop": (Results, "save_crop")}) as spent:
                pred = cli(f"predict source={src} save_txt=True save_crop=True max_det={c['crop_max_det']} name=predict")
            cli_predict_parts = {**spent, "plain_keep_checks": check_s[0]}
            n_a = len(checks)
            lap("cli_predict")
            tracked = cli(f"track source={clip} name=track")
            lap("cli_track")
            STrack.reset_id()
            run_pipe = DroneVideoPipeline(YOLO(npz), None, geo, imgsz=c["imgsz"], conf=c["conf"])
            check_s[0] = 0.0
            t0 = time.perf_counter()
            run_out = run_pipe.run(str(clip), csv_path=tmp / "run.csv")
            run_s = time.perf_counter() - t0 - check_s[0]  # the run's own time, without the plain keeps beside it
            n_b = len(checks)
            lap("run_avi")
            val_shapes.append([])
            t0 = time.perf_counter()
            val_rect = cli(f"val data={val_yaml} batch={c['val_batch']} workers=4 name=val")
            val_rect_s = time.perf_counter() - t0
            val_shapes.append([])
            t0 = time.perf_counter()
            val_square = cli(f"val data={val_yaml} batch={c['val_batch']} workers=4 rect=False name=val_square")
            val_square_s = time.perf_counter() - t0
            lap("cli_val")
        finally:
            nms_ops.greedy_keep, DetectionValidator.preprocess = kernel_keep, preprocess
        nms_calls, nms_launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
        if not all(ch["equal"] for ch in checks) or not any(ch["valid"] > ch["kept"] > 0 for ch in checks):
            raise AssertionError(f"entry: {sum(not ch['equal'] for ch in checks)} of {len(checks)} keep masks differ from "
                                 "the plain keep, or no NMS call kept and suppressed")
        if nms_launches == 0 or nms_launches != 2 * nms_calls or nms_calls != len(checks):
            raise AssertionError(f"entry: {nms_calls} NMS calls ({nms_launches} launches) for {len(checks)} checked calls")
        n_images = len(blobs)
        labels = sorted(p.name for p in (runs / "predict" / "labels").iterdir())
        crops = sum(1 for _ in (runs / "predict" / "crops").rglob("*.jpg"))
        if len(pred) != n_images or labels != sorted(f"{i:02d}.txt" for i in range(n_images)) or not crops:
            raise AssertionError(f"entry: {len(pred)} results, label files {labels}, {crops} crops for {n_images} images")
        if len(tracked) != len(payloads) or not any(r.boxes is not None and r.boxes.is_track for r in tracked):
            raise AssertionError("entry: track over clip.avi gave no tracks")

        # the AVI run's CSV against step over the same frames decoded from the payloads
        t0 = time.perf_counter()
        decoded = [np.ascontiguousarray(decode_jpeg(p)[..., ::-1]) for p in payloads]
        avi_decode_ms = (time.perf_counter() - t0) / len(payloads) * 1e3
        STrack.reset_id()
        step_pipe = DroneVideoPipeline(YOLO(npz), None, geo, imgsz=c["imgsz"], conf=c["conf"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in decoded:
            step_pipe.step(f)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        step_pipe.export_csv(tmp / "step.csv", fps=fps)
        csv_equal = (tmp / "run.csv").read_bytes() == (tmp / "step.csv").read_bytes()
        if not csv_equal or run_out["frames"] != len(payloads) or run_out["fps"] != fps or not run_pipe.trajectories:
            raise AssertionError(f"entry: run('clip.avi') {run_out} differs from step over the decoded frames")
        lap("step_memory")

        # rect batch shapes: each batch at its planned shape, at most rect_max_shapes; square batches at imgsz
        data = check_det_dataset(val_yaml)
        plan = build_yolo_dataset(get_val_cfg(overrides=dict(imgsz=c["imgsz"], batch=c["val_batch"], rect=True)),
                                  data["val"], c["val_batch"], data, mode="val").batch_shapes
        max_shapes = get_val_cfg().rect_max_shapes
        if val_shapes[0] != [tuple(int(v) for v in s) for s in plan] or len(set(val_shapes[0])) > max_shapes or \
                set(val_shapes[1]) != {(c["imgsz"], c["imgsz"])}:
            raise AssertionError(f"entry: rect val shapes {val_shapes[0]} (plan {plan.tolist()}), square {val_shapes[1]}")
        for m in (val_rect, val_square):
            if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
                raise AssertionError(f"entry: val metrics {m}")

        # decode cost per frame (the Huffman lookups are built by now)
        def per_call_ms(fn, reps: int = 2) -> float:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) / reps * 1e3

        png_720 = next(p for p in sorted(src.iterdir()) if p.suffix == ".png").read_bytes()
        png_1080 = encode_png(np.ascontiguousarray(clip_frames[0][..., ::-1]))
        with AviReader(clip) as reader:
            avi_ms = per_call_ms(lambda: reader.frame(1))
        decode_ms = {"jpeg_1080p": avi_decode_ms, "avi_frame_1080p": avi_ms, "png_720p": per_call_ms(lambda: decode_png(png_720)),
                     "png_1080p": per_call_ms(lambda: decode_png(png_1080))}
        lap("decode")

        # predict img/s from the directory at batch 1 and 8 (decode included), on a facade that never tracks
        plain = YOLO(npz)
        pred_s = {}
        for b in (1, 8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain.predict(str(src), batch=b, verbose=False)
            torch.cuda.synchronize()
            pred_s[b] = time.perf_counter() - t0
        lap("predict_dir")
        return {"model": FLAGSHIP, "cell": c, "class_bias": bias, "nvidia_smi": smi,
                "inputs": {"frames": n_images, "avi_frames": len(payloads), "avi_fps": fps, "val_images": c["val_images"]},
                "nms_keep_checks": {"calls": len(checks), "all_equal_plain": True, "predict": n_a, "track_and_run": n_b - n_a,
                                    "val": len(checks) - n_b, "K": sorted({ch["K"] for ch in checks})},
                "nms_calls": nms_calls, "nms_launches": nms_launches,
                "label_files": len(labels), "crops": crops, "run_csv_equals_step_csv": csv_equal,
                "tracks": len(run_pipe.trajectories), "csv_rows": len((tmp / "run.csv").read_text().splitlines()) - 1,
                "rect_shapes": sorted(set(val_shapes[0])), "rect_max_shapes": max_shapes,
                "val_rect": val_rect, "val_square": val_square, "decode_ms": decode_ms,
                "run_fps_from_avi": len(payloads) / run_s, "step_fps_from_memory": len(decoded) / step_s,
                "val_img_per_s": {"rect": c["val_images"] / val_rect_s, "square": c["val_images"] / val_square_s},
                "predict_img_per_s_dir": {"batch1": n_images / pred_s[1], "batch8": n_images / pred_s[8]},
                "stage_s": stage_s, "cli_predict_host_s": cli_predict_parts,
                "save_crop_ms_per_crop": cli_predict_parts["save_crop"] / crops * 1e3}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_draw(smi: str, media: Path) -> dict:
    """Phase 13: save=True on the card: annotated images and MJPEG AVI written by the port's drawing and encoders,
    read back by the port's decoders; every greedy-NMS keep mask against the plain keep; plot, encode and predict
    frames/s with and without save."""
    import drone_yolo_tpu_torch.data.avi as avi_mod
    import drone_yolo_tpu_torch.engine.results as results_mod
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.data.avi import AviReader, read_avi
    from drone_yolo_tpu_torch.data.jpeg import decode_jpeg
    from drone_yolo_tpu_torch.data.png import encode_png
    from drone_yolo_tpu_torch.data.utils import imread
    from drone_yolo_tpu_torch.engine.results import Results
    from drone_yolo_tpu_torch.ops import cuda_nms
    from drone_yolo_tpu_torch.ops import nms as nms_ops

    c = DRAW_CELL
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_draw_"))
    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        checks.append(bool(torch.equal(keep, nms_ops.greedy_keep_reference(boxes, valid, iou_thres))))
        return keep

    def timed_predict(model, source, **kw):
        """(results, seconds, {name: host seconds}) of one predict, the host seconds spent in `Results.plot` and in
        each encoder."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with host_seconds({"plot": (Results, "plot"), "encode": (results_mod, "encode_jpeg"),
                           "encode_png": (results_mod, "encode_png"), "encode_avi": (avi_mod, "encode_jpeg")}) as spent:
            out = model.predict(source, verbose=False, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(spent)

    def per_frame_ms(spent: dict, n: int) -> dict:
        enc = spent.get("encode", 0.0) + spent.get("encode_png", 0.0) + spent.get("encode_avi", 0.0)
        return {"plot_ms_per_frame": spent.get("plot", 0.0) / n * 1e3, "encode_ms_per_frame": enc / n * 1e3}

    def read_back(folder: Path, names: list, shapes: list) -> None:
        """Every written image by its source's name, decoded by the port to its source's shape."""
        if sorted(p.name for p in folder.iterdir()) != sorted(names):
            raise AssertionError(f"draw: {folder.name} holds {sorted(p.name for p in folder.iterdir())}, not {names}")
        for n, shape in zip(names, shapes):
            if imread(str(folder / n)).shape != tuple(shape):
                raise AssertionError(f"draw: {folder / n} does not read back at {shape}")

    nms_ops.greedy_keep = checked_keep
    cuda_nms.reset_counts()
    try:
        runs = tmp / "runs"
        src = sorted((media / "frames").iterdir())
        clip = media / "clip.avi"
        info = read_avi(clip)
        with AviReader(clip) as reader:
            clip_frames = [reader.frame(i) for i in range(c["task_frames"])]
        det = YOLO(FLAGSHIP)
        bias = calibrated_weights(det, clip_frames[0], c["seed"], c["cls_gain"], c["share_above_conf"], c["conf"],
                                  c["imgsz"])
        args = dict(imgsz=c["imgsz"], conf=c["conf"], project=str(runs), exist_ok=True)
        dir_res, dir_s, dir_spent = timed_predict(det, str(media / "frames"), save=True, name="dir", **args)
        read_back(runs / "dir", [p.name for p in src], [r.orig_shape + (3,) for r in dir_res])
        png = next(i for i, p in enumerate(src) if p.suffix == ".png")
        if (runs / "dir" / src[png].name).read_bytes() != encode_png(np.ascontiguousarray(dir_res[png].plot()[..., ::-1])):
            raise AssertionError("draw: the written PNG is not the encoding of Results.plot()")
        avi_res, avi_s, avi_spent = timed_predict(det, str(clip), save=True, name="avi", **args)
        _, plain_s, _ = timed_predict(det, str(clip), save=False, name="avi_plain", **args)
        with AviReader(runs / "avi" / "clip.avi") as written:
            if len(written) != len(info.frames) or written.fps != info.fps or \
                    decode_jpeg(written.payload(0)).shape != (info.height, info.width, 3):
                raise AssertionError(f"draw: clip.avi written with {len(written)} frames at {written.fps} fps, source "
                                     f"{len(info.frames)} at {info.fps}")
        flagship = {"model": FLAGSHIP, "class_bias": bias, "images": len(src), "avi_frames": len(avi_res),
                    "boxes_per_frame": sum(len(r) for r in avi_res) / len(avi_res),
                    "dir": per_frame_ms(dir_spent, len(src)), "avi": per_frame_ms(avi_spent, len(avi_res)),
                    "avi_fps_save": len(avi_res) / avi_s, "avi_fps_no_save": len(avi_res) / plain_s,
                    "dir_img_per_s_save": len(src) / dir_s}
        tasks = {}
        for name, imgsz, share in c["tasks"]:
            if imgsz == 1024:
                rng = np.random.default_rng(c["seed"])
                frames = [rotated_rect_image(rng, 1024, (8, 40), (12, 160), 15)[0] for _ in range(c["task_frames"])]
            else:
                frames = clip_frames
            m = YOLO(name)
            tb = calibrated_weights(m, frames[0], c["seed"], c["cls_gain"], share, c["conf"], imgsz)
            targs = dict(imgsz=imgsz, conf=c["conf"], batch=len(frames), project=str(runs), exist_ok=True)
            res, save_s, spent = timed_predict(m, frames, save=True, name=name.split(".")[0], **targs)
            _, plain_task_s, _ = timed_predict(m, frames, save=False, name=name.split(".")[0] + "_plain", **targs)
            read_back(runs / name.split(".")[0], [f"image{i}.jpg" for i in range(len(frames))], [f.shape for f in frames])
            kind = "masks" if "seg" in name else "keypoints" if "pose" in name else "obb"
            if not any(len(r) and getattr(r, kind) is not None for r in res):
                raise AssertionError(f"draw: {name} drew no {kind} ({[len(r) for r in res]} instances, bias {tb})")
            tasks[name] = {"class_bias": tb, "share_above_conf": share, "imgsz": imgsz, "frames": len(frames),
                           "frame_hw": list(frames[0].shape[:2]), **per_frame_ms(spent, len(frames)),
                           "instances_per_frame": sum(len(r) for r in res) / len(res),
                           "fps_save": len(frames) / save_s, "fps_no_save": len(frames) / plain_task_s}
    finally:
        nms_ops.greedy_keep = kernel_keep
        shutil.rmtree(tmp, ignore_errors=True)
    nms_calls, nms_launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
    if not checks or not all(checks) or nms_launches != 2 * nms_calls or nms_calls != len(checks):
        raise AssertionError(f"draw: {checks.count(False)} of {len(checks)} keep masks differ from the plain keep; "
                             f"{nms_calls} NMS calls, {nms_launches} launches")
    return {"nvidia_smi": smi, "cell": c, "nms_keep_checks": {"calls": len(checks), "all_equal_plain": True},
            "nms_calls": nms_calls, "nms_launches": nms_launches, "flagship": flagship, "tasks": tasks}


def run_pose(smi: str) -> dict:
    """Phase 14: pose training and validation on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.cfg import get_val_cfg
    from drone_yolo_tpu_torch.data.build import build_yolo_dataset
    from drone_yolo_tpu_torch.data.utils import check_det_dataset
    from drone_yolo_tpu_torch.models.yolo.pose import PoseTrainer
    from drone_yolo_tpu_torch.nn.model import PoseModel
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops import nms as nms_ops
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats_reference
    from drone_yolo_tpu_torch.ops.conv_s2 import s2_bwd_reference

    c = POSE_CELL
    k3, k1 = cuda_s2bwd.NAMES[3], cuda_s2bwd.NAMES[1]

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        return {"s2_calls": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
                "nms_calls": cuda_nms.greedy_keep_cuda.calls,
                "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches,
                             "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                             **{n: cuda_s2bwd.s2_bwd_cuda.launches.get(n, 0) for n in (k3, k1)}}}

    # the kernels against their plain versions at the pose model's shapes
    probe = PoseModel(c["model"], nc=1)
    sites = s2_sites(probe, c["batch"], c["imgsz"])
    if [s["k"] for s in sites] != [3] * 7:
        raise AssertionError(f"{c['model']} should have 7 dense k=3 stride-2 sites, found {[s['name'] for s in sites]}")
    s2_checks = []
    for i, site in enumerate(sites):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, dy = s2_site_inputs(site, dtype, seed=300 + i)
            dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, site["need_dx"])
            dx_p, dw_p = s2_bwd_reference(x, w, dy, 3, site["need_dx"])
            name = str(dtype).split(".")[1]
            row = {"site": site["name"], "x": site["x"], "dtype": name}
            for what, got, want in [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else []):
                tol = dict(S2_TOL[name][what])
                tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"pose {site['name']} {name} {what}: {m}")
                row[f"{what}_err"] = float((got - want).abs().max())
            s2_checks.append(row)
            del x, w, dy, dx, dw, dx_p, dw_p
    bn = bn_sites(probe, c["batch"], c["imgsz"])
    bn_checks = []
    for i, site in enumerate(bn):
        for dtype in (torch.bfloat16, torch.float32):
            x = site_input(site["x"], dtype, seed=400 + i)
            s_k, q_k = cuda_bnstats.bn_stats_cuda(x)
            errs = bn_stats_errors(x, s_k, q_k)
            if not (errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1):
                raise AssertionError(f"pose BN statistics at {site['name']} {dtype}: kernel vs plain {errs}")
            bn_checks.append({"site": site["name"], "x": site["x"], "dtype": str(dtype).split(".")[1], **errs})
            del x, s_k, q_k
    c51 = [b for b in bn if b["x"][1] == 51]
    if len(c51) != 6:
        raise AssertionError(f"the keypoint branch should have 6 BN inputs of 51 channels, found {c51}")
    del probe

    # the two train kernels' times at the pose model's shapes: one bf16 train step's calls (7 stride-2, 63 BN), the
    # plain versions and the library calls on the same inputs, and the bound summed over the calls
    s2_in = [s2_site_inputs(site, torch.bfloat16, seed=500 + i) for i, site in enumerate(sites)]
    pairs = list(zip(sites, s2_in))
    s2_calls = {
        "": lambda: [cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, st["need_dx"]) for st, (x, w, dy) in pairs],
        "plain_": lambda: [s2_bwd_reference(x, w, dy, 3, st["need_dx"]) for st, (x, w, dy) in pairs],
        "library_": lambda: [torch.ops.aten.convolution_backward(dy, x, w, None, [2, 2], [1, 1], [1, 1], False, [0, 0], 1,
                                                                 [st["need_dx"], True, False]) for st, (x, w, dy) in pairs]}
    s2_time = {}
    for prefix, fn in s2_calls.items():
        s2_time.update(kernel_times(fn, reps=2 if prefix == "plain_" else 5, prefix=prefix))
    costs = [s2_cost(st) for st in sites]
    b_ms = [n_bytes / PEAK_BYTES_PER_S * 1e3 for n_bytes, _ in costs]
    o_ms = [n_ops / PEAK_BF16_PER_S * 1e3 for _, n_ops in costs]
    s2_time.update(bound_ms=sum(map(max, b_ms, o_ms)), bound_by="bytes" if sum(b_ms) >= sum(o_ms) else "operations",
                   calls=len(sites))
    del s2_in, pairs
    xs = [site_input(site["x"], torch.bfloat16, seed=600 + i) for i, site in enumerate(bn)]
    bn_time = {}
    for prefix, fn in {"": lambda: [cuda_bnstats.bn_stats_cuda(x) for x in xs],
                       "plain_": lambda: [bn_stats_reference(x) for x in xs],
                       "library_": lambda: [torch.batch_norm_stats(x, 1e-3) for x in xs]}.items():
        bn_time.update(kernel_times(fn, reps=5, prefix=prefix))
    b_ms = [(2 * x.numel() + 2 * 4 * x.shape[1]) / PEAK_BYTES_PER_S * 1e3 for x in xs]
    o_ms = [BN_OPS * x.numel() / PEAK_FP32_PER_S * 1e3 for x in xs]
    bn_time.update(bound_ms=sum(map(max, b_ms, o_ms)), bound_by="bytes" if sum(b_ms) >= sum(o_ms) else "operations",
                   calls=len(xs))
    del xs

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pose_"))
    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        checks.append({"K": int(boxes.shape[1]), "valid": int(valid.sum()), "kept": int(keep.sum()),
                       "equal": bool(torch.equal(keep, nms_ops.greedy_keep_reference(boxes, valid, iou_thres)))})
        return keep

    try:
        t0 = time.perf_counter()
        data = write_pose_dataset(tmp / "pose", c["n_train"], c["n_val"], c["imgsz"], c["seed"])
        write_s = time.perf_counter() - t0
        common = dict(data=str(data), imgsz=c["imgsz"], batch=c["batch"], nbs=c["batch"], optimizer="SGD", amp=True,
                      s2grad="cuda", bnstats="cuda", cache="ram", workers=c["workers"], project=str(tmp / "runs"),
                      exist_ok=True, plots=False)
        nms_ops.greedy_keep = checked_keep
        try:
            reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = YOLO(c["model"])
            metrics = model.train(name="train", epochs=c["epochs"], **common)
            train_wall = time.perf_counter() - t0
            train_counts = counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            tr = model.trainer
            n_val_checks = len(checks)
            reset()
            last = YOLO(tr.wdir / "last.npz")
            t0 = time.perf_counter()
            val_metrics = last.val(data=str(data))  # rect batches: the facade's default
            val_wall = time.perf_counter() - t0
            val_counts = counts()
            validator = last.validator
        finally:
            nms_ops.greedy_keep = kernel_keep
        n_bn, steps = len(bn), c["epochs"] * tr.nb
        want_s2 = {k3: steps * 7, k1: 0}
        if train_counts["s2_calls"] != want_s2 or train_counts["bn_calls"] != steps * n_bn:
            raise AssertionError(f"pose training: {train_counts}, expected stride-2 calls {want_s2} and "
                                 f"{steps * n_bn} BN calls for {steps} steps")
        val_batches = c["epochs"] * math.ceil(c["n_val"] / c["batch"]) + len(validator.dataloader)
        if len(checks) != val_batches or not all(ch["equal"] for ch in checks):
            raise AssertionError(f"pose validation: {len(checks)} NMS calls for {val_batches} batches; keep masks equal "
                                 f"to the plain keep: {[ch['equal'] for ch in checks]}")
        if any(ch["K"] != VAL["pre_nms_topk"] for ch in checks):
            raise AssertionError(f"pose validation NMS at K {[ch['K'] for ch in checks]}, expected {VAL['pre_nms_topk']}")
        if train_counts["nms_calls"] + val_counts["nms_calls"] != val_batches:
            raise AssertionError(f"pose NMS kernel calls {train_counts['nms_calls']} + {val_counts['nms_calls']}")
        losses = np.array([e["loss_items"] for e in tr.epoch_stats])
        if not (np.isfinite(losses).all() and losses.shape == (c["epochs"], 5)):
            raise AssertionError(f"pose loss items {losses}")
        header = (tr.save_dir / "results.csv").read_text().splitlines()[0].split(",")
        if not {"train/pose_loss", "train/kobj_loss"} <= set(header):
            raise AssertionError(f"results.csv columns {header}")
        for name, m in (("train", metrics), ("val", val_metrics)):
            if len(m) != 9 or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for k, v in m.items() if k != "fitness"):
                raise AssertionError(f"pose {name} metrics: {m}")

        # a fixed batch of the val split (letterboxed, no augmentation), `fixed_steps` steps at a constant lr
        info = check_det_dataset(data)
        ds = build_yolo_dataset(get_val_cfg(overrides=dict(imgsz=c["imgsz"], task="pose")), info["val"], c["batch"], info,
                                mode="val")
        batch = ds.collate([ds[i] for i in range(c["batch"])])
        reset()
        fixed = PoseTrainer(overrides=dict(model=c["model"], batch=c["batch"], imgsz=c["imgsz"], nbs=c["batch"],
                                           optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", warmup_epochs=0.0),
                            train_loader=[batch] * c["fixed_steps"], data={"nc": 1, "kpt_shape": [17, 3]})
        run = fixed.run_steps()
        fixed_counts = counts()
        pose_loss = [r["items"][1] for r in run]
        if not (np.isfinite([r["loss"] for r in run]).all() and pose_loss[-1] < pose_loss[0]):
            raise AssertionError(f"fixed-batch pose_loss did not fall: {pose_loss}")
        if fixed_counts["s2_calls"] != {k3: 7 * c["fixed_steps"], k1: 0} or fixed_counts["bn_calls"] != n_bn * c["fixed_steps"]:
            raise AssertionError(f"fixed-batch run: {fixed_counts}")
        step_ms = float(np.median([r["ms"] for r in run[1:]]))
        hyp = fixed._warmup_hyp(fixed.ni, 0)
        prof = profile_device(lambda: fixed.train_step(batch, *hyp)[0].item(), steps=3)
        launches = {k: train_counts["launches"][k] + val_counts["launches"][k] + fixed_counts["launches"][k]
                    for k in train_counts["launches"]}
        ep = tr.epoch_stats
        return {"model": c["model"], "cell": c, "nvidia_smi": smi, "dataset_write_s": write_s,
                "s2_sites": [s["name"] for s in sites], "s2_checks": s2_checks, "bn_sites": n_bn,
                "bn_c51_sites": [b["name"] for b in c51], "bn_checks": bn_checks, "s2_tolerances": S2_TOL,
                "bn_rtol": BN_RTOL, "bn_atol": BN_ATOL,
                "counts": {"train": train_counts, "val": val_counts, "fixed": fixed_counts, "launches": launches},
                "per_step": {"s2_calls": 7, "bn_calls": n_bn}, "nms_keep_checks": {"calls": len(checks),
                "during_training": n_val_checks, "all_equal_plain": True, "K": VAL["pre_nms_topk"]},
                "metrics_train": metrics, "metrics_val_rect": val_metrics,
                "rect_shapes": [list(map(int, s)) for s in validator.dataloader.dataset.batch_shapes],
                "results_csv_columns": header, "epochs": ep, "train_wall_s": train_wall, "plots": False,
                "epoch_s": [e["train_s"] for e in ep], "data_wait_share": sum(e["data_wait_s"] for e in ep) / sum(
                    e["train_s"] for e in ep), "train_img_per_s": sum(e["images"] for e in ep) / sum(e["train_s"] for e in ep),
                "val_s": [e["val_s"] for e in ep], "val_img_per_s": validator.seen / val_wall,
                "val_speed_ms_per_img": validator.speed, "peak_memory_gb": peak_gb,
                "fixed_batch": {"steps": c["fixed_steps"], "pose_loss_first": pose_loss[0], "pose_loss_last": pose_loss[-1],
                                "pose_loss": pose_loss, "step_ms_median": step_ms,
                                "img_per_s": c["batch"] / step_ms * 1e3, "first_step_ms": run[0]["ms"]},
                "profile_train_step": prof,
                "kernels_at_pose_shapes": {"per": f"one bf16 train step's calls at batch {c['batch']}, {c['imgsz']} px; "
                                                  "ms device time (torch.profiler), event_ms CUDA events; library: "
                                                  "cuDNN convolution_backward, torch.batch_norm_stats",
                                           k3: s2_time, "bn_stats": bn_time}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_segment(smi: str) -> dict:
    """Phase 15: instance segmentation on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.cfg import get_val_cfg
    from drone_yolo_tpu_torch.data.build import build_yolo_dataset
    from drone_yolo_tpu_torch.data.utils import check_det_dataset
    from drone_yolo_tpu_torch.models.yolo.segment import SegmentationTrainer
    from drone_yolo_tpu_torch.nn.model import SegmentationModel
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops import nms as nms_ops
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats_reference
    from drone_yolo_tpu_torch.ops.conv_s2 import s2_bwd_reference

    c = SEG_CELL
    k3, k1 = cuda_s2bwd.NAMES[3], cuda_s2bwd.NAMES[1]

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        return {"s2_calls": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
                "nms_calls": cuda_nms.greedy_keep_cuda.calls,
                "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches,
                             "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                             **{n: cuda_s2bwd.s2_bwd_cuda.launches.get(n, 0) for n in (k3, k1)}}}

    # the kernels against their plain versions at the segment model's shapes: the stride-2 backward at its 7 sites, the
    # BN statistics at the inputs the detect part does not have (Proto's 3, cv4's 6)
    probe = SegmentationModel(c["model"], nc=c["nc"])
    sites = s2_sites(probe, c["batch"], c["imgsz"])
    if [s["k"] for s in sites] != [3] * 7:
        raise AssertionError(f"{c['model']} should have 7 dense k=3 stride-2 sites, found {[s['name'] for s in sites]}")
    s2_checks = []
    for i, site in enumerate(sites):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, dy = s2_site_inputs(site, dtype, seed=700 + i)
            dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, site["need_dx"])
            dx_p, dw_p = s2_bwd_reference(x, w, dy, 3, site["need_dx"])
            name = str(dtype).split(".")[1]
            row = {"site": site["name"], "x": site["x"], "dtype": name}
            for what, got, want in [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else []):
                tol = dict(S2_TOL[name][what])
                tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"segment {site['name']} {name} {what}: {m}")
                row[f"{what}_err"] = float((got - want).abs().max())
            s2_checks.append(row)
            del x, w, dy, dx, dw, dx_p, dw_p
    bn = bn_sites(probe, c["batch"], c["imgsz"])
    seg_bn = [b for b in bn if ".proto." in b["name"] or ".cv4." in b["name"]]
    if len(bn) != 66 or len(seg_bn) != 9:
        raise AssertionError(f"{c['model']}: {len(bn)} BN inputs ({len(seg_bn)} in proto and cv4), expected 66 (9)")
    bn_checks = []
    for i, site in enumerate(seg_bn):
        for dtype in (torch.bfloat16, torch.float32):
            x = site_input(site["x"], dtype, seed=800 + i)
            s_k, q_k = cuda_bnstats.bn_stats_cuda(x)
            errs = bn_stats_errors(x, s_k, q_k)
            if not (errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1):
                raise AssertionError(f"segment BN statistics at {site['name']} {dtype}: kernel vs plain {errs}")
            bn_checks.append({"site": site["name"], "x": site["x"], "dtype": str(dtype).split(".")[1], **errs})
            del x, s_k, q_k
    del probe
    xs = [site_input(site["x"], torch.bfloat16, seed=900 + i) for i, site in enumerate(seg_bn)]
    bn_time = {}
    for prefix, fn in {"": lambda: [cuda_bnstats.bn_stats_cuda(x) for x in xs],
                       "plain_": lambda: [bn_stats_reference(x) for x in xs],
                       "library_": lambda: [torch.batch_norm_stats(x, 1e-3) for x in xs]}.items():
        bn_time.update(kernel_times(fn, reps=5, prefix=prefix))
    b_ms = [(2 * x.numel() + 2 * 4 * x.shape[1]) / PEAK_BYTES_PER_S * 1e3 for x in xs]
    o_ms = [BN_OPS * x.numel() / PEAK_FP32_PER_S * 1e3 for x in xs]
    bn_time.update(bound_ms=sum(map(max, b_ms, o_ms)), bound_by="bytes" if sum(b_ms) >= sum(o_ms) else "operations",
                   calls=len(xs), inputs=[s["x"] for s in seg_bn])
    del xs

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_segment_"))
    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        checks.append({"K": int(boxes.shape[1]), "valid": int(valid.sum()), "kept": int(keep.sum()),
                       "equal": bool(torch.equal(keep, nms_ops.greedy_keep_reference(boxes, valid, iou_thres)))})
        return keep

    try:
        t0 = time.perf_counter()
        data = write_seg_dataset(tmp / "seg", c["n_train"], c["n_val"], c["imgsz"], c["seed"], c["nc"])
        write_s = time.perf_counter() - t0
        nms_ops.greedy_keep = checked_keep
        try:
            # predict: 1080p frames at batch 1 and 8, weights calibrated so that some anchors score above conf
            frames = moving_frames(np.random.default_rng(c["seed"]), 8, c["frames_hw"], 40, size=(40, 200))
            pred_model = YOLO(c["model"])
            bias = calibrated_weights(pred_model, frames[0], c["seed"], c["cls_gain"], c["share_above_conf"], c["conf"],
                                      c["imgsz"])
            predict = {}
            reset()
            for b in (1, 8):
                pred_model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = pred_model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)
                wall = time.perf_counter() - t0
                n_masks = [0 if r.masks is None else len(r.masks) for r in res]
                shapes = {tuple(r.masks.data.shape[1:]) for r in res if r.masks is not None}
                if not sum(n_masks) or shapes != {c["frames_hw"]} or any(
                        len(r.boxes) != (0 if r.masks is None else len(r.masks)) for r in res):
                    raise AssertionError(f"segment predict at batch {b}: masks {n_masks} of shapes {shapes}")
                predict[f"batch{b}"] = {"img_per_s": b / wall, "masks_per_image": n_masks,
                                        "mask_shape": list(c["frames_hw"]), "speed_ms_per_img": res[0].speed}
            predict_counts = counts()
            predict_checks = list(checks)
            if any(ch["K"] != 1024 for ch in predict_checks) or not all(ch["equal"] for ch in predict_checks):
                raise AssertionError(f"segment predict NMS: {predict_checks}")
            del pred_model, res

            # one epoch from disk with both kernels, then rect val of last.npz
            checks.clear()
            reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = YOLO(c["model"])
            metrics = model.train(data=str(data), epochs=1, imgsz=c["imgsz"], batch=c["batch"], nbs=c["batch"],
                                  optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", cache="ram",
                                  workers=c["workers"], project=str(tmp / "runs"), name="train", exist_ok=True,
                                  plots=False)
            train_wall = time.perf_counter() - t0
            train_counts = counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            tr = model.trainer
            n_val_checks = len(checks)
            reset()
            last = YOLO(tr.wdir / "last.npz")
            t0 = time.perf_counter()
            val_metrics = last.val(data=str(data))  # rect batches: the facade's default
            val_wall = time.perf_counter() - t0
            val_counts = counts()
            validator = last.validator
        finally:
            nms_ops.greedy_keep = kernel_keep
        n_bn, steps = len(bn), tr.nb
        if train_counts["s2_calls"] != {k3: steps * 7, k1: 0} or train_counts["bn_calls"] != steps * n_bn:
            raise AssertionError(f"segment training: {train_counts}, expected {steps * 7} stride-2 and "
                                 f"{steps * n_bn} BN calls for {steps} steps")
        val_batches = math.ceil(c["n_val"] / c["batch"]) + len(validator.dataloader)
        if len(checks) != val_batches or not all(ch["equal"] for ch in checks) or any(
                ch["K"] != VAL["pre_nms_topk"] for ch in checks):
            raise AssertionError(f"segment validation NMS: {checks}, expected {val_batches} calls at K = 4096")
        if train_counts["nms_calls"] + val_counts["nms_calls"] != val_batches:
            raise AssertionError(f"segment NMS kernel calls {train_counts['nms_calls']} + {val_counts['nms_calls']}")
        losses = np.array([e["loss_items"] for e in tr.epoch_stats])
        if not (np.isfinite(losses).all() and losses.shape == (1, 4)):
            raise AssertionError(f"segment loss items {losses}")
        for name, m in (("train", metrics), ("val", val_metrics)):
            if len(m) != 9 or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for k, v in m.items() if k != "fitness"):
                raise AssertionError(f"segment {name} metrics: {m}")

        # a fixed batch of the val split (letterboxed, no augmentation), `fixed_steps` steps at a constant lr
        info = check_det_dataset(data)
        ds = build_yolo_dataset(get_val_cfg(overrides=dict(imgsz=c["imgsz"], task="segment")), info["val"], c["batch"],
                                info, mode="val")
        batch = ds.collate([ds[i] for i in range(c["batch"])])
        reset()
        fixed = SegmentationTrainer(overrides=dict(model=c["model"], batch=c["batch"], imgsz=c["imgsz"], nbs=c["batch"],
                                                   optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda",
                                                   warmup_epochs=0.0),
                                    train_loader=[batch] * c["fixed_steps"], data={"nc": c["nc"]})
        run = fixed.run_steps()
        fixed_counts = counts()
        seg_loss = [r["items"][1] for r in run]
        if not (np.isfinite([r["loss"] for r in run]).all() and seg_loss[-1] < seg_loss[0]):
            raise AssertionError(f"fixed-batch seg_loss did not fall: {seg_loss}")
        if (fixed_counts["s2_calls"] != {k3: 7 * c["fixed_steps"], k1: 0}
                or fixed_counts["bn_calls"] != n_bn * c["fixed_steps"]):
            raise AssertionError(f"fixed-batch run: {fixed_counts}")
        step_ms = float(np.median([r["ms"] for r in run[1:]]))
        hyp = fixed._warmup_hyp(fixed.ni, 0)
        prof = profile_device(lambda: fixed.train_step(batch, *hyp)[0].item(), steps=3)
        launches = {k: sum(cnt["launches"][k] for cnt in (predict_counts, train_counts, val_counts, fixed_counts))
                    for k in train_counts["launches"]}
        ep = tr.epoch_stats[0]
        return {"model": c["model"], "cell": {**c, "frames_hw": list(c["frames_hw"])}, "nvidia_smi": smi,
                "dataset_write_s": write_s, "predict": {**predict, "cls_bias": bias},
                "s2_sites": [s["name"] for s in sites],
                "s2_checks": s2_checks, "bn_sites": n_bn, "bn_checked_sites": [b["name"] for b in seg_bn],
                "bn_checks": bn_checks, "s2_tolerances": S2_TOL, "bn_rtol": BN_RTOL, "bn_atol": BN_ATOL,
                "counts": {"predict": predict_counts, "train": train_counts, "val": val_counts, "fixed": fixed_counts,
                           "launches": launches},
                "per_step": {"s2_calls": 7, "bn_calls": n_bn},
                "nms_keep_checks": {"predict": len(predict_checks), "val": len(checks), "during_training": n_val_checks,
                                    "all_equal_plain": True, "K": {"predict": 1024, "val": VAL["pre_nms_topk"]},
                                    "extra_columns": 32},
                "metrics_train": metrics, "metrics_val_rect": val_metrics,
                "rect_shapes": [list(map(int, s)) for s in validator.dataloader.dataset.batch_shapes],
                "epoch": ep, "train_wall_s": train_wall, "plots": False,
                "data_wait_share": ep["data_wait_s"] / ep["train_s"],
                "val_img_per_s": validator.seen / val_wall, "val_speed_ms_per_img": validator.speed,
                "peak_memory_gb": peak_gb,
                "fixed_batch": {"steps": c["fixed_steps"], "seg_loss_first": seg_loss[0], "seg_loss_last": seg_loss[-1],
                                "seg_loss": seg_loss, "step_ms_median": step_ms,
                                "img_per_s": c["batch"] / step_ms * 1e3, "first_step_ms": run[0]["ms"]},
                "profile_train_step": prof,
                "bn_at_segment_inputs": {"per": "the 9 BN inputs of proto and cv4 at batch 8, 640 px, bf16; ms device "
                                                "time (torch.profiler), event_ms CUDA events; library: "
                                                "torch.batch_norm_stats", **bn_time}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



def run_obb(smi: str) -> dict:
    """Phase 16: oriented boxes on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.cfg import get_val_cfg
    from drone_yolo_tpu_torch.data.build import build_yolo_dataset
    from drone_yolo_tpu_torch.data.utils import check_det_dataset
    from drone_yolo_tpu_torch.models.yolo.obb import OBBTrainer
    from drone_yolo_tpu_torch.nn.model import OBBModel
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats_reference
    from drone_yolo_tpu_torch.ops.conv_s2 import s2_bwd_reference

    c = OBB_CELL
    k3, k1 = cuda_s2bwd.NAMES[3], cuda_s2bwd.NAMES[1]

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        return {"s2_calls": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
                "nms_calls": cuda_nms.greedy_keep_cuda.calls,
                "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches,
                             "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                             **{n: cuda_s2bwd.s2_bwd_cuda.launches.get(n, 0) for n in (k3, k1)}}}

    # the two train kernels against their plain versions at yolov8s-obb's shapes (batch 8, 1024 px): the stride-2
    # backward at its 7 sites (layer 0's dw sums 2,097,152 products), the BN statistics at all 63 BN inputs
    probe = OBBModel(c["model"], nc=c["nc"])
    sites = s2_sites(probe, c["batch"], c["imgsz"])
    if [s["k"] for s in sites] != [3] * 7:
        raise AssertionError(f"{c['model']} should have 7 dense k=3 stride-2 sites, found {[s['name'] for s in sites]}")
    s2_checks = []
    for i, site in enumerate(sites):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, dy = s2_site_inputs(site, dtype, seed=1000 + i)
            dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, site["need_dx"])
            dx_p, dw_p = s2_bwd_reference(x, w, dy, 3, site["need_dx"])
            name = str(dtype).split(".")[1]
            row = {"site": site["name"], "x": site["x"], "dtype": name}
            for what, got, want in [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else []):
                tol = dict(S2_TOL[name][what])
                tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"obb {site['name']} {name} {what}: {m}")
                err = (got - want).abs()
                row[f"{what}_err"] = float(err.max())
                row[f"{what}_err_over_tol"] = float((err / (tol["atol"] + tol["rtol"] * want.abs())).max())
            s2_checks.append(row)
            del x, w, dy, dx, dw, dx_p, dw_p
    bn = bn_sites(probe, c["batch"], c["imgsz"])
    if len(bn) != 63 or sum(".cv4." in b["name"] for b in bn) != 6:
        raise AssertionError(f"{c['model']}: {len(bn)} BN inputs, expected 63 (6 in cv4)")
    bn_checks = []
    for i, site in enumerate(bn):
        for dtype in (torch.bfloat16, torch.float32):
            x = site_input(site["x"], dtype, seed=1100 + i)
            s_k, q_k = cuda_bnstats.bn_stats_cuda(x)
            errs = bn_stats_errors(x, s_k, q_k)
            if not (errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1):
                raise AssertionError(f"obb BN statistics at {site['name']} {dtype}: kernel vs plain {errs}")
            bn_checks.append({"site": site["name"], "x": site["x"], "dtype": str(dtype).split(".")[1], **errs})
            del x, s_k, q_k
    del probe

    # their times for one bf16 train step's calls (7 stride-2, 63 BN), the plain versions and the library calls on
    # the same inputs, and the bound summed over the calls
    s2_in = [s2_site_inputs(site, torch.bfloat16, seed=1200 + i) for i, site in enumerate(sites)]
    pairs = list(zip(sites, s2_in))
    s2_calls = {
        "": lambda: [cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, st["need_dx"]) for st, (x, w, dy) in pairs],
        "plain_": lambda: [s2_bwd_reference(x, w, dy, 3, st["need_dx"]) for st, (x, w, dy) in pairs],
        "library_": lambda: [torch.ops.aten.convolution_backward(dy, x, w, None, [2, 2], [1, 1], [1, 1], False, [0, 0], 1,
                                                                 [st["need_dx"], True, False]) for st, (x, w, dy) in pairs]}
    s2_time = {}
    for prefix, fn in s2_calls.items():
        s2_time.update(kernel_times(fn, reps=2 if prefix == "plain_" else 5, prefix=prefix))
    costs = [s2_cost(st) for st in sites]
    b_ms = [n_bytes / PEAK_BYTES_PER_S * 1e3 for n_bytes, _ in costs]
    o_ms = [n_ops / PEAK_BF16_PER_S * 1e3 for _, n_ops in costs]
    s2_time.update(bound_ms=sum(map(max, b_ms, o_ms)), bound_by="bytes" if sum(b_ms) >= sum(o_ms) else "operations",
                   calls=len(sites), sites=[{"site": st["name"], "x": st["x"], "bound_ms": max(bm, om)}
                                             for st, bm, om in zip(sites, b_ms, o_ms)])
    del s2_in, pairs
    xs = [site_input(site["x"], torch.bfloat16, seed=1300 + i) for i, site in enumerate(bn)]
    bn_time = {}
    for prefix, fn in {"": lambda: [cuda_bnstats.bn_stats_cuda(x) for x in xs],
                       "plain_": lambda: [bn_stats_reference(x) for x in xs],
                       "library_": lambda: [torch.batch_norm_stats(x, 1e-3) for x in xs]}.items():
        bn_time.update(kernel_times(fn, reps=5, prefix=prefix))
    b_ms = [(2 * x.numel() + 2 * 4 * x.shape[1]) / PEAK_BYTES_PER_S * 1e3 for x in xs]
    o_ms = [BN_OPS * x.numel() / PEAK_FP32_PER_S * 1e3 for x in xs]
    bn_time.update(bound_ms=sum(map(max, b_ms, o_ms)), bound_by="bytes" if sum(b_ms) >= sum(o_ms) else "operations",
                   calls=len(xs), largest_input=list(max((s["x"] for s in bn), key=lambda t: int(np.prod(t)))))
    del xs

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_obb_"))
    try:
        t0 = time.perf_counter()
        data = write_obb_dataset(tmp / "obb", c["n_train"], c["n_val"], c["imgsz"], c["seed"], c["nc"], c["objects"],
                                 c["obj_px"])
        write_s = time.perf_counter() - t0

        # predict: 1024x1024 frames at batch 1 and 8, weights calibrated so that some anchors score above conf
        rng = np.random.default_rng(c["seed"] + 1)
        frames = [rotated_rect_image(rng, c["imgsz"], c["objects"], c["obj_px"], c["nc"])[0] for _ in range(c["frames"])]
        pred_model = YOLO(c["model"])
        bias = calibrated_weights(pred_model, frames[0], c["seed"], c["cls_gain"], c["share_above_conf"], c["conf"],
                                  c["imgsz"])
        predict = {}
        reset()
        torch.cuda.reset_peak_memory_stats()
        for b in (1, 8):
            pred_model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pred_model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)
            wall = time.perf_counter() - t0
            n_obb = [len(r.obb) for r in res]
            data_ok = all(np.isfinite(r.obb.data).all() and (r.obb.data[:, 2:4] >= 0).all()
                          and (r.obb.conf > c["conf"]).all() and r.boxes is None for r in res)
            if not sum(n_obb) or not data_ok or any(r.obb.xyxyxyxy.shape != (len(r.obb), 4, 2) for r in res):
                raise AssertionError(f"obb predict at batch {b}: {n_obb} oriented boxes, finite and valid {data_ok}")
            predict[f"batch{b}"] = {"img_per_s": b / wall, "obb_per_image": n_obb, "speed_ms_per_img": res[0].speed}
        predict_counts = counts()
        predict["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del pred_model, res

        # one epoch from disk with both kernels, then rect val of last.npz
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = YOLO(c["model"])
        metrics = model.train(data=str(data), epochs=1, imgsz=c["imgsz"], batch=c["batch"], nbs=c["batch"],
                              optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", cache="ram",
                              workers=c["workers"], project=str(tmp / "runs"), name="train", exist_ok=True,
                              plots=False)
        train_wall = time.perf_counter() - t0
        train_counts = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tr = model.trainer
        reset()
        last = YOLO(tr.wdir / "last.npz")
        t0 = time.perf_counter()
        val_metrics = last.val(data=str(data))  # rect batches: the facade's default
        val_wall = time.perf_counter() - t0
        val_counts = counts()
        validator = last.validator
        n_bn, steps = len(bn), tr.nb
        if train_counts["s2_calls"] != {k3: steps * 7, k1: 0} or train_counts["bn_calls"] != steps * n_bn:
            raise AssertionError(f"obb training: {train_counts}, expected {steps * 7} stride-2 and "
                                 f"{steps * n_bn} BN calls for {steps} steps")
        if any(cnt["nms_calls"] for cnt in (predict_counts, train_counts, val_counts)):
            raise AssertionError("the obb path suppresses by probiou in plain tensor operations, not the greedy-NMS "
                                 f"kernel: {predict_counts}, {train_counts}, {val_counts}")
        losses = np.array([e["loss_items"] for e in tr.epoch_stats])
        if not (np.isfinite(losses).all() and losses.shape == (1, 3)):
            raise AssertionError(f"obb loss items {losses}")
        for name, m in (("train", metrics), ("val", val_metrics)):
            if len(m) != 5 or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for k, v in m.items() if k != "fitness"):
                raise AssertionError(f"obb {name} metrics: {m}")

        # a fixed batch of the val split (letterboxed, no augmentation), `fixed_steps` steps at a constant lr
        info = check_det_dataset(data)
        ds = build_yolo_dataset(get_val_cfg(overrides=dict(imgsz=c["imgsz"], task="obb")), info["val"], c["batch"],
                                info, mode="val")
        batch = ds.collate([ds[i] for i in range(c["batch"])])
        reset()
        fixed = OBBTrainer(overrides=dict(model=c["model"], batch=c["batch"], imgsz=c["imgsz"], nbs=c["batch"],
                                          optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", warmup_epochs=0.0),
                           train_loader=[batch] * c["fixed_steps"], data={"nc": c["nc"]})
        run = fixed.run_steps()
        fixed_counts = counts()
        box_loss = [r["items"][0] for r in run]
        if not (np.isfinite([r["loss"] for r in run]).all() and box_loss[-1] < box_loss[0]):
            raise AssertionError(f"fixed-batch box_loss did not fall: {box_loss}")
        if (fixed_counts["s2_calls"] != {k3: 7 * c["fixed_steps"], k1: 0}
                or fixed_counts["bn_calls"] != n_bn * c["fixed_steps"]):
            raise AssertionError(f"fixed-batch run: {fixed_counts}")
        step_ms = float(np.median([r["ms"] for r in run[1:]]))
        hyp = fixed._warmup_hyp(fixed.ni, 0)
        prof = profile_device(lambda: fixed.train_step(batch, *hyp)[0].item(), steps=3)
        launches = {k: sum(cnt["launches"][k] for cnt in (predict_counts, train_counts, val_counts, fixed_counts))
                    for k in train_counts["launches"]}
        ep = tr.epoch_stats[0]
        return {"model": c["model"], "cell": c, "nvidia_smi": smi, "dataset_write_s": write_s,
                "predict": {**predict, "cls_bias": bias}, "s2_sites": [s["name"] for s in sites],
                "s2_checks": s2_checks, "bn_sites": n_bn, "bn_checks_worst": {
                    k: max(ch[k] for ch in bn_checks) for k in ("sum_err_over_tol", "sumsq_err_over_tol")},
                "bn_cv4_checks": [ch for ch in bn_checks if ".cv4." in ch["site"]],
                "s2_tolerances": S2_TOL, "s2_sum_floor": S2_SUM_FLOOR, "bn_rtol": BN_RTOL, "bn_atol": BN_ATOL,
                "counts": {"predict": predict_counts, "train": train_counts, "val": val_counts, "fixed": fixed_counts,
                           "launches": launches},
                "per_step": {"s2_calls": 7, "bn_calls": n_bn, "nms_calls": 0},
                "metrics_train": metrics, "metrics_val_rect": val_metrics,
                "rect_shapes": [list(map(int, s)) for s in validator.dataloader.dataset.batch_shapes],
                "epoch": ep, "train_wall_s": train_wall, "plots": False,
                "data_wait_share": ep["data_wait_s"] / ep["train_s"],
                "val_img_per_s": validator.seen / val_wall, "val_speed_ms_per_img": validator.speed,
                "peak_memory_gb": peak_gb,
                "fixed_batch": {"steps": c["fixed_steps"], "box_loss_first": box_loss[0], "box_loss_last": box_loss[-1],
                                "box_loss": box_loss, "step_ms_median": step_ms,
                                "img_per_s": c["batch"] / step_ms * 1e3, "first_step_ms": run[0]["ms"]},
                "profile_train_step": prof,
                "s2_at_obb_sites": {"per": "one bf16 train step's 7 calls at batch 8, 1024 px; ms device time "
                                           "(torch.profiler), event_ms CUDA events; library: cuDNN convolution_backward",
                                    **s2_time},
                "bn_at_obb_inputs": {"per": "one bf16 train step's 63 calls at batch 8, 1024 px; ms device time "
                                            "(torch.profiler), event_ms CUDA events; library: torch.batch_norm_stats",
                                     **bn_time}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

def run_families(smi: str) -> dict:
    """Phase 17: the YOLO11 and YOLO12 families on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.models.yolo import TASK_MAP
    from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, guess_model_task
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops import nms as nms_ops

    c = FAMILY_CELL
    k3, k1 = cuda_s2bwd.NAMES[3], cuda_s2bwd.NAMES[1]

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        return {"s2_calls": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
                "nms_calls": cuda_nms.greedy_keep_cuda.calls,
                "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches,
                             "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                             **{n: cuda_s2bwd.s2_bwd_cuda.launches.get(n, 0) for n in (k3, k1)}}}

    launches = defaultdict(int)

    def add_launches(cnt: dict) -> None:
        for k, v in cnt["launches"].items():
            launches[k] += v

    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        checks.append({"K": int(boxes.shape[1]), "valid": int(valid.sum()), "kept": int(keep.sum()),
                       "equal": bool(torch.equal(keep, nms_ops.greedy_keep_reference(boxes, valid, iou_thres)))})
        return keep

    def fixed_run(trainer_cls, name: str, batch: dict, data: dict, steps: int, s2grad, bnstats, imgsz: int) -> tuple:
        trainer = trainer_cls(overrides=dict(model=name, batch=c["batch"], imgsz=imgsz, nbs=c["batch"], optimizer="SGD",
                                             amp=True, s2grad=s2grad, bnstats=bnstats, warmup_epochs=0.0),
                              train_loader=[batch] * steps, data=data)
        reset()
        run = trainer.run_steps()
        cnt = counts()
        add_launches(cnt)
        return trainer, run, cnt

    out = {"cell": {k: v for k, v in c.items()}, "nvidia_smi": smi, "models": {}, "tasks": {}, "stage_s": {}}
    t_stage = [time.perf_counter()]

    def lap(name: str) -> None:
        """Seconds since the last lap, kept under `name` in `stage_s`."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["stage_s"][name] = now - t_stage[0]
        t_stage[0] = now

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_families_"))
    try:
        t0 = time.perf_counter()
        data, round_trip = write_dense_dataset(tmp / "dense", c["n_train"], c["n_val"], c["imgsz"], seed=c["seed"],
                                               nc=c["data_nc"], obj_px=c["obj_px"])
        out["dataset_write_s"] = time.perf_counter() - t0
        out["jpeg_round_trip"] = round_trip
        rng = np.random.default_rng(c["seed"])
        frames = moving_frames(rng, c["frames"], FRAME_HW, 60)
        lap("inputs")
        nms_ops.greedy_keep = checked_keep
        try:
            for mi, name in enumerate(c["models"]):
                stem = Path(name).stem
                row = train_kernel_checks(TASK2MODELCLASS[guess_model_task(name)](name, nc=c["nc"]), c["batch"],
                                          c["imgsz"], seed=5000 + 1000 * mi, timed_sites=mi == 0)
                if ([st[0].split(".")[1] for st in row["s2_sites"]] != FAMILY_S2_LAYERS[name]
                        or any(st[1] != 3 for st in row["s2_sites"])):
                    raise AssertionError(f"{name}: stride-2 sites {row['s2_sites']}")
                n_bn = row["bn_inputs"]
                lap(f"{stem}.kernels")

                # predict at batch 1 and 8 with calibrated weights, every keep mask held against the plain keep
                model = YOLO(name)
                bias = calibrated_weights(model, frames[0], c["seed"], c["cls_gain"], c["share_above_conf"], c["conf"],
                                          c["imgsz"])
                n_checks = len(checks)
                reset()
                predict = {"cls_bias": bias}
                for b in (1, 8):
                    model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)  # warm-up
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)
                    wall = time.perf_counter() - t0
                    n_det = [len(r.boxes) for r in res]
                    if not sum(n_det) or not all(np.isfinite(r.boxes.data).all() for r in res):
                        raise AssertionError(f"{name} predict at batch {b}: {n_det} detections, or not finite")
                    predict[f"batch{b}"] = {"img_per_s": b / wall, "n_det": n_det, "speed_ms_per_img": res[0].speed}
                predict_counts = counts()
                add_launches(predict_counts)
                if predict_counts["nms_calls"] != 4 or len(checks) - n_checks != 4:
                    raise AssertionError(f"{name} predict: {predict_counts['nms_calls']} NMS kernel calls, "
                                         f"{len(checks) - n_checks} checked, expected 4 (2 calls at batch 1 and 8)")

                # the float32 forward on the card against the CPU, weights spread so that activations stay O(1)
                f32 = copy.deepcopy(model.model)
                f32.load_state_dict(spread_weights(f32.state_dict(), np.random.default_rng(1)))
                with torch.inference_mode():
                    f32 = f32.fuse().float()
                    x1 = model.predictor.preprocess(frames[:1]).float()
                    preds_card = f32(x1)[0].cpu()
                    preds_cpu = f32.cpu()(x1.cpu())[0]
                del f32
                box_err = float((preds_card[..., :4] - preds_cpu[..., :4]).abs().max())
                score_rel_err = float(((preds_card[..., 4:] - preds_cpu[..., 4:]).abs() / preds_cpu[..., 4:]).max())
                if not (box_err <= BOX_ATOL_PX and score_rel_err <= SCORE_RTOL):
                    raise AssertionError(f"{name} float32 card vs CPU: box err {box_err} px, score rel err {score_rel_err}")
                del model, res
                lap(f"{stem}.predict_and_fp32")

                # 30 fixed-batch steps with both kernels and 30 stock from the same init
                batch = synthetic_batch(np.random.default_rng(c["seed"] + mi), c["batch"], c["imgsz"], c["nc"])
                runs = {}
                for mode, (s2grad, bnstats) in (("both", ("cuda", "cuda")), ("stock", (None, None))):
                    torch.cuda.reset_peak_memory_stats()
                    trainer, run, cnt = fixed_run(TASK_MAP["detect"]["trainer"], name, batch, {"nc": c["nc"]},
                                                  c["fixed_steps"], s2grad, bnstats, c["imgsz"])
                    want = ({k3: 7 * c["fixed_steps"], k1: 0}, n_bn * c["fixed_steps"]) if s2grad else ({k3: 0, k1: 0}, 0)
                    if (cnt["s2_calls"], cnt["bn_calls"]) != want:
                        raise AssertionError(f"{name} {mode} run: {cnt}, expected stride-2 and BN calls {want}")
                    loss = [r["loss"] for r in run]
                    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
                        raise AssertionError(f"{name} {mode} run: the fixed-batch loss did not fall: {loss}")
                    ms = float(np.median([r["ms"] for r in run[1:]]))
                    runs[mode] = {"loss": loss, "step_ms_median": ms, "img_per_s": c["batch"] / ms * 1e3,
                                  "first_step_ms": run[0]["ms"], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                                  "counts": cnt}
                    if mode == "both":
                        hyp = trainer._warmup_hyp(trainer.ni, 0)
                        runs[mode]["profile"] = profile_device(lambda: trainer.train_step(batch, *hyp)[0].item(), steps=3)
                    del trainer
                early = min(3, c["fixed_steps"])  # bf16 runs part at a constant lr: yolo12s's 5th losses differed 4%
                if not np.allclose(runs["both"]["loss"][:early], runs["stock"]["loss"][:early], rtol=TRAIN_LOSS_RTOL):
                    raise AssertionError(f"{name}: the first {early} losses with both kernels {runs['both']['loss'][:early]}"
                                         f" against stock {runs['stock']['loss'][:early]}")
                lap(f"{stem}.fixed_batch")

                # one epoch from disk with both kernels, then rect val of last.npz
                n_checks = len(checks)
                reset()
                t0 = time.perf_counter()
                model = YOLO(name)
                metrics = model.train(data=str(data), epochs=1, imgsz=c["imgsz"], batch=c["batch"], nbs=c["batch"],
                                      optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", cache="ram",
                                      workers=c["workers"], project=str(tmp / "runs"), name=stem, exist_ok=True,
                                      plots=False)
                train_wall = time.perf_counter() - t0
                train_counts = counts()
                add_launches(train_counts)
                tr = model.trainer
                reset()
                last = YOLO(tr.wdir / "last.npz")
                t0 = time.perf_counter()
                val_metrics = last.val(data=str(data))  # rect batches: the facade's default
                val_wall = time.perf_counter() - t0
                val_counts = counts()
                add_launches(val_counts)
                validator = last.validator
                steps = tr.nb
                if train_counts["s2_calls"] != {k3: 7 * steps, k1: 0} or train_counts["bn_calls"] != n_bn * steps:
                    raise AssertionError(f"{name} epoch: {train_counts}, expected {7 * steps} stride-2 and "
                                         f"{n_bn * steps} BN calls for {steps} steps")
                val_batches = math.ceil(c["n_val"] / c["batch"]) + len(validator.dataloader)
                epoch_checks = checks[n_checks:]
                if len(epoch_checks) != val_batches or train_counts["nms_calls"] + val_counts["nms_calls"] != val_batches:
                    raise AssertionError(f"{name}: {len(epoch_checks)} NMS calls checked, kernel calls "
                                         f"{train_counts['nms_calls']} + {val_counts['nms_calls']}, for {val_batches} "
                                         "val batches")
                for what, m in (("train", metrics), ("val", val_metrics)):
                    if len(m) != 5 or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
                        raise AssertionError(f"{name} {what} metrics: {m}")
                ep = tr.epoch_stats[0]
                if not np.isfinite(ep["loss_items"]).all():
                    raise AssertionError(f"{name} epoch loss items {ep['loss_items']}")
                out["models"][name] = {
                    **row, "predict": predict, "fp32_card_vs_cpu": {"box_err_px": box_err, "score_rel_err": score_rel_err,
                                                                    "box_atol_px": BOX_ATOL_PX, "score_rtol": SCORE_RTOL},
                    "fixed_batch": runs, "epoch": ep, "epoch_s": ep["train_s"], "train_wall_s": train_wall,
                    "plots": False,
                    "data_wait_share": ep["data_wait_s"] / ep["train_s"], "metrics_train": metrics,
                    "metrics_val_rect": val_metrics, "val_img_per_s": validator.seen / val_wall,
                    "rect_shapes": [list(map(int, s)) for s in validator.dataloader.dataset.batch_shapes],
                    "counts": {"predict": predict_counts, "train": train_counts, "val": val_counts},
                    "per_step": {"s2_calls": 7, "bn_calls": n_bn}}
                del model, last, tr, validator
                lap(f"{stem}.epoch_and_val")

            # the task heads: predict at batch 8, 5 fixed-batch steps with both kernels, the loss falling
            for ti, (name, imgsz) in enumerate(c["tasks"]):
                task = guess_model_task(name)
                trng = np.random.default_rng(c["seed"] + 10 + ti)
                if task == "obb":
                    tframes = [rotated_rect_image(trng, imgsz, (8, 40), (12, 160), 15)[0] for _ in range(c["batch"])]
                    tbatch, tdata = synthetic_obb_batch(trng, c["batch"], imgsz, 15), {"nc": 15}
                elif task == "pose":
                    tframes = frames
                    tbatch, tdata = synthetic_pose_batch(trng, c["batch"], imgsz, 1, 17), {"nc": 1, "kpt_shape": [17, 3]}
                else:
                    tframes = frames
                    tbatch, tdata = synthetic_seg_batch(trng, c["batch"], imgsz, c["nc"]), {"nc": c["nc"]}
                model = YOLO(name)
                bias = calibrated_weights(model, tframes[0], c["seed"], c["cls_gain"], 0.02, c["conf"], imgsz)
                n_checks = len(checks)
                reset()
                model.predict(tframes, imgsz=imgsz, conf=c["conf"], batch=c["batch"], verbose=False)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = model.predict(tframes, imgsz=imgsz, conf=c["conf"], batch=c["batch"], verbose=False)
                wall = time.perf_counter() - t0
                pcnt = counts()
                add_launches(pcnt)
                if task == "obb":
                    n_det = [len(r.obb) for r in res]
                    ok = all(np.isfinite(r.obb.data).all() for r in res) and pcnt["nms_calls"] == 0
                else:
                    n_det = [len(r.boxes) for r in res]
                    ok = all(np.isfinite(r.boxes.data).all() for r in res) and pcnt["nms_calls"] == 2
                    ok &= len(checks) - n_checks == 2
                    if task == "pose":
                        ok &= all(r.keypoints.data.shape == (len(r.boxes), 17, 3) for r in res)
                    else:
                        ok &= all(r.masks is None or r.masks.data.shape[0] == len(r.boxes) for r in res)
                if not (sum(n_det) and ok):
                    raise AssertionError(f"{name} predict at batch 8: {n_det} detections, checks {ok}, counts {pcnt}")
                del model, res
                n_bn = len(bn_sites(TASK2MODELCLASS[task](name, **({"nc": 15} if task == "obb" else {})), c["batch"], imgsz))
                _, run, cnt = fixed_run(TASK_MAP[task]["trainer"], name, tbatch, tdata, c["task_steps"], "cuda", "cuda",
                                        imgsz)
                loss = [r["loss"] for r in run]
                if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
                    raise AssertionError(f"{name}: the loss did not fall over {c['task_steps']} steps: {loss}")
                if cnt["s2_calls"] != {k3: 7 * c["task_steps"], k1: 0} or cnt["bn_calls"] != n_bn * c["task_steps"]:
                    raise AssertionError(f"{name} steps: {cnt}, expected 7 stride-2 and {n_bn} BN calls a step")
                out["tasks"][name] = {"imgsz": imgsz, "predict_batch8_img_per_s": c["batch"] / wall, "n_det": n_det,
                                      "cls_bias": bias, "loss": loss, "items": [r["items"] for r in run],
                                      "step_ms_median": float(np.median([r["ms"] for r in run[1:]])),
                                      "bn_inputs": n_bn, "counts": {"predict": pcnt, "steps": cnt}}
                lap(Path(name).stem)
        finally:
            nms_ops.greedy_keep = kernel_keep
        if not all(ch["equal"] for ch in checks):
            raise AssertionError(f"families: keep masks unequal to the plain keep: {[ch for ch in checks if not ch['equal']]}")
        out["nms_keep_checks"] = {"calls": len(checks), "all_equal_plain": True, "K": sorted({ch["K"] for ch in checks})}
        out["launches"] = dict(launches)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def s2_kind_times(sites: list[dict], seed: int, timed_sites: bool = True) -> dict:
    """The bf16 stride-2 backward calls of one step at `sites` (`s2_sites`), by kind: the kernel's device time against
    the plain version's and cuDNN's `convolution_backward`, and the bound (bytes over the memory rate or operations
    over the bf16 rate, site by site); with `timed_sites` each site alone against cuDNN there."""
    from drone_yolo_tpu_torch.ops import cuda_s2bwd
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS, s2_bwd_reference

    s2_time = {}
    for kind in sorted({s["k"] for s in sites}, reverse=True):
        p = KINDS[kind]
        kind_sites = [s for s in sites if s["k"] == kind]
        pairs = [(st, s2_site_inputs(st, torch.bfloat16, seed=seed + 300 + i)) for i, st in enumerate(kind_sites)]
        t = {}
        for prefix, fn in {
                "": lambda: [cuda_s2bwd.s2_bwd_cuda(x, w, dy, kind, st["need_dx"]) for st, (x, w, dy) in pairs],
                "plain_": lambda: [s2_bwd_reference(x, w, dy, kind, st["need_dx"]) for st, (x, w, dy) in pairs],
                "library_": lambda: [torch.ops.aten.convolution_backward(dy, x, w, None, [2, 2], [p, p], [1, 1], False,
                                                                         [0, 0], 1, [st["need_dx"], True, False])
                                     for st, (x, w, dy) in pairs]}.items():
            t.update(kernel_times(fn, reps=2 if prefix == "plain_" else 5, prefix=prefix))
        t["sites"] = []
        for st, (x, w, dy) in pairs if timed_sites else ():  # each site alone: the kernel against cuDNN there
            n_bytes, n_ops = s2_cost(st)
            row = {"site": st["name"], "x": st["x"], "w": st["w"], "need_dx": st["need_dx"],
                   "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3, "ops_ms": n_ops / PEAK_BF16_PER_S * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row.update(kernel_times(lambda x=x, w=w, dy=dy, nd=st["need_dx"]: cuda_s2bwd.s2_bwd_cuda(x, w, dy, kind, nd),
                                    reps=10, site=True))
            row.update(kernel_times(lambda x=x, w=w, dy=dy, nd=st["need_dx"]: torch.ops.aten.convolution_backward(
                dy, x, w, None, [2, 2], [p, p], [1, 1], False, [0, 0], 1, [nd, True, False]), reps=10,
                prefix="library_", site=True))
            row.update(vs_library=row["ms"] / row["library_ms"], bound_share=row["bound_ms"] / row["ms"])
            t["sites"].append(row)
        costs = [s2_cost(st) for st in kind_sites]
        b_ms = [n_bytes / PEAK_BYTES_PER_S * 1e3 for n_bytes, _ in costs]
        o_ms = [n_ops / PEAK_BF16_PER_S * 1e3 for _, n_ops in costs]
        t.update(bound_ms=sum(map(max, b_ms, o_ms)), bytes_ms=sum(b_ms), calls=len(kind_sites),
                 bound_by="bytes" if sum(b_ms) >= sum(o_ms) else "operations")
        s2_time[cuda_s2bwd.NAMES[kind]] = t
        del pairs
    return s2_time


def kernel_site_checks(name: str, sites: list[dict], bn: list[dict], seed: int, seen: set | None = None) -> dict:
    """Both train kernels against their plain versions, in bf16 and float32, at the stride-2 `sites` (`s2_sites`:
    dx and dw under S2_TOL, widened by S2_SUM_FLOOR of the largest entry) and the BN inputs `bn` (`bn_sites`: within
    BN_RTOL/BN_ATOL). A shape in `seen` was checked already at another site of the same shape and is skipped; the
    shapes checked here are added to it. `name` (a model's) is for the messages."""
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_s2bwd
    from drone_yolo_tpu_torch.ops.conv_s2 import s2_bwd_reference

    seen = set() if seen is None else seen
    s2_checks = []
    for i, site in enumerate(sites):
        key = ("s2", site["k"], site["x"], site["w"], site["need_dx"])
        if key in seen:
            continue
        seen.add(key)
        for dtype in (torch.bfloat16, torch.float32):
            x, w, dy = s2_site_inputs(site, dtype, seed=seed + i)
            dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, site["k"], site["need_dx"])
            dx_p, dw_p = s2_bwd_reference(x, w, dy, site["k"], site["need_dx"])
            dname = str(dtype).split(".")[1]
            row = {"site": site["name"], "k": site["k"], "x": site["x"], "w": site["w"], "dtype": dname}
            for what, got, want in [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else []):
                tol = dict(S2_TOL[dname][what])
                tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name} {site['name']} {dname} {what}: {m}")
                err = (got - want).abs()
                row[f"{what}_err"] = float(err.max())
                row[f"{what}_err_over_tol"] = float((err / (tol["atol"] + tol["rtol"] * want.abs())).max())
            s2_checks.append(row)
            del x, w, dy, dx, dw, dx_p, dw_p
    bn_worst = {"inputs_checked": 0, "sum_err_over_tol": 0.0, "sumsq_err_over_tol": 0.0, "max_abs_err": 0.0}
    for i, site in enumerate(bn):
        if ("bn", site["x"]) in seen:
            continue
        seen.add(("bn", site["x"]))
        bn_worst["inputs_checked"] += 1
        for dtype in (torch.bfloat16, torch.float32):
            x = site_input(site["x"], dtype, seed=seed + 100 + i)
            s_k, q_k = cuda_bnstats.bn_stats_cuda(x)
            errs = bn_stats_errors(x, s_k, q_k)
            if not (errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1):
                raise AssertionError(f"{name} BN statistics at {site['name']} {dtype}: kernel vs plain {errs}")
            for k in ("sum_err_over_tol", "sumsq_err_over_tol"):
                bn_worst[k] = max(bn_worst[k], errs[k])
            bn_worst["max_abs_err"] = max(bn_worst["max_abs_err"], errs["sum_err"], errs["sumsq_err"])
            del x, s_k, q_k
    return {"s2_checks": s2_checks, "bn_checks_worst": bn_worst}


def train_kernel_checks(probe, batch: int, imgsz: int, seed: int, timed_sites: bool = True,
                        seen: set | None = None) -> dict:
    """Both train kernels against their plain versions at `probe`'s stride-2 sites and train-mode BN inputs (a
    (batch, 3, imgsz, imgsz) input, bf16 and float32; `kernel_site_checks`, `seen` its shapes checked already); then
    each kind's bf16 calls of a step timed against the plain version and the library call (cuDNN's
    `convolution_backward`, `torch.batch_norm_stats`), and with `timed_sites` each stride-2 site alone against cuDNN
    there."""
    from drone_yolo_tpu_torch.ops import cuda_bnstats
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats_reference

    name = Path(str(probe.yaml.get("yaml_file", "model"))).name
    sites, bn = s2_sites(probe, batch, imgsz), bn_sites(probe, batch, imgsz)
    checks = kernel_site_checks(name, sites, bn, seed, seen)
    s2_time = s2_kind_times(sites, seed, timed_sites=timed_sites)
    xs = [site_input(site["x"], torch.bfloat16, seed=seed + 400 + i) for i, site in enumerate(bn)]
    bn_time = {}
    for prefix, fn in {"": lambda: [cuda_bnstats.bn_stats_cuda(x) for x in xs],
                       "plain_": lambda: [bn_stats_reference(x) for x in xs],
                       "library_": lambda: [torch.batch_norm_stats(x, 1e-3) for x in xs]}.items():
        bn_time.update(kernel_times(fn, reps=5, prefix=prefix))
    b_ms = [(2 * x.numel() + 2 * 4 * x.shape[1]) / PEAK_BYTES_PER_S * 1e3 for x in xs]
    o_ms = [BN_OPS * x.numel() / PEAK_FP32_PER_S * 1e3 for x in xs]
    bn_time.update(bound_ms=sum(map(max, b_ms, o_ms)), bound_by="bytes" if sum(b_ms) >= sum(o_ms) else "operations",
                   calls=len(xs), largest_input=max((x.shape for x in xs), key=lambda sh: sh[1]))
    del xs
    return {"s2_sites": [(s["name"], s["k"], s["x"], s["w"][0]) for s in sites], **checks, "bn_inputs": len(bn),
            "s2_time": s2_time, "bn_time": bn_time}


def float64_grad_errors(base, batch: dict) -> dict:
    """A detection model's loss and gradients on the card from `base`'s weights and `batch` (`synthetic_batch`): one
    float32 backward (TF32 as the caller set it) with both train kernels, one stock, and one stock in float64. Each
    run's largest error over the parameters (each tensor's max|g - g64| / max|g64|; tensors whose float64 gradient
    stays below 1e-6 of the largest are left aside), the losses, and each run's kernel calls. Through deep stacks two
    float32 runs part by their sums' order alone, so the kernels' run is held to stock's distance from float64
    (`kernels_within_stock`: within 2x stock's plus 1e-6), not to stock's run."""
    from drone_yolo_tpu_torch.nn import modules as M
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_s2bwd
    from drone_yolo_tpu_torch.utils.loss import v8DetectionLoss

    calls = {}

    def grads(who, mode, dtype):
        m = copy.deepcopy(base).to("cuda", dtype).train().set_s2grad(mode).set_bnstats(mode)
        img = torch.from_numpy(batch["img"].transpose(0, 3, 1, 2).copy()).to("cuda", dtype) / 255.0
        tgt = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items() if k != "img"}
        tgt = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tgt.items()}
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        with M.collect_bn_stats():
            maps = m(img)
        loss = v8DetectionLoss(m)(maps, tgt)[0]
        loss.backward()
        calls[who] = {"s2": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn": cuda_bnstats.bn_stats_cuda.calls}
        return float(loss.detach()), {n: p.grad.double() for n, p in m.named_parameters()}

    (l64, g64), (lk, gk), (ls, gs) = (grads("float64", None, torch.float64), grads("kernels", "cuda", torch.float32),
                                      grads("stock", None, torch.float32))
    cuda_s2bwd.reset_counts()  # the comparison's launches are not the path's
    cuda_bnstats.reset_counts()
    top = max(float(g.abs().max()) for g in g64.values())
    live = [n for n, g in g64.items() if float(g.abs().max()) > 1e-6 * top]
    err = {who: max(float((g[n] - g64[n]).abs().max() / g64[n].abs().max()) for n in live)
           for who, g in (("kernels", gk), ("stock", gs))}
    return {"loss": {"float64": l64, "kernels": lk, "stock": ls}, "max_rel_err_vs_float64": err, "calls": calls,
            "kernels_within_stock": err["kernels"] <= 2 * err["stock"] + 1e-6}


def run_classify(smi: str) -> dict:
    """Phase 18: classification on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.models.yolo.classify import ClassificationTrainer
    from drone_yolo_tpu_torch.nn.model import ClassificationModel
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS

    c = CLASSIFY_CELL
    names = {k: cuda_s2bwd.NAMES[k] for k in KINDS}

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        return {"s2_calls": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
                "nms_calls": cuda_nms.greedy_keep_cuda.calls,
                "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches,
                             "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                             **{n: cuda_s2bwd.s2_bwd_cuda.launches.get(n, 0) for n in names.values()}}}

    launches = defaultdict(int)

    def add_launches(cnt: dict) -> None:
        for k, v in cnt["launches"].items():
            launches[k] += v

    def want_s2(name: str, steps: int) -> dict:
        n3, n1 = CLASSIFY_S2[name]
        return {names[3]: n3 * steps, names[1]: n1 * steps}

    def train_kernels(name: str, seed: int) -> dict:
        row = train_kernel_checks(ClassificationModel(name), c["batch"], c["imgsz"], seed)
        if tuple(sum(st[1] == k for st in row["s2_sites"]) for k in (3, 1)) != CLASSIFY_S2[name]:
            raise AssertionError(f"{name}: stride-2 sites {row['s2_sites']}, expected {CLASSIFY_S2[name]} (k=3, k=1)")
        return row

    def calibrated(name: str, seed: int):
        model = YOLO(name)
        model.ensure_variables(imgsz=c["imgsz"], seed=0)
        model.model.load_state_dict(classifier_weights(model.model.state_dict(), np.random.default_rng(seed),
                                                       c["linear_gain"]))
        return model

    def predict_at(model, frames, b: int) -> dict:
        model.predict(frames[:b], imgsz=c["imgsz"], batch=b, verbose=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model.predict(frames, imgsz=c["imgsz"], batch=b, verbose=False)
        wall = time.perf_counter() - t0
        nc = model.model.nc
        if len(res) != len(frames) or not all(r.probs.data.shape == (nc,) and np.isfinite(r.probs.data).all()
                                              and abs(float(r.probs.data.sum()) - 1) < 1e-3 for r in res):
            raise AssertionError(f"{model.model_name} predict at batch {b}: probabilities not finite or not summing to 1")
        return {"img_per_s": len(frames) / wall, "speed_ms_per_img": res[-1].speed,
                "top1": [r.probs.top1 for r in res[:8]], "top1conf": [r.probs.top1conf for r in res[:8]]}

    def fixed_run(name: str, batch: dict, nc: int, steps: int, s2grad, bnstats) -> tuple:
        trainer = ClassificationTrainer(overrides=dict(model=name, batch=c["batch"], imgsz=c["imgsz"], nbs=c["batch"],
                                                       optimizer="SGD", amp=True, s2grad=s2grad, bnstats=bnstats,
                                                       warmup_epochs=0.0), train_loader=[batch] * steps, data={"nc": nc})
        reset()
        run = trainer.run_steps()
        cnt = counts()
        add_launches(cnt)
        return trainer, run, cnt

    out = {"cell": {k: v for k, v in c.items()}, "nvidia_smi": smi, "models": {}, "stage_s": {}}
    t_stage = [time.perf_counter()]

    def lap(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["stage_s"][name] = now - t_stage[0]
        t_stage[0] = now

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_classify_"))
    try:
        rng = np.random.default_rng(c["seed"])
        frames = moving_frames(rng, c["frames"], FRAME_HW, 60)
        t0 = time.perf_counter()
        folder = write_cls_folder(tmp / "imagenet10", c["n_train"], c["n_val"], c["seed"])
        out["dataset_write_s"] = time.perf_counter() - t0
        lap("inputs")

        # yolov8s-cls: the kernels at its sites, predict, card against CPU, fixed batch, an epoch from disk, val
        name = c["model"]
        row = train_kernels(name, seed=8000)
        n_bn = row["bn_inputs"]
        lap("kernels")
        model = calibrated(name, c["seed"])
        nc = model.model.nc
        reset()
        predict = {f"batch{b}": predict_at(model, frames, b) for b in (1, c["predict_batch"])}
        predict_counts = counts()
        if predict_counts["nms_calls"] or predict_counts["s2_calls"] != want_s2(name, 0):
            raise AssertionError(f"{name} predict: kernel calls {predict_counts}, expected none")
        cpu = YOLO(name, device="cpu")
        cpu.model.load_state_dict(model.model.state_dict())
        cpu.initialized = True
        few = frames[:c["cpu_frames"]]
        card_res = model.predict(few, imgsz=c["imgsz"], batch=len(few), verbose=False)
        x_card = model.predictor.preprocess(few).cpu()
        cpu_res = cpu.predict(few, imgsz=c["imgsz"], batch=len(few), verbose=False)
        # the resized uint8 pixels equal (CUDA divides by a scalar as a product with its reciprocal: 1 ulp of /255)
        if not torch.equal((x_card * 255).round(), (cpu.predictor.preprocess(few) * 255).round()):
            raise AssertionError(f"{name}: the predictor's input on the card differs from the CPU's")
        p_card = np.stack([r.probs.data for r in card_res])
        p_cpu = np.stack([r.probs.data for r in cpu_res])
        prob_err = np.abs(p_card - p_cpu)
        prob_err_over_tol = float((prob_err / (CLS_PROB_ATOL + CLS_PROB_RTOL * p_cpu)).max())
        top1_equal = [r.probs.top1 for r in card_res] == [r.probs.top1 for r in cpu_res]
        if not (top1_equal and prob_err_over_tol <= 1):
            raise AssertionError(f"{name} float32 card vs CPU: top-1 equal {top1_equal}, probability error over "
                                 f"tolerance {prob_err_over_tol}")
        card_vs_cpu = {"frames": len(few), "top1_equal": top1_equal, "top1": [r.probs.top1 for r in card_res],
                       "top1conf": [r.probs.top1conf for r in card_res], "max_abs_err": float(prob_err.max()),
                       "err_over_tol": prob_err_over_tol, "rtol": CLS_PROB_RTOL, "atol": CLS_PROB_ATOL}
        del model, cpu, card_res, cpu_res
        lap("predict_and_fp32")

        batch = synthetic_cls_batch(np.random.default_rng(c["seed"]), c["batch"], c["imgsz"], nc)
        runs = {}
        for mode, (s2grad, bnstats) in (("both", ("cuda", "cuda")), ("stock", (None, None))):
            torch.cuda.reset_peak_memory_stats()
            trainer, run, cnt = fixed_run(name, batch, nc, c["fixed_steps"], s2grad, bnstats)
            want = ((want_s2(name, c["fixed_steps"]), n_bn * c["fixed_steps"]) if s2grad
                    else (want_s2(name, 0), 0))
            if (cnt["s2_calls"], cnt["bn_calls"]) != want:
                raise AssertionError(f"{name} {mode} run: {cnt}, expected stride-2 and BN calls {want}")
            if cnt["nms_calls"] or (s2grad and cuda_s2bwd.s2_bwd_cuda.impl_calls["mma.sync"] != cnt["s2_calls"]):
                raise AssertionError(f"{name} {mode} run: {cnt}, impl calls {cuda_s2bwd.s2_bwd_cuda.impl_calls}")
            loss = [r["loss"] for r in run]
            if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
                raise AssertionError(f"{name} {mode} run: the fixed-batch loss did not fall: {loss}")
            ms = float(np.median([r["ms"] for r in run[1:]]))
            runs[mode] = {"loss": loss, "step_ms_median": ms, "img_per_s": c["batch"] / ms * 1e3,
                          "first_step_ms": run[0]["ms"], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "counts": cnt}
            if mode == "both":
                hyp = trainer._warmup_hyp(trainer.ni, 0)
                runs[mode]["profile"] = profile_device(lambda: trainer.train_step(batch, *hyp)[0].item(), steps=3)
            del trainer
        if not np.allclose(runs["both"]["loss"][:3], runs["stock"]["loss"][:3], rtol=TRAIN_LOSS_RTOL):
            raise AssertionError(f"{name}: the first 3 losses with both kernels {runs['both']['loss'][:3]} against "
                                 f"stock {runs['stock']['loss'][:3]}")
        lap("fixed_batch")

        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = YOLO(name)
        metrics = model.train(data=str(folder), epochs=1, imgsz=c["imgsz"], batch=c["epoch_batch"], nbs=c["epoch_batch"],
                              optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", workers=c["workers"],
                              project=str(tmp / "runs"), name="train", exist_ok=True, plots=False)
        train_wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        train_counts = counts()
        add_launches(train_counts)
        tr = model.trainer
        reset()
        last = YOLO(tr.wdir / "last.npz")
        t0 = time.perf_counter()
        val_metrics = last.val(data=str(folder), batch=c["epoch_batch"], workers=c["workers"])
        val_wall = time.perf_counter() - t0
        val_counts = counts()
        add_launches(val_counts)
        steps = tr.nb
        n_train = c["n_train"] * len(IMAGENET_WNIDS)
        if steps != n_train // c["epoch_batch"] or tr.model.nc != len(IMAGENET_WNIDS):
            raise AssertionError(f"{name} epoch: {steps} steps, nc {tr.model.nc}")
        if train_counts["s2_calls"] != want_s2(name, steps) or train_counts["bn_calls"] != n_bn * steps:
            raise AssertionError(f"{name} epoch: {train_counts}, expected {want_s2(name, steps)} stride-2 and "
                                 f"{n_bn * steps} BN calls for {steps} steps")
        if train_counts["nms_calls"] or val_counts["nms_calls"] or val_counts["bn_calls"]:
            raise AssertionError(f"{name}: kernel calls in validation {train_counts}, {val_counts}")
        for what, m in (("train", metrics), ("val", val_metrics)):
            if set(m) != {"metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"} or not all(
                    math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
                raise AssertionError(f"{name} {what} metrics: {m}")
        if last.validator.seen != c["n_val"] * len(IMAGENET_WNIDS):
            raise AssertionError(f"{name} val saw {last.validator.seen} images")
        ep = tr.epoch_stats[0]
        if not np.isfinite(ep["loss_items"]).all():
            raise AssertionError(f"{name} epoch loss items {ep['loss_items']}")
        out["models"][name] = {
            **row, "nc": nc, "predict": predict, "fp32_card_vs_cpu": card_vs_cpu, "fixed_batch": runs,
            "epoch": ep, "epoch_s": ep["train_s"], "train_wall_s": train_wall, "data_wait_share": ep["data_wait_s"] / ep["train_s"],
            "metrics_train": metrics, "metrics_val": val_metrics, "val_img_per_s": last.validator.seen / val_wall,
            "val_speed_ms_per_img": last.validator.speed, "peak_memory_gb": peak_gb,
            "counts": {"predict": predict_counts, "train": train_counts, "val": val_counts},
            "per_step": {"s2_calls": want_s2(name, 1), "bn_calls": n_bn}}
        del model, last, tr
        lap("epoch_and_val")

        # the other classifiers: the kernels at their sites, predict at batch 32, 3 steps with the kernels and stock
        for mi, name in enumerate(c["others"]):
            stem = Path(name).stem
            row = train_kernels(name, seed=9000 + 1000 * mi)
            n_bn = row["bn_inputs"]
            model = calibrated(name, c["seed"] + mi)
            nc = model.model.nc
            reset()
            pred = predict_at(model, frames[:c["predict_batch"]], c["predict_batch"])
            pcnt = counts()
            if pcnt["nms_calls"] or pcnt["s2_calls"] != want_s2(name, 0):
                raise AssertionError(f"{name} predict: kernel calls {pcnt}")
            del model
            batch = synthetic_cls_batch(np.random.default_rng(c["seed"] + mi), c["batch"], c["imgsz"], nc)
            steps = {}
            for mode, kern in (("both", "cuda"), ("stock", None)):
                _, run, cnt = fixed_run(name, batch, nc, c["other_steps"], kern, kern)
                want = ((want_s2(name, c["other_steps"]), n_bn * c["other_steps"]) if kern else (want_s2(name, 0), 0))
                if (cnt["s2_calls"], cnt["bn_calls"]) != want or cnt["nms_calls"]:
                    raise AssertionError(f"{name} {mode} steps: {cnt}, expected stride-2 and BN calls {want}")
                steps[mode] = {"loss": [r["loss"] for r in run], "step_ms_median": float(np.median([r["ms"] for r in run[1:]])),
                               "counts": cnt}
            if not (np.isfinite(steps["both"]["loss"]).all()
                    and np.allclose(steps["both"]["loss"], steps["stock"]["loss"], rtol=TRAIN_LOSS_RTOL)):
                raise AssertionError(f"{name}: losses with both kernels {steps['both']['loss']} against stock "
                                     f"{steps['stock']['loss']}")
            out["models"][name] = {**row, "nc": nc, "predict_batch32": pred, "fixed_batch": steps,
                                   "per_step": {"s2_calls": want_s2(name, 1), "bn_calls": n_bn}}
            lap(stem)
        out["launches"] = dict(launches)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_zoo(smi: str) -> dict:
    """Phase 19: the v3, v5, v6, P6, Ghost and YOLOv9 yamls on the card (see the module docstring), its checks and its
    numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.models.yolo import TASK_MAP
    from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, guess_model_task
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops import nms as nms_ops

    c = ZOO_CELL
    k3, k1 = cuda_s2bwd.NAMES[3], cuda_s2bwd.NAMES[1]
    launches = defaultdict(int)

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        cnt = {"s2_calls": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
               "nms_calls": cuda_nms.greedy_keep_cuda.calls,
               "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches,
                            "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                            **{n: cuda_s2bwd.s2_bwd_cuda.launches.get(n, 0) for n in (k3, k1)}}}
        for k, v in cnt["launches"].items():
            launches[k] += v
        return cnt

    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        checks.append({"K": int(boxes.shape[1]), "equal": bool(torch.equal(keep, nms_ops.greedy_keep_reference(
            boxes, valid, iou_thres)))})
        return keep

    def data_for(task: str, rng, imgsz: int) -> tuple[dict, dict]:
        if task == "pose":
            return synthetic_pose_batch(rng, c["batch"], imgsz, 1, 17), {"nc": 1, "kpt_shape": [17, 3]}
        if task == "segment":
            return synthetic_seg_batch(rng, c["batch"], imgsz, c["nc"]), {"nc": c["nc"]}
        return synthetic_batch(rng, c["batch"], imgsz, c["nc"]), {"nc": c["nc"]}

    def fixed_steps(name: str, task: str, imgsz: int, steps: int, per_step: tuple, seed: int, main: bool) -> dict:
        """`steps` bf16 steps on one batch with both kernels at lr 0.01 (for the main model as many stock too, and a
        profiled step): the counts exact, the losses finite, and over runs of 5 steps or more falling below the
        first. The losses are readings, not a comparison: two bf16 runs part at the first step (yolov9c-seg's first
        losses 343.58 and 355.19, the BN sums' order alone, against 349.10 in float32), and two float32 runs a step
        or two later, as TAL's assignments and max pools follow the last digits (`grad_checks` compares)."""
        batch, data = data_for(task, np.random.default_rng(seed), imgsz)
        runs = {}
        for mode, kern in (("both", "cuda"), *((("stock", None),) if main else ())):
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            trainer = TASK_MAP[task]["trainer"](
                overrides=dict(model=name, batch=c["batch"], imgsz=imgsz, nbs=c["batch"], optimizer="SGD", lr0=0.01,
                               amp=True, s2grad=kern, bnstats=kern, warmup_epochs=0.0), train_loader=[batch] * steps,
                data=data)
            reset()
            run = trainer.run_steps()
            cnt = counts()
            n_k3, n_k1, n_bn = per_step if kern else (0, 0, 0)
            if (cnt["s2_calls"], cnt["bn_calls"], cnt["nms_calls"]) != ({k3: steps * n_k3, k1: steps * n_k1},
                                                                         steps * n_bn, 0):
                raise AssertionError(f"{name} {mode} steps: {cnt}, expected {per_step} stride-2 (k=3, k=1) and BN "
                                     "calls a step")
            ms = float(np.median([r["ms"] for r in run[1:] or run]))  # one step: its own time, plans included
            runs[mode] = {"loss": [r["loss"] for r in run], "step_ms_median": ms, "img_per_s": c["batch"] / ms * 1e3,
                          "first_step_ms": run[0]["ms"], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "counts": cnt, "build_and_steps_s": time.perf_counter() - t0}
            if main and kern:
                t0 = time.perf_counter()
                hyp = trainer._warmup_hyp(trainer.ni, 0)
                reset()
                runs[mode]["profile"] = profile_device(lambda: trainer.train_step(batch, *hyp)[0].item(), steps=1)
                counts()  # the profiled step's launches
                runs[mode]["profile"]["s"] = time.perf_counter() - t0
            del trainer
        losses = {mode: r["loss"] for mode, r in runs.items()}
        if not all(np.isfinite(loss).all() for loss in losses.values()):
            raise AssertionError(f"{name}: fixed-batch losses {losses}")
        if steps >= 5 and not all(min(loss[1:]) < loss[0] for loss in losses.values()):
            raise AssertionError(f"{name}: the fixed-batch loss did not fall: {losses}")
        return runs

    def grad_checks(name: str, model, imgsz: int, seed: int) -> dict:
        """`float64_grad_errors` of a copy of the detection model `model` (the predict facade's, unfused) drawn anew
        from `seed` for `imgsz`, on one batch of 2 at `imgsz`, float32 with TF32 off: the first losses within
        TRAIN_LOSS_RTOL, the kernels' run within 2x stock's distance from float64. (Not on the predict weights: their
        class logits, spread for conf 0.25, make a loss of ~2e5 whose float32 gradients part from float64 by more.)"""
        base = copy.deepcopy(model)
        base.init(seed, imgsz=imgsz)
        out = float64_grad_errors(base, synthetic_batch(np.random.default_rng(seed), 2, imgsz, c["nc"]))
        if not (math.isclose(out["loss"]["kernels"], out["loss"]["stock"], rel_tol=TRAIN_LOSS_RTOL)
                and out["kernels_within_stock"]):
            raise AssertionError(f"{name}: float32 gradients with both kernels and stock against float64: {out}")
        reset()
        return out

    def predict(name: str, task: str, imgsz: int, frames: list, batches: tuple, seed: int, calibrate: bool) -> tuple:
        """Predict at each batch size (a warm-up, then the timed call): with `calibrate` the scores of
        `calibrated_weights` at conf 0.25, else the random init at conf 0 (every candidate valid, K = 1024) keeping 32
        detections an image."""
        model, conf, out, max_det = YOLO(name), 0.0, {}, 32
        if calibrate:
            share = c["share_above_conf"] if task == "detect" else c["task_share_above_conf"]
            conf, max_det = c["conf"], 300
            out["cls_bias"] = calibrated_weights(model, frames[0], seed, c["cls_gain"], share, conf, imgsz)
        n_checks = len(checks)
        reset()
        for b in batches:
            model.predict(frames[:b], imgsz=imgsz, conf=conf, batch=b, max_det=max_det, verbose=False)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = model.predict(frames[:b], imgsz=imgsz, conf=conf, batch=b, max_det=max_det, verbose=False)
            wall = time.perf_counter() - t0
            n_det = [len(r.boxes) for r in res]
            ok = sum(n_det) and all(np.isfinite(r.boxes.data).all() for r in res)
            if task == "pose":
                ok = ok and all(r.keypoints.data.shape == (len(r.boxes), 17, 3) for r in res)
            elif task == "segment":
                ok = ok and all(r.masks is None or r.masks.data.shape[0] == len(r.boxes) for r in res)
            if not ok:
                raise AssertionError(f"{name} predict at batch {b}: {n_det} detections, or not finite")
            out[f"batch{b}"] = {"img_per_s": b / wall, "n_det": n_det, "speed_ms_per_img": res[0].speed}
        cnt = counts()
        if cnt["nms_calls"] != 2 * len(batches) or len(checks) - n_checks != 2 * len(batches):
            raise AssertionError(f"{name} predict: {cnt['nms_calls']} NMS kernel calls, {len(checks) - n_checks} "
                                 f"checked, expected one a batch ({2 * len(batches)})")
        out["counts"] = cnt
        return model, out

    def fp32_checks(model, frame: np.ndarray) -> dict:
        """The float32 forward (TF32 off, `spread_weights`) on the card against the CPU's, and fused against unfused on
        the card, on one letterboxed frame: boxes within BOX_ATOL_PX, scores within SCORE_RTOL."""
        net = copy.deepcopy(model.model)
        net.load_state_dict(spread_weights(net.state_dict(), np.random.default_rng(1)))
        out = {"box_atol_px": BOX_ATOL_PX, "score_rtol": SCORE_RTOL}
        with torch.inference_mode():
            net = net.float()
            x = model.predictor.preprocess([frame]).float()
            unfused = net(x)[0][..., :4 + net.nc]
            fused = net.fuse()(x)[0][..., :4 + net.nc]
            cpu = net.cpu()(x.cpu())[0][..., :4 + net.nc]
        for what, a, b in (("card_vs_cpu", fused.cpu(), cpu), ("fused_vs_unfused", fused, unfused)):
            box = float((a[..., :4] - b[..., :4]).abs().max())
            score = float(((a[..., 4:] - b[..., 4:]).abs() / b[..., 4:]).max())
            if not (box <= BOX_ATOL_PX and score <= SCORE_RTOL):
                raise AssertionError(f"float32 {what}: box err {box} px, score rel err {score}")
            out[what] = {"box_err_px": box, "score_rel_err": score}
        return out

    out = {"cell": dict(c), "nvidia_smi": smi, "models": {}, "stage_s": {}}
    t_stage = [time.perf_counter()]

    def lap(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["stage_s"][name] = now - t_stage[0]
        t_stage[0] = now
        print(f"zoo: {name} {out['stage_s'][name]:.2f} s", file=sys.stderr, flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_zoo_"))
    frames = {hw: moving_frames(np.random.default_rng(c["seed"] + i), c["frames"], hw, 60)
              for i, hw in enumerate(sorted({FRAME_HW, *(m[2] for m in c["checked"])}))}
    nms_ops.greedy_keep = checked_keep
    # the epoch's JPEGs are encoded in a process of their own while the models before the epoch run
    writer = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        dense = writer.submit(write_dense_dataset, tmp / "dense", c["n_train"], c["n_val"], c["main"][1],
                              c["seed"], c["data_nc"], c["obj_px"])
        lap("inputs")
        plan = [(*c["main"], True, True)] + [(*m, True, False) for m in c["checked"]] + \
               [(name, imgsz, FRAME_HW, (c["batch"],), c["other_steps"], False, False) for name, imgsz in c["others"]]
        seen = set()  # the site shapes whose kernels were checked already: each shape once across the zoo
        for mi, (name, imgsz, hw, batches, steps, checked, main) in enumerate(plan):
            task, stem = guess_model_task(name), Path(name).stem
            with torch.device("meta"):  # the sites' shapes only
                probe = TASK2MODELCLASS[task](name, nc=1 if task == "pose" else c["nc"])
            sites, bn = s2_sites(probe, c["batch"], imgsz), bn_sites(probe, c["batch"], imgsz)
            per_step = (sum(s["k"] == 3 for s in sites), sum(s["k"] == 1 for s in sites), len(bn))
            row = {"imgsz": imgsz, "task": task, "per_step": dict(zip(("s2_k3", "s2_k1", "bn"), per_step)),
                   "s2_sites": [(s["name"], s["k"], s["x"], s["w"][0]) for s in sites]}
            if checked:
                row.update(train_kernel_checks(probe, c["batch"], imgsz, seed=7000 + 100 * mi, timed_sites=main,
                                               seen=seen))
            else:
                row.update(kernel_site_checks(name, sites, bn, 7000 + 100 * mi, seen))
                if sites:
                    row["s2_time"] = s2_kind_times(sites, 7000 + 100 * mi, timed_sites=False)
            del probe
            lap(f"{stem}.kernels")
            model, row["predict"] = predict(name, task, imgsz, frames[hw], batches, c["seed"] + mi, checked)
            if checked:
                row["fp32"] = fp32_checks(model, frames[hw][0])
            lap(f"{stem}.predict")
            if task == "detect":
                row["grads"] = grad_checks(name, model.model, imgsz, c["seed"] + 70 + mi)
                lap(f"{stem}.grads")
            del model
            row["fixed_batch"] = fixed_steps(name, task, imgsz, steps, per_step, c["seed"] + 50 + mi, main)
            lap(f"{stem}.steps")
            if main:  # one epoch from disk with both kernels, then rect val of last.npz
                data = dense.result()[0]
                lap("dataset_wait")
                n_checks = len(checks)
                reset()
                model = YOLO(name)
                t0 = time.perf_counter()
                metrics = model.train(data=str(data), epochs=1, imgsz=imgsz, batch=c["batch"], nbs=c["batch"],
                                      optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", cache="ram",
                                      workers=c["workers"], project=str(tmp / "runs"), name=stem, exist_ok=True,
                                      plots=False)
                train_wall = time.perf_counter() - t0
                train_counts = counts()
                tr = model.trainer
                reset()
                last = YOLO(tr.wdir / "last.npz")
                t0 = time.perf_counter()
                val_metrics = last.val(data=str(data))  # rect batches: the facade's default
                val_wall = time.perf_counter() - t0
                val_counts = counts()
                steps_run, n_k3, n_k1 = tr.nb, per_step[0], per_step[1]
                if (train_counts["s2_calls"] != {k3: n_k3 * steps_run, k1: n_k1 * steps_run}
                        or train_counts["bn_calls"] != per_step[2] * steps_run):
                    raise AssertionError(f"{name} epoch: {train_counts}, expected {per_step} a step for {steps_run} "
                                         "steps")
                val_batches = math.ceil(c["n_val"] / c["batch"]) + len(last.validator.dataloader)
                if (len(checks) - n_checks != val_batches
                        or train_counts["nms_calls"] + val_counts["nms_calls"] != val_batches):
                    raise AssertionError(f"{name}: {len(checks) - n_checks} NMS calls checked, kernel calls "
                                         f"{train_counts['nms_calls']} + {val_counts['nms_calls']}, for {val_batches} "
                                         "val batches")
                for what, m in (("train", metrics), ("val", val_metrics)):
                    if len(m) != 5 or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
                        raise AssertionError(f"{name} {what} metrics: {m}")
                ep = tr.epoch_stats[0]
                shapes = last.validator.dataloader.dataset.batch_shapes
                row["epoch"] = {"epoch_s": ep["train_s"], "train_wall_s": train_wall,
                                "data_wait_share": ep["data_wait_s"] / ep["train_s"], "loss_items": ep["loss_items"],
                                "metrics_train": metrics, "metrics_val_rect": val_metrics,
                                "val_img_per_s": last.validator.seen / val_wall,
                                "rect_shapes": [list(map(int, s)) for s in shapes],
                                "counts": {"train": train_counts, "val": val_counts}}
                del model, last, tr
                lap(f"{stem}.epoch_and_val")
            out["models"][name] = row
    finally:
        nms_ops.greedy_keep = kernel_keep
        writer.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(ch["equal"] for ch in checks):
        raise AssertionError(f"zoo: keep masks unequal to the plain keep: {[ch for ch in checks if not ch['equal']]}")
    out["nms_keep_checks"] = {"calls": len(checks), "all_equal_plain": True, "K": sorted({ch["K"] for ch in checks})}
    out["launches"] = dict(launches)
    return out


def v10_fp32_checks(model, frame: np.ndarray) -> dict:
    """A v10 model's float32 forward (TF32 off, `spread_weights`, fused) on the card against the CPU's on one
    letterboxed frame: the decoded one-to-one maps (boxes within BOX_ATOL_PX, scores within SCORE_RTOL), and the
    top-k detections row by row wherever the CPU's scores are untied (apart by more than twice the measured relative
    score error from the scores before and after them in the sorted (anchor, class) list, so that no error can swap
    them): the same class, the box within BOX_ATOL_PX; at least one such row."""
    net = copy.deepcopy(model.model)
    net.load_state_dict(spread_weights(net.state_dict(), np.random.default_rng(1)))
    with torch.inference_mode():
        net = net.fuse().float()
        x = model.predictor.preprocess([frame]).float()
        dets_card, aux = net(x)
        dec_card = net.head.decode(aux["one2one"]).cpu()
        dets_card = dets_card.cpu()
        net, x = net.cpu(), x.cpu()
        dets_cpu, aux = net(x)
        dec_cpu = net.head.decode(aux["one2one"])
    del net
    box_err = float((dec_card[..., :4] - dec_cpu[..., :4]).abs().max())
    score_rel_err = float(((dec_card[..., 4:] - dec_cpu[..., 4:]).abs() / dec_cpu[..., 4:]).max())
    if not (box_err <= BOX_ATOL_PX and score_rel_err <= SCORE_RTOL):
        raise AssertionError(f"v10 float32 one-to-one maps card vs CPU: box err {box_err} px, score rel err "
                             f"{score_rel_err}")
    k = dets_cpu.shape[1]
    ranked = dec_cpu[0, :, 4:].flatten().sort(descending=True).values[:k + 1]
    margin = 2 * score_rel_err * ranked[:k]
    gap_before = torch.cat((torch.full((1,), float("inf")), ranked[:k - 1] - ranked[1:k]))
    untied = (gap_before > margin) & (ranked[:k] - ranked[1:k + 1] > margin)
    a, b = dets_card[0][untied], dets_cpu[0][untied]
    det_box_err = float((a[:, :4] - b[:, :4]).abs().max()) if len(a) else 0.0
    if not (torch.equal(a[:, 5], b[:, 5]) and det_box_err <= BOX_ATOL_PX and bool(untied.any())):
        raise AssertionError(f"v10 float32 top-{k} card vs CPU: {int(untied.sum())} untied rows, classes equal "
                             f"{torch.equal(a[:, 5], b[:, 5])}, box err {det_box_err} px")
    return {"box_err_px": box_err, "score_rel_err": score_rel_err, "box_atol_px": BOX_ATOL_PX, "score_rtol": SCORE_RTOL,
            "top_k": k, "untied_rows": int(untied.sum()), "untied_classes_equal": True,
            "untied_box_err_px": det_box_err}


def run_v10(smi: str) -> dict:
    """Phase 20: YOLOv10 on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.models.yolo import TASK_MAP
    from drone_yolo_tpu_torch.nn.model import DetectionModel
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops import nms as nms_ops

    c = V10_CELL
    k3, k1 = cuda_s2bwd.NAMES[3], cuda_s2bwd.NAMES[1]
    launches = defaultdict(int)
    keep_calls = [0]  # greedy-NMS keep masks asked for on any device: a v10 path asks for none
    kernel_keep = nms_ops.greedy_keep

    def counted_keep(boxes, valid, iou_thres):
        keep_calls[0] += 1
        return kernel_keep(boxes, valid, iou_thres)

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()
        keep_calls[0] = 0

    def counts() -> dict:
        cnt = {"s2_calls": dict(cuda_s2bwd.s2_bwd_cuda.calls), "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
               "nms_calls": cuda_nms.greedy_keep_cuda.calls + keep_calls[0],
               "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches,
                            "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                            **{n: cuda_s2bwd.s2_bwd_cuda.launches.get(n, 0) for n in (k3, k1)}}}
        for key, v in cnt["launches"].items():
            launches[key] += v
        return cnt

    def probe_sites(name: str) -> tuple:
        with torch.device("meta"):  # the sites' shapes only
            probe = DetectionModel(name, nc=c["nc"])
        sites, bn = s2_sites(probe, c["batch"], c["imgsz"]), bn_sites(probe, c["batch"], c["imgsz"])
        if [st["name"].split(".")[1] for st in sites] != V10_S2_LAYERS or any(st["k"] != 3 for st in sites):
            raise AssertionError(f"{name}: stride-2 sites {[(st['name'], st['k']) for st in sites]}")
        return probe, sites, bn

    def predict(name: str, frames, batches, share: float, seed: int) -> tuple:
        """Calibrated weights, then predict at each batch size after a warm-up: detections finite, sorted by score,
        above conf, and no NMS call."""
        model = YOLO(name)
        bias = calibrated_weights(model, frames[0], seed, c["cls_gain"], share, c["conf"], c["imgsz"])
        out = {"cls_bias": bias}
        reset()
        for b in batches:
            model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = model.predict(frames[:b], imgsz=c["imgsz"], conf=c["conf"], batch=b, verbose=False)
            wall = time.perf_counter() - t0
            n_det = [len(r.boxes) for r in res]
            conf = [r.boxes.conf for r in res]
            ok = all(np.isfinite(r.boxes.data).all() for r in res) and all(
                (cf > c["conf"]).all() and (np.diff(cf) <= 0).all() for cf in conf)
            if not (sum(n_det) and ok):
                raise AssertionError(f"{name} predict at batch {b}: {n_det} detections, finite, sorted and above conf "
                                     f"{ok}")
            out[f"batch{b}"] = {"img_per_s": b / wall, "n_det": n_det, "speed_ms_per_img": res[0].speed}
        out["counts"] = counts()
        if out["counts"]["nms_calls"]:
            raise AssertionError(f"{name} predict: {out['counts']['nms_calls']} NMS calls, expected none")
        return model, out

    def fixed_run(name: str, batch: dict, steps: int, kern) -> tuple:
        trainer = TASK_MAP["detect"]["trainer"](
            overrides=dict(model=name, batch=c["batch"], imgsz=c["imgsz"], nbs=c["batch"], optimizer="SGD", amp=True,
                           s2grad=kern, bnstats=kern, warmup_epochs=0.0), train_loader=[batch] * steps,
            data={"nc": c["nc"]})
        reset()
        run = trainer.run_steps()
        return trainer, run, counts()

    def check_steps(name: str, mode: str, run, cnt, steps: int, n_bn: int, falling: bool) -> list:
        want = ({k3: 4 * steps, k1: 0}, n_bn * steps, 0) if mode == "both" else ({k3: 0, k1: 0}, 0, 0)
        if (cnt["s2_calls"], cnt["bn_calls"], cnt["nms_calls"]) != want:
            raise AssertionError(f"{name} {mode} steps: {cnt}, expected stride-2, BN and NMS calls {want}")
        loss = [r["loss"] for r in run]
        if not (np.isfinite(loss).all() and np.isfinite([r["items"] for r in run]).all()
                and (loss[-1] < loss[0] or not falling)):
            raise AssertionError(f"{name} {mode} steps: the E2E loss is not finite{' or did not fall' * falling}: "
                                 f"{loss}")
        return loss

    out = {"cell": dict(c), "nvidia_smi": smi, "models": {}, "stage_s": {}}
    t_stage = [time.perf_counter()]

    def lap(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["stage_s"][name] = now - t_stage[0]
        t_stage[0] = now

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_v10_"))
    # the epoch's JPEGs are encoded in a process of their own while the model's kernels, predict and steps run
    writer = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    nms_ops.greedy_keep = counted_keep
    try:
        dense = writer.submit(write_dense_dataset, tmp / "dense", c["n_train"], c["n_val"], c["imgsz"], c["seed"],
                              c["data_nc"], c["obj_px"])
        frames = moving_frames(np.random.default_rng(c["seed"]), c["frames"], FRAME_HW, 60)
        lap("inputs")
        name, stem = c["model"], Path(c["model"]).stem
        seen = set()  # the site and BN shapes checked already: each once across the v10 models
        probe, sites, bn = probe_sites(name)
        row = train_kernel_checks(probe, c["batch"], c["imgsz"], seed=9000, seen=seen)
        n_bn = row["bn_inputs"]
        del probe
        lap(f"{stem}.kernels")

        model, row["predict"] = predict(name, frames, (1, 8), c["share_above_conf"], c["seed"])
        row["fp32_card_vs_cpu"] = v10_fp32_checks(model, frames[0])
        del model
        lap(f"{stem}.predict_and_fp32")

        batch = synthetic_batch(np.random.default_rng(c["seed"] + 1), c["batch"], c["imgsz"], c["nc"])
        runs = {}
        for mode, kern in (("both", "cuda"), ("stock", None)):
            torch.cuda.reset_peak_memory_stats()
            trainer, run, cnt = fixed_run(name, batch, c["fixed_steps"], kern)
            loss = check_steps(name, mode, run, cnt, c["fixed_steps"], n_bn, falling=True)
            ms = float(np.median([r["ms"] for r in run[1:]]))
            runs[mode] = {"loss": loss, "items": [r["items"] for r in run], "step_ms_median": ms,
                          "img_per_s": c["batch"] / ms * 1e3, "first_step_ms": run[0]["ms"],
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "counts": cnt}
            if mode == "both":
                hyp = trainer._warmup_hyp(trainer.ni, 0)
                runs[mode]["profile"] = profile_device(lambda: trainer.train_step(batch, *hyp)[0].item(), steps=3)
            del trainer
        row["fixed_batch"] = runs
        lap(f"{stem}.fixed_batch")

        data = dense.result()[0]
        lap("dataset_wait")
        reset()
        model = YOLO(name)
        t0 = time.perf_counter()
        metrics = model.train(data=str(data), epochs=1, imgsz=c["imgsz"], batch=c["batch"], nbs=c["batch"],
                              optimizer="SGD", amp=True, s2grad="cuda", bnstats="cuda", cache="ram",
                              workers=c["workers"], project=str(tmp / "runs"), name=stem, exist_ok=True, plots=False)
        train_wall = time.perf_counter() - t0
        train_counts = counts()
        tr = model.trainer
        reset()
        last = YOLO(tr.wdir / "last.npz")
        t0 = time.perf_counter()
        val_metrics = last.val(data=str(data))  # rect batches: the facade's default
        val_wall = time.perf_counter() - t0
        val_counts = counts()
        steps = tr.nb
        if (train_counts["s2_calls"] != {k3: 4 * steps, k1: 0} or train_counts["bn_calls"] != n_bn * steps
                or train_counts["nms_calls"] + val_counts["nms_calls"]):
            raise AssertionError(f"{name} epoch: {train_counts}, val {val_counts}: expected {4 * steps} stride-2, "
                                 f"{n_bn * steps} BN and no NMS calls for {steps} steps")
        for what, m in (("train", metrics), ("val", val_metrics)):
            if len(m) != 5 or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
                raise AssertionError(f"{name} {what} metrics: {m}")
        ep = tr.epoch_stats[0]
        if not np.isfinite(ep["loss_items"]).all():
            raise AssertionError(f"{name} epoch loss items {ep['loss_items']}")
        row["epoch"] = {"epoch_s": ep["train_s"], "train_wall_s": train_wall,
                        "data_wait_share": ep["data_wait_s"] / ep["train_s"], "loss_items": ep["loss_items"],
                        "metrics_train": metrics, "metrics_val_rect": val_metrics,
                        "val_img_per_s": last.validator.seen / val_wall,
                        "counts": {"train": train_counts, "val": val_counts}}
        row["per_step"] = {"s2_calls": 4, "bn_calls": n_bn}
        out["models"][name] = row
        del model, last, tr
        lap(f"{stem}.epoch_and_val")

        for mi, other in enumerate(c["others"]):  # the other scales: predict at batch 8, 2 steps with both kernels
            ostem = Path(other).stem
            probe, sites, bn = probe_sites(other)
            orow = {"s2_sites": [(s["name"], s["k"], s["x"], s["w"][0]) for s in sites], "bn_inputs": len(bn),
                    **kernel_site_checks(other, sites, bn, 9100 + 100 * mi, seen)}
            del probe
            model, orow["predict"] = predict(other, frames, (c["batch"],), c["other_share"], c["seed"] + 10 + mi)
            del model
            obatch = synthetic_batch(np.random.default_rng(c["seed"] + 20 + mi), c["batch"], c["imgsz"], c["nc"])
            _, run, cnt = fixed_run(other, obatch, c["other_steps"], "cuda")
            orow["loss"] = check_steps(other, "both", run, cnt, c["other_steps"], len(bn), falling=False)
            orow["step_ms_median"] = float(np.median([r["ms"] for r in run[1:]]))
            orow["counts"] = cnt
            out["models"][other] = orow
            lap(ostem)
    finally:
        nms_ops.greedy_keep = kernel_keep
        writer.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = dict(launches)
    out["shapes_checked"] = len(seen)
    return out


def make_walker(rng: np.random.Generator, n_frames: int = 120, fps: float = 30.0, cadence: float = 1.8,
                speed: float = 80.0, noise: float = 1.0) -> np.ndarray:
    """A synthetic COCO-17 walking track (T, 17, 2): hips advance at `speed` px/s, ankles swing fore and aft at
    `cadence` steps/s (a copy of `tests/test_gait.py:make_walker`)."""
    t = np.arange(n_frames) / fps
    kpts = np.zeros((n_frames, 17, 2))
    hip_x = speed * t + rng.normal(0, noise, n_frames).cumsum() * 0.01
    hip_y = 200 + 2 * np.sin(2 * np.pi * cadence * t)
    stride_hz = cadence / 2
    phase = 2 * np.pi * stride_hz * t
    amp = speed / (2 * np.pi * stride_hz) * 0.9
    for hip, knee, ankle, sgn, ph in ((11, 13, 15, -1, 0.0), (12, 14, 16, 1, np.pi)):
        kpts[:, hip] = np.stack([hip_x + sgn * 8, hip_y], 1)
        kpts[:, ankle] = np.stack([hip_x + amp * np.sin(phase + ph) + sgn * 10, hip_y + 80], 1)
        kpts[:, knee] = (kpts[:, hip] + kpts[:, ankle]) / 2 + np.stack([10 * np.cos(phase + ph), np.zeros(n_frames)], 1)
    kpts[:, 5] = kpts[:, 11] + [0, -60]
    kpts[:, 6] = kpts[:, 12] + [0, -60]
    kpts += rng.normal(0, noise, kpts.shape)
    return kpts


def fake_streamlit(choices: dict, upload=None):
    """A stand-in for the streamlit module that `solutions.Inference` drives: the sidebar answers each widget from
    `choices` ({label: value}), `upload` is the uploaded file, Start is pressed, Stop is not; the two frame panes keep
    what they are shown."""

    class Pane:
        def __init__(self):
            self.frames = []

        def image(self, img, **kw):
            self.frames.append(np.asarray(img))

        def empty(self):
            return self

    class Sidebar:
        def title(self, *a):
            pass

        def selectbox(self, label, options):
            return choices.get(label, options[0])

        def radio(self, label, options):
            return choices.get(label, options[0])

        def slider(self, label, lo, hi, val, step):
            return choices.get(label, val)

        def multiselect(self, label, options, default=None):
            return choices.get(label, default or [])

        def file_uploader(self, *a, **k):
            return upload

        def button(self, label):
            return True

    class St:
        sidebar = Sidebar()
        panes = (Pane(), Pane())
        messages = []

        def set_page_config(self, **kw):
            pass

        def markdown(self, *a, **k):
            pass

        def columns(self, n):
            return self.panes

        def spinner(self, msg):
            return contextlib.nullcontext()

        def success(self, msg):
            pass

        def error(self, msg):
            self.messages.append(("error", msg))

        def warning(self, msg):
            self.messages.append(("warning", msg))

        def button(self, label):
            return False

        def stop(self):
            raise SystemExit

    return St()


def drawing_cost(frame: np.ndarray, n: int = 50) -> dict:
    """Host ms of the apps' drawing on a copy of `frame`: a box label (`Annotator.box_label`, boxes of 24-120 px), a
    30-point track history (`draw_centroid_and_tracks`), each the mean of `n`; the heatmap's colormap and blend of
    the whole frame."""
    from drone_yolo_tpu_torch.ops.draw import add_weighted, apply_color_map
    from drone_yolo_tpu_torch.utils.plotting import Annotator, colors

    rng = np.random.default_rng(0)
    h, w = frame.shape[:2]
    ann = Annotator(frame.copy(), line_width=SOLUTIONS_CELL["line_width"])
    xy, wh = rng.uniform(0, [w - 120, h - 120], (n, 2)), rng.uniform(24, 120, (n, 2))
    t = time.perf_counter()
    for i, (p, s) in enumerate(zip(xy, wh)):
        ann.box_label([*p, *(p + s)], f"class{i % 80} #{i}", color=colors(i, True))
    label = (time.perf_counter() - t) * 1e3 / n
    track = [(float(x), float(y)) for x, y in np.cumsum(rng.normal(0, 8, (30, 2)), 0) + [w / 2, h / 2]]
    t = time.perf_counter()
    for i in range(n):
        ann.draw_centroid_and_tracks(track, color=colors(i, True), track_thickness=SOLUTIONS_CELL["line_width"])
    history = (time.perf_counter() - t) * 1e3 / n
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    t = time.perf_counter()
    add_weighted(frame, 0.5, apply_color_map(gray, 12), 0.5, 0)
    return {"box_label": label, "track_history_30": history, "colormap_and_blend": (time.perf_counter() - t) * 1e3}


def run_solutions(smi: str) -> dict:
    """Phase 21: the analytics layer over tracks on the card (see the module docstring), its checks and its numbers."""
    import drone_yolo_tpu_torch.solutions.heatmap as heatmap_mod
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch import solutions as S
    from drone_yolo_tpu_torch.apps import GeoConverter
    from drone_yolo_tpu_torch.apps.forest import RandomForestClassifier
    from drone_yolo_tpu_torch.apps.gait import FEATURE_NAMES, GaitStudy
    from drone_yolo_tpu_torch.data.avi import AviWriter
    from drone_yolo_tpu_torch.engine.results import Results
    from drone_yolo_tpu_torch.ops import cuda_nms
    from drone_yolo_tpu_torch.ops import nms as nms_ops
    from drone_yolo_tpu_torch.trackers.byte_tracker import STrack
    from drone_yolo_tpu_torch.utils.plotting import Annotator

    c, tc = SOLUTIONS_CELL, TRACK_CELL
    t_phase = time.perf_counter()
    h, w = tc["hw"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_solutions_"))
    frames = moving_frames(np.random.default_rng(tc["seed"]), tc["frames"], tc["hw"], tc["objects"], tc["obj_px"])
    frames = frames[:c["frames"]]
    det = YOLO(FLAGSHIP)
    biases = {FLAGSHIP: calibrated_weights(det, frames[0], 0, tc["cls_gain"], c["share_above_conf"], tc["conf"],
                                           tc["imgsz"])}
    det.overrides.update(imgsz=tc["imgsz"], tracker=c["tracker"])
    det.save(tmp / "flagship.npz")  # the browser app's model, before the predictor fuses it
    task_models = {}
    for seed, (app, (name, share)) in enumerate(c["task_models"].items(), 1):
        m = YOLO(name)
        biases[name] = calibrated_weights(m, frames[0], seed, tc["cls_gain"], share, tc["conf"], tc["imgsz"])
        m.overrides.update(imgsz=tc["imgsz"])
        task_models[app] = m
    geo = GeoConverter(**tc["geo"], image_width_px=w, image_height_px=h)
    mid = [(w // 4, h // 4), (3 * w // 4, h // 4), (3 * w // 4, 3 * h // 4), (w // 4, 3 * h // 4)]
    halves = {"left": [(0, 0), (w // 2, 0), (w // 2, h), (0, h)], "right": [(w // 2, 0), (w, 0), (w, h), (w // 2, h)]}
    sw, sh = w // c["parking_grid"][1], h // c["parking_grid"][0]
    slots = [[(x, y), (x + sw, y), (x + sw, y + sh), (x, y + sh)] for y in range(0, sh * c["parking_grid"][0], sh)
             for x in range(0, sw * c["parking_grid"][1], sw)]
    common = dict(conf=tc["conf"], line_width=c["line_width"])
    solutions = {
        "ObjectCounter_line": lambda: S.ObjectCounter(model=det, region=[(0, h // 2), (w, h // 2)], **common),
        "ObjectCounter_polygon": lambda: S.ObjectCounter(model=det, region=mid, **common),
        "RegionCounter": lambda: S.RegionCounter(model=det, regions=halves, **common),
        "QueueManager": lambda: S.QueueManager(model=det, region=mid, **common),
        "SpeedEstimator": lambda: S.SpeedEstimator(model=det, meters_per_pixel=geo.gsd, fps=c["fps"], **common),
        "DistanceCalculation": lambda: S.DistanceCalculation(model=det, meters_per_pixel=geo.gsd, **common),
        "Heatmap": lambda: S.Heatmap(model=det, **common),
        "ParkingManagement": lambda: S.ParkingManagement(model=det, parking_regions=slots, **common),
        "SecurityAlarm": lambda: S.SecurityAlarm(model=det, records=c["alarm_records"], on_alarm=lambda n: None,
                                                 **common),
        "TrackZone": lambda: S.TrackZone(model=det, region=mid, **common),
        "Analytics": lambda: S.Analytics(model=det, **common),
        "AIGym": lambda: S.AIGym(model=task_models["AIGym"], **common),
        "InstanceSegmentation": lambda: S.InstanceSegmentation(model=task_models["InstanceSegmentation"], **common),
    }

    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        checks.append(bool(torch.equal(keep, nms_ops.greedy_keep_reference(boxes, valid, iou_thres))))
        return keep

    spent, depth = defaultdict(float), [0]

    def timed(key, fn):
        """fn timed into spent[key], the outermost call only (drawing calls nest)."""
        def run(*a, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    spent[key] += time.perf_counter() - t0
        return run

    drawing = [(Annotator, n) for n in ("box_label", "draw_region", "draw_centroid_and_tracks", "_label_box",
                                        "display_analytics", "plot_angle_and_count_and_stage",
                                        "plot_distance_and_line", "kpts", "masks")]
    drawing += [(Results, "plot"), (heatmap_mod, "apply_color_map"), (heatmap_mod, "add_weighted")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in drawing]
    results, nms_ok = {}, True
    nms_ops.greedy_keep = checked_keep
    try:
        for owner, attr, fn in saved:
            setattr(owner, attr, timed("draw", fn))
        for name, make in solutions.items():
            model = task_models.get(name, det)
            if model.predictor is not None:
                model.predictor.__dict__.pop("trackers", None)  # a new tracker, as for a new video
            STrack.reset_id()
            sol = make()
            for mth in ("track", "predict"):
                setattr(model, mth, timed("track", getattr(model, mth)))
            spent.clear()
            first = len(checks)
            seen, per_frame, track_ms, tracked = set(), [], [], name not in ("AIGym", "InstanceSegmentation")
            cuda_nms.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                for f in frames:
                    before = spent["track"]
                    out = sol.process(f)
                    track_ms.append((spent["track"] - before) * 1e3)
                    seen.update(sol.track_ids)
                    per_frame.append({"boxes": len(sol.boxes) if tracked else out["n"] if "n" in out else
                                      len(out["stages"]), **{k: v for k, v in out.items()
                                                                  if k in ("region_counts", "n", "queue_count")}})
                    if out["im0"].shape != f.shape or out["im0"].dtype != np.uint8:
                        raise AssertionError(f"solutions: {name} returned a frame of {out['im0'].shape}")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                del model.track, model.predict
            calls, launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
            nms_ok &= calls == len(frames) == len(checks) - first and launches == 2 * calls
            n = len(frames)
            row = {"fps": n / wall, "ms_per_frame": {"track": spent["track"] * 1e3 / n, "draw": spent["draw"] * 1e3 / n,
                                                     "logic": (wall - spent["track"] - spent["draw"]) * 1e3 / n},
                   "track_ms_first_frame": track_ms[0], "track_ms_median_after": float(np.median(track_ms[1:])),
                   "nms_calls": calls, "nms_launches": launches, "tracks_seen": len(seen),
                   ("boxes_per_frame" if tracked else "instances_per_frame"): float(np.mean([p["boxes"] for p in per_frame]))}
            if name.startswith("ObjectCounter"):
                row.update(in_count=out["in_count"], out_count=out["out_count"], classwise=out["classwise"])
                if out["in_count"] + out["out_count"] > len(seen):
                    raise AssertionError(f"solutions: {name} counted {out['in_count']} + {out['out_count']} of "
                                         f"{len(seen)} tracks")
            elif name == "RegionCounter":
                row["region_counts_last"] = out["region_counts"]
                if any(sum(p["region_counts"].values()) > p["boxes"] for p in per_frame):
                    raise AssertionError(f"solutions: region counts {per_frame} above the boxes")
            elif name == "QueueManager":
                row["queue_counts"] = [p["queue_count"] for p in per_frame]
            elif name == "SpeedEstimator":
                v = np.array(list(out["speeds"].values()))
                if not len(v) or not np.isfinite(v).all():
                    raise AssertionError(f"solutions: speeds {out['speeds']}")
                row.update(meters_per_pixel=geo.gsd, speeds_kmh={"tracks": len(v), "median": float(np.median(v)),
                                                                 "max": float(v.max())})
            elif name == "DistanceCalculation":
                row.update(distance_m=out["distance_m"], pair=out["pair"])
            elif name == "Heatmap":
                heat = out["heatmap"]
                if not np.isfinite(heat).all() or heat.max() <= 0:
                    raise AssertionError(f"solutions: heatmap max {heat.max()}")
                row.update(heat_max=float(heat.max()), heat_nonzero_share=float((heat > 0).mean()))
            elif name == "ParkingManagement":
                row.update(occupied=out["occupied"], available=out["available"], slots=len(slots))
            elif name == "SecurityAlarm":
                row.update(triggered=out["triggered"], records=c["alarm_records"], n_last=out["n"])
            elif name == "TrackZone":
                row["n_tracks_last"] = out["n_tracks"]
            elif name == "Analytics":
                row["series_last"] = out["series"][-1]
                if len(out["series"]) != n or sum(out["series"][-1].values()) != per_frame[-1]["boxes"]:
                    raise AssertionError(f"solutions: analytics series {out['series'][-1]}")
            elif name == "AIGym":
                row.update(counts=out["counts"], people_last=len(out["stages"]))
            results[name] = row

        # the browser app under a fake UI, tracking over an MJPEG AVI that the phase writes
        ah, aw = c["app_hw"]
        with AviWriter(tmp / "clip.avi", fps=c["fps"]) as writer:
            for f in frames[:c["app_frames"]]:
                writer.write(np.ascontiguousarray(f[:ah, :aw]))

        class Upload:
            name = "clip.avi"

            def read(self):
                return (tmp / "clip.avi").read_bytes()

        st = fake_streamlit({"Video": "video", "Enable Tracking": "Yes", "Model": str(tmp / "flagship.npz")}, Upload())
        app = S.Inference(st_module=st, model=str(tmp / "flagship.npz"))
        first = len(checks)
        cuda_nms.reset_counts()
        t0 = time.perf_counter()
        with contextlib.chdir(tmp):
            app.inference()
        wall = time.perf_counter() - t0
        calls, launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
        shown = [len(p.frames) for p in st.panes]
        if shown != [c["app_frames"]] * 2 or st.panes[1].frames[0].shape != (ah, aw, 3) or \
                not (tmp / "drone_yolo_upload.avi").exists():
            raise AssertionError(f"solutions: the app showed {shown} frames, {st.messages}")
        nms_ok &= calls == c["app_frames"] == len(checks) - first and launches == 2 * calls
        results["Inference"] = {"fps": c["app_frames"] / wall, "frames": c["app_frames"], "frame_hw": [ah, aw],
                                "nms_calls": calls, "nms_launches": launches, "messages": st.messages}
    finally:
        nms_ops.greedy_keep = kernel_keep
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(checks) or not nms_ok:
        raise AssertionError(f"solutions: {checks.count(False)} of {len(checks)} keep masks differ from the plain "
                             f"keep, or an app's NMS calls are not one a frame with two launches each: {results}")

    # the gait study on the host: 28 synthetic walkers of two groups
    rng = np.random.default_rng(c["gait_seed"])
    tracks, groups = {}, {}
    for i in range(c["walkers"]):
        old = i < c["walkers"] // 2
        tracks[i] = make_walker(rng, cadence=rng.normal(1.6 if old else 2.2, 0.08),
                                speed=rng.normal(70 if old else 100, 4))
        groups[i] = "old" if old else "young"
    t0 = time.perf_counter()
    report = GaitStudy(fps=c["fps"]).run(tracks, groups)
    gait_s = time.perf_counter() - t0
    if any(set(f) != set(FEATURE_NAMES) for f in report["features"].values()) or \
            set(report["classifier"]["importances"]) != set(FEATURE_NAMES) or len(report["features"]) != len(tracks):
        raise AssertionError(f"solutions: the gait report lacks features: {report}")
    x = np.array([[f[k] for k in FEATURE_NAMES] for f in report["features"].values()])
    t0 = time.perf_counter()
    RandomForestClassifier(200, 0).fit(x, [groups[i] for i in report["features"]])
    fit_s = time.perf_counter() - t0
    gait = {"walkers": len(tracks), "seconds": gait_s, "forest_fit_s": fit_s, "classifier": report["classifier"],
            "significant_anova": sorted(k for k, v in report["stats"].items() if v["anova_p"] < 0.05)}
    nms_calls = sum(r["nms_calls"] for r in results.values())
    return {"nvidia_smi": smi, "cell": c, "class_bias": biases, "frames": len(frames),
            "host_drawing_ms": drawing_cost(frames[0]),
            "frames_cut": f"{len(frames)} of the track cell's {tc['frames']} frames ({h}x{w})", "solutions": results,
            "nms_keep_checks": {"calls": len(checks), "all_equal_plain": True}, "nms_calls": nms_calls,
            "nms_launches": 2 * nms_calls, "gait": gait, "phase_s": time.perf_counter() - t_phase}



def kserve_server(module, meta: dict, endpoint: str, device: torch.device):
    """A local KServe-v2 REST server (stdlib `http.server`, threaded) for one TorchScript module on the card: the config
    at GET /v2/models/<endpoint>/config (the artifact's sidecar as `parameters.metadata`), binary-extension inference at
    POST /v2/models/<endpoint>/infer, the outputs in the ONNX artifact's layout (B, 4 + nc, A), as a Triton server of
    the exported model answers. Returns (the server, its count of infer requests); the caller shuts it down."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    config = json.dumps({"input": [{"name": "images", "data_type": "TYPE_FP32", "dims": meta["input"]}],
                         "output": [{"name": "output0", "data_type": "TYPE_FP32", "dims": [-1]}],
                         "parameters": {"metadata": {"string_value": json.dumps(meta)}}}).encode()
    served = {"requests": 0}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def reply(self, body: bytes, header_len: int | None = None):
            self.send_response(200)
            if header_len is not None:
                self.send_header("Inference-Header-Content-Length", str(header_len))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") != f"/v2/models/{endpoint}/config":
                self.send_error(404)
                return
            self.reply(config)

        def do_POST(self):
            if self.path != f"/v2/models/{endpoint}/infer":
                self.send_error(404)
                return
            hlen = int(self.headers["Inference-Header-Content-Length"])
            raw = self.rfile.read(int(self.headers["Content-Length"]))
            req = json.loads(raw[:hlen])
            x = torch.frombuffer(bytearray(raw[hlen:]), dtype=torch.float32).reshape(req["inputs"][0]["shape"])
            with torch.inference_mode():
                y = module(x.to(device)).float().transpose(1, 2).contiguous().cpu().numpy()
            blob = y.tobytes()
            hdr = json.dumps({"outputs": [{"name": "output0", "datatype": "FP32", "shape": list(y.shape),
                                           "parameters": {"binary_data_size": len(blob)}}]}).encode()
            served["requests"] += 1
            self.reply(hdr + blob, len(hdr))

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, served


def run_export(smi: str) -> dict:
    """Phase 22: export and AutoBackend on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.nn.autobackend import ArtifactModel, AutoBackend
    from drone_yolo_tpu_torch.ops import cuda_nms
    from drone_yolo_tpu_torch.ops import nms as nms_ops

    c = EXPORT_CELL
    out = {"cell": dict(c), "nvidia_smi": smi, "stage_s": {}, "score_atol": EXPORT_SCORE_ATOL,
           "box_atol_px": BOX_ATOL_PX, "map_atol": EXPORT_MAP_ATOL}
    t_stage = [time.perf_counter()]

    def lap(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["stage_s"][name] = now - t_stage[0]
        t_stage[0] = now
        print(f"export: {name} {out['stage_s'][name]:.2f} s", file=sys.stderr, flush=True)

    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):  # every keep mask of the phase against the plain keep
        keep = kernel_keep(boxes, valid, iou_thres)
        checks.append({"K": int(boxes.shape[1]), "equal": bool(torch.equal(keep, nms_ops.greedy_keep_reference(
            boxes, valid, iou_thres)))})
        return keep

    def nms_counts() -> dict:
        return {"calls": cuda_nms.greedy_keep_cuda.calls, "launches": cuda_nms.greedy_keep_cuda.launches}

    def per_image_ms(fn, x) -> float:
        """The median host milliseconds of `fn(x)` (synchronised) over `reps` calls after two, per image."""
        for _ in range(2):
            fn(x)
        torch.cuda.synchronize()
        walls = []
        for _ in range(c["reps"]):
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3 / x.shape[0]

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    writer = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    nms_ops.greedy_keep = checked_keep
    server = None
    try:
        dense = writer.submit(write_dense_dataset, tmp / "dense", 1, c["n_val"], c["imgsz"], c["seed"], c["data_nc"],
                              c["obj_px"])
        frames = moving_frames(np.random.default_rng(c["seed"]), c["frames"], FRAME_HW, 60)
        model = YOLO(FLAGSHIP)
        out["cls_bias"] = calibrated_weights(model, frames[0], c["seed"], c["cls_gain"], c["share_above_conf"],
                                             c["conf"], c["imgsz"])
        model.predict(frames, imgsz=c["imgsz"], conf=c["conf"], batch=c["batch"], verbose=False)  # the eager bf16 predictor
        lap("weights")
        paths, out["artifacts"] = {}, {}
        for name, fmt, half in (("torchscript_bf16", "torchscript", True), ("torchscript_f32", "torchscript", False),
                                ("onnx", "onnx", False)):
            t0 = time.perf_counter()
            paths[name] = model.export(format=fmt, half=half, imgsz=c["imgsz"], batch=c["batch"], project=str(tmp / name))
            out["artifacts"][name] = {"export_s": time.perf_counter() - t0, "bytes": Path(paths[name]).stat().st_size,
                                      "file": Path(paths[name]).name}
        lap("export")
        backends = {name: AutoBackend(p) for name, p in paths.items()}
        for name, b in backends.items():
            if b.device != model.device or b.input_shape != [c["batch"], 3, c["imgsz"], c["imgsz"]] or b.nc != 80:
                raise AssertionError(f"{name}: backend on {b.device}, input {b.input_shape}, nc {b.nc}")
            out["artifacts"][name]["kind"] = b.kind
        pred = model.predictor
        x = pred.preprocess(frames)
        with torch.inference_mode():  # the eager fused float32 forward, TF32 off
            eager32 = ArtifactModel(copy.deepcopy(model.model).eval().float().fuse())
            want = eager32(x.float())
            out["fp32"] = {}
            for name in ("torchscript_f32", "onnx"):
                got = backends[name](x)
                box = float((got[..., :4] - want[..., :4]).abs().max())
                score = float((got[..., 4:] - want[..., 4:]).abs().max())
                if got.shape != want.shape or not (box <= BOX_ATOL_PX and score <= EXPORT_SCORE_ATOL):
                    raise AssertionError(f"{name} float32 against the eager forward: {tuple(got.shape)} box err {box} "
                                         f"px, score err {score}")
                out["fp32"][name] = {"box_err_px": box, "score_err": score}
            got16, want16 = backends["torchscript_bf16"](x), pred.model(x)[0].float()
            if not bool(torch.isfinite(got16).all()):
                raise AssertionError("the bf16 torchscript artifact gave non-finite predictions")
            out["bf16_vs_eager_bf16"] = {"box_err_px": float((got16[..., :4] - want16[..., :4]).abs().max()),
                                         "score_err": float((got16[..., 4:] - want16[..., 4:]).abs().max())}
        del eager32, want, got, got16, want16
        lap("fp32_checks")

        out["predict"], results = {}, {}
        for name, p in paths.items():  # YOLO(path).predict at batch 8: one NMS call, two launches
            art = YOLO(p)
            for _ in range(3):  # warm-up: TorchScript's profiling executor optimizes the graph over its first calls
                art.predict(frames, conf=c["conf"], batch=c["batch"], verbose=False)
            n_checks = len(checks)
            cuda_nms.reset_counts()
            t0 = time.perf_counter()
            results[name] = art.predict(frames, conf=c["conf"], batch=c["batch"], verbose=False)
            wall = time.perf_counter() - t0
            cnt = nms_counts()
            n_det = [len(r.boxes) for r in results[name]]
            if cnt != {"calls": 1, "launches": 2} or len(checks) - n_checks != 1 or not sum(n_det) or not all(
                    np.isfinite(r.boxes.data).all() for r in results[name]):
                raise AssertionError(f"YOLO({name}).predict: NMS {cnt}, {len(checks) - n_checks} checked, detections "
                                     f"{n_det}")
            out["predict"][name] = {"img_per_s": c["batch"] / wall, "n_det": n_det, "nms": cnt,
                                    "speed_ms_per_img": results[name][0].speed}
        lap("predict")

        meta = json.loads(Path(paths["torchscript_f32"] + ".json").read_text())
        module = torch.jit.load(paths["torchscript_f32"], map_location=model.device).eval()
        server, served = kserve_server(module, meta, c["endpoint"], model.device)
        url = f"http://127.0.0.1:{server.server_address[1]}/{c['endpoint']}"
        remote = YOLO(url)
        if remote.backend.kind != "triton" or remote.task != "detect" or remote.overrides.get("imgsz") != c["imgsz"]:
            raise AssertionError(f"YOLO({url}): {remote.backend.kind}, task {remote.task}, {remote.overrides}")
        for _ in range(3):  # warm-up, as the direct call's
            remote.predict(frames, conf=c["conf"], batch=c["batch"], verbose=False)
        cuda_nms.reset_counts()
        t0 = time.perf_counter()
        res_url = remote.predict(frames, conf=c["conf"], batch=c["batch"], verbose=False)
        wall = time.perf_counter() - t0
        cnt = nms_counts()
        same = [bool(np.array_equal(a.boxes.data, b.boxes.data)) for a, b in zip(res_url, results["torchscript_f32"])]
        if cnt != {"calls": 1, "launches": 2} or not all(same):
            raise AssertionError(f"YOLO(url).predict: NMS {cnt}, detections equal to the direct call's: {same}")
        out["served"] = {"url": url, "img_per_s": c["batch"] / wall, "nms": cnt, "equal_to_direct": True,
                         "n_det": [len(r.boxes) for r in res_url]}
        lap("served")

        with torch.inference_mode():  # the forward alone (the served one with its HTTP round trip), per image
            out["ms_per_img_batch8"] = {
                "eager_bf16": per_image_ms(pred.model, x),
                "torchscript_bf16": per_image_ms(backends["torchscript_bf16"], x),
                "torchscript_f32": per_image_ms(backends["torchscript_f32"], x),
                "onnx_runner_f32": per_image_ms(backends["onnx"], x),
                "served_round_trip_f32": per_image_ms(remote.backend, x),
                "nvidia_smi": smi}
        out["served"]["requests"] = served["requests"]
        lap("timing")

        data = dense.result()[0]
        lap("dataset_wait")
        cuda_nms.reset_counts()
        n_checks = len(checks)
        eager_val = model.val(data=str(data), rect=False, dtype="float32", batch=c["batch"], imgsz=c["imgsz"],
                              plots=False, verbose=False)
        art = YOLO(paths["torchscript_f32"])
        art_val = art.val(data=str(data), plots=False, verbose=False)
        cnt = nms_counts()
        n_batches = 2 * math.ceil(c["n_val"] / c["batch"])
        diff = {k: abs(art_val[k] - eager_val[k]) for k in eager_val}
        # the random weights score no true positive, so the detections themselves are compared: their scores and
        # classes, image by image as the validators accumulated them
        det = {k: [np.concatenate(v.validator.stats[k]) for v in (model, art)] for k in ("conf", "pred_cls")}
        same_dets = (det["conf"][0].shape == det["conf"][1].shape and len(det["conf"][0]) > 0
                     and np.array_equal(det["pred_cls"][0], det["pred_cls"][1])
                     and float(np.abs(det["conf"][0] - det["conf"][1]).max()) <= EXPORT_SCORE_ATOL)
        if (cnt != {"calls": n_batches, "launches": 2 * n_batches} or len(checks) - n_checks != n_batches
                or art.validator.args.rect or max(diff.values()) > EXPORT_MAP_ATOL or not same_dets
                or not all(0.0 <= v <= 1.0 for v in art_val.values())):
            raise AssertionError(f"val: eager {eager_val}, torchscript {art_val}, NMS {cnt}, rect "
                                 f"{art.validator.args.rect}, detections equal {same_dets}")
        out["val"] = {"eager_f32": eager_val, "torchscript_f32": art_val, "max_abs_diff": max(diff.values()),
                      "n_det": len(det["conf"][0]), "det_conf_max_abs_diff":
                          float(np.abs(det["conf"][0] - det["conf"][1]).max()), "nms": cnt}
        lap("val")
    finally:
        nms_ops.greedy_keep = kernel_keep
        writer.shutdown(cancel_futures=True)
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(ch["equal"] for ch in checks):
        raise AssertionError(f"export: keep masks unequal to the plain keep: {[ch for ch in checks if not ch['equal']]}")
    out["nms_keep_checks"] = {"calls": len(checks), "all_equal_plain": True, "K": sorted({ch["K"] for ch in checks})}
    counted = [v["nms"] for v in out["predict"].values()] + [out["served"]["nms"], out["val"]["nms"]]
    out["nms_calls"], out["nms_launches"] = sum(n["calls"] for n in counted), sum(n["launches"] for n in counted)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
    from drone_yolo_tpu_torch.nn.model import DetectionModel
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_build, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats, bn_stats_reference
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS, s2_bwd_reference
    from drone_yolo_tpu_torch.ops.letterbox import letterbox_u8
    from drone_yolo_tpu_torch.ops.nms import (
        compact, greedy_keep, greedy_keep_reference, non_max_suppression, select_candidates, suppression_words_reference,
        sweep_reference)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. preflight -----------------------------------------------------------
    t = time.perf_counter()
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
    nvcc_version = sh(cuda_build.find_nvcc(), "--version").splitlines()[-1]
    emit("preflight", t, python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version, device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi)

    # 2. build: one nvcc per source, started together ---------------------------
    t = time.perf_counter()
    libraries = (cuda_nms.LIBRARY, cuda_s2bwd.LIBRARY, cuda_bnstats.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(), libraries))
    for lib in libraries:
        lib.load()
    build_s = time.perf_counter() - t
    sass = sass_counts(built[libraries.index(cuda_s2bwd.LIBRARY)])
    if "cuobjdump" not in sass:
        bf16_kernels = {n: c for n, c in sass.items() if n.startswith(("s2_dw_mma", "s2_dx_mma"))}
        if {n.split("<")[0] for n in bf16_kernels} != {"s2_dw_mma", "s2_dx_mma"} or not all(
                c["HMMA"] + c["HGMMA"] > 0 for c in bf16_kernels.values()):
            raise AssertionError(f"every bf16 stride-2 kernel should run on tensor cores, SASS: {sass}")
    emit("build", t, libraries={p.name: cuda_build.report_path(p).read_text().strip().splitlines() for p in built},
         build_s=build_s, s2_sass_tensor_core_instructions=sass,
         nms_workspace_bytes={f"B=8,K={k}": cuda_nms.workspace_bytes(8, k) for k in (1024, VAL["pre_nms_topk"])})

    # 3. kernels vs plain -----------------------------------------------------
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = []
    for b, k in NMS_CASES:
        for thr in (0.45, 0.7):
            boxes = clustered_boxes(rng, b, k, clusters=12 if k <= 1024 else 48).to(dev)
            valid = torch.from_numpy(rng.random((b, k)) > 0.1).to(dev)
            words = cuda_nms.suppression_words_cuda(boxes, valid, thr)
            got = greedy_keep(boxes, valid, thr)
            torch.cuda.synchronize()
            for i in range(b):  # image by image: the plain words take K * K * 8 bytes a image
                want_words = suppression_words_reference(boxes[i:i + 1], valid[i:i + 1], thr)
                if not torch.equal(words[i:i + 1], want_words):
                    raise AssertionError(f"B={b} K={k} thr={thr} image {i}: kernel and plain suppression words differ "
                                         f"in {int((words[i:i + 1] != want_words).sum())} words")
                del want_words
            want = greedy_keep_reference(boxes, valid, thr)
            kept, suppressed = int(got.sum()), int((valid & ~got).sum())
            if not torch.equal(got, want):
                raise AssertionError(f"B={b} K={k} thr={thr}: kernel and plain keep masks differ in {int((got != want).sum())} places")
            if k <= NMS_SWEEP_PLAIN_MAX_K and not torch.equal(got, sweep_reference(words, valid)):
                raise AssertionError(f"B={b} K={k} thr={thr}: the sweep kernel and sweep_reference over the same words differ")
            if kept == 0 or suppressed == 0:
                raise AssertionError(f"B={b} K={k} thr={thr}: case must keep and suppress (kept {kept}, suppressed {suppressed})")
            cases.append({"B": b, "K": k, "thr": thr, "kept": kept, "suppressed": suppressed, "keep_equal": True,
                          "words_equal": True, "sign_bit_words": int((words < 0).sum()),
                          "sweep_vs_plain_sweep": k <= NMS_SWEEP_PLAIN_MAX_K})
            del boxes, valid, words, got, want
    sites = s2_sites(DetectionModel(FLAGSHIP, nc=TRAIN["nc"]), TRAIN["batch"], TRAIN["imgsz"])
    n_sites = {k: sum(s["k"] == k for s in sites) for k in KINDS}
    if n_sites != {3: 8, 1: 4}:
        raise AssertionError(f"the flagship should have 8 k=3 and 4 k=1 stride-2 sites, found {n_sites}")
    s2_cases = []
    for i, site in enumerate(sites):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = s2_site_inputs(site, dtype, seed=i)
            dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, site["k"], site["need_dx"])
            torch.cuda.synchronize()
            dx_p, dw_p = s2_bwd_reference(x, w, dy, site["k"], site["need_dx"])
            name = str(dtype).split(".")[1]
            row = {"site": site["name"], "k": site["k"], "dtype": name, "x": site["x"]}
            pairs = [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else [])
            if dtype == torch.float32:
                dx64, dw64 = s2_bwd_reference(x.double(), w.double(), dy.double(), site["k"], site["need_dx"])
                truth = {"dw": dw64, "dx": dx64}
            for what, got, want in pairs:
                tol = dict(S2_TOL[name][what])
                tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{site['name']} {name} {what}: {m}")
                row.update({f"{what}_err": float((got - want).abs().max()), f"{what}_scale": float(want.abs().max()),
                            f"{what}_atol": tol["atol"]})
                if dtype == torch.float32:
                    row.update({f"{what}_err_f64": float((got.double() - truth[what]).abs().max()),
                                f"{what}_plain_err_f64": float((want.double() - truth[what]).abs().max())})
            if not site["need_dx"] and dx is not None:
                raise AssertionError(f"{site['name']}: dx computed where it is not needed")
            s2_cases.append(row)
            del x, w, dy, dx, dw, dx_p, dw_p
    bn = bn_sites(DetectionModel(FLAGSHIP, nc=TRAIN["nc"]), TRAIN["batch"], TRAIN["imgsz"])
    if len(bn) != 77:
        raise AssertionError(f"the flagship should have 77 train-mode BN sites, found {len(bn)}")
    bn_cases = []
    for i, site in enumerate(bn):
        for dtype in (torch.bfloat16, torch.float32):
            x = site_input(site["x"], dtype, seed=i)
            s_k, q_k = cuda_bnstats.bn_stats_cuda(x)
            torch.cuda.synchronize()
            errs = bn_stats_errors(x, s_k, q_k)
            if not (errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1):
                raise AssertionError(f"BN statistics at {site['name']} {dtype}: kernel vs plain {errs}")
            bn_cases.append({"site": site["name"], "x": site["x"], "dtype": str(dtype).split(".")[1], **errs})
            del x, s_k, q_k
    largest = max(bn, key=lambda b: math.prod(b["x"]))
    x = site_input(largest["x"], torch.bfloat16, seed=1000)
    g = torch.Generator(device="cuda").manual_seed(1001)
    g_s, g_q = (torch.randn(largest["x"][1], generator=g, device="cuda") for _ in range(2))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    torch.autograd.backward(bn_stats(xa), (g_s, g_q))
    torch.autograd.backward(bn_stats_reference(xb), (g_s, g_q))
    torch.testing.assert_close(xa.grad.float(), xb.grad.float(), rtol=2**-8, atol=1e-6)  # one bf16 step
    bn_grad = {"site": largest["name"], "x": largest["x"], "dtype": "bfloat16",
               "max_abs_err": float((xa.grad.float() - xb.grad.float()).abs().max()), "rtol": 2**-8}
    del x, xa, xb
    emit("kernel_vs_plain", t, nms_cases=cases, s2_tolerances=S2_TOL, s2_sum_floor=S2_SUM_FLOOR, s2_cases=s2_cases,
         bn_rtol=BN_RTOL, bn_atol=BN_ATOL, bn_sites=len(bn), bn_cases=bn_cases, bn_grad=bn_grad)

    # 4. slice: the port's predict path, end to end ---------------------------
    t = time.perf_counter()
    model = YOLO(FLAGSHIP)  # the card is the default device
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(8)]
    cuda_nms.reset_counts()
    timings = {}
    for batch, reps in ((1, 10), (8, 5)):
        source = frames[:batch]
        model.predict(source, verbose=False)  # warm-up (first call builds the fused bfloat16 copy)
        walls, speeds = [], []
        for _ in range(reps):
            t_call = time.perf_counter()
            res = model.predict(source, verbose=False)
            walls.append(time.perf_counter() - t_call)
            speeds.append(res[0].speed)
        timings[f"batch{batch}"] = {
            **{f"{k}_ms_per_img": float(np.mean([s[k] for s in speeds])) for k in ("preprocess", "inference", "postprocess")},
            "img_per_s": batch / float(np.median(walls)),
            "n_det": [len(r.boxes) for r in res],
        }
    res0 = model.predict(frames, conf=0.0, verbose=False)
    mixed = [frames[0], rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)]
    res_mixed = model.predict(mixed, conf=0.0, verbose=False)
    nms_calls, launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
    if [r.orig_shape for r in res_mixed] != [(720, 1280), (1080, 1920)] or not all(
            len(r.boxes) > 0 and np.isfinite(r.boxes.data).all() for r in res_mixed):
        raise AssertionError("mixed-shape predict gave wrong shapes, no or non-finite detections")
    for frame in mixed:
        on_card = letterbox_u8(torch.from_numpy(frame).to(dev)[None], model.predictor.imgsz).cpu()
        if not torch.equal(on_card, letterbox_u8(torch.from_numpy(frame)[None], model.predictor.imgsz)):
            raise AssertionError(f"uint8 letterbox of a {frame.shape} frame differs between the card and the CPU")
    if nms_calls == 0 or launches != 2 * nms_calls:
        raise AssertionError(f"the predict path called the greedy-NMS kernels {nms_calls} times with {launches} launches")
    if not all(len(r.boxes) > 0 and r.boxes.data.shape[1] == 6 and np.isfinite(r.boxes.data).all() for r in res0):
        raise AssertionError("conf=0.0 predict gave no or non-finite detections")

    pred = model.predictor
    args = pred.args
    x = pred.preprocess(frames)
    with torch.inference_mode():  # one set of predictions, NMS with the kernel and with the plain keep
        preds, _ = pred.model(x)
        dets, n_valid = non_max_suppression(preds, args.conf, args.iou, args.max_det, pre_topk=1024)
        cand_boxes, top_scores, cls_idx, valid, off_boxes, cand_extra = select_candidates(preds, args.conf, 1024)
        keep_plain = greedy_keep_reference(off_boxes, valid, args.iou)
        dets_plain, n_plain = compact(keep_plain, cand_boxes, top_scores, cls_idx, args.max_det, cand_extra)
    if not (torch.equal(dets, dets_plain) and torch.equal(n_valid, n_plain)):
        raise AssertionError("NMS step with the kernel differs from the step with the plain keep")
    if not bool(valid.all()) or valid.shape != (8, 1024):
        raise AssertionError(f"conf=0.0 should make all 1024 candidates valid, got {int(valid.sum())} of {tuple(valid.shape)}")

    f32 = copy.deepcopy(model.model)
    f32.load_state_dict(spread_weights(f32.state_dict(), np.random.default_rng(1)))
    with torch.inference_mode():
        f32 = f32.fuse().float()
        x1 = x[:1].float()
        preds_card = f32(x1)[0].cpu()
        preds_cpu = f32.cpu()(x1.cpu())[0]
    del f32
    box_err = float((preds_card[..., :4] - preds_cpu[..., :4]).abs().max())
    score_rel_err = float(((preds_card[..., 4:] - preds_cpu[..., 4:]).abs() / preds_cpu[..., 4:]).max())
    if not (box_err <= BOX_ATOL_PX and score_rel_err <= SCORE_RTOL):
        raise AssertionError(f"float32 predictions card vs CPU: box err {box_err} px, score relative err {score_rel_err}")
    emit("slice", t, model=FLAGSHIP, dtype="bfloat16", frame_hw=list(FRAME_HW), imgsz=pred.imgsz,
         nms_calls=nms_calls, nms_launches=launches, timings=timings, conf0_n_valid=n_valid.tolist(), step_equals_plain_keep=True,
         mixed_shapes={"frames": [list(f.shape[:2]) for f in mixed], "n_det": [len(r.boxes) for r in res_mixed],
                       "letterbox_u8_card_equals_cpu": True},
         fp32_card_vs_cpu={"box_err_px": box_err, "score_rel_err": score_rel_err, "box_atol_px": BOX_ATOL_PX,
                           "score_rtol": SCORE_RTOL, "score_range": [float(preds_cpu[..., 4:].min()), float(preds_cpu[..., 4:].max())]},
         anchors=int(preds.shape[1]))

    # 5. train: the port's train step, with the kernels and with stock autograd --------
    t = time.perf_counter()
    batch = synthetic_batch(np.random.default_rng(0), TRAIN["batch"], TRAIN["imgsz"], TRAIN["nc"])
    modes = {"kernel": ("cuda", None), "stock": (None, None), "both": ("cuda", "cuda")}  # (s2grad, bnstats)
    runs, s2_calls, s2_launches, s2_impls, bn_counts, trainers = {}, {}, {}, {}, {}, {}
    for run, (s2grad, bnstats) in modes.items():
        trainer = BaseTrainer(overrides=dict(model=FLAGSHIP, batch=TRAIN["batch"], imgsz=TRAIN["imgsz"], nbs=TRAIN["batch"],
                                             optimizer="SGD", amp=True, s2grad=s2grad, bnstats=bnstats),
                              train_loader=[batch] * TRAIN["steps"], data={"nc": TRAIN["nc"]})
        torch.cuda.reset_peak_memory_stats()
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        steps = trainer.run_steps()
        s2_calls[run], s2_launches[run] = dict(cuda_s2bwd.s2_bwd_cuda.calls), dict(cuda_s2bwd.s2_bwd_cuda.launches)
        s2_impls[run] = {impl: dict(c) for impl, c in cuda_s2bwd.s2_bwd_cuda.impl_calls.items()}
        bn_counts[run] = {"calls": cuda_bnstats.bn_stats_cuda.calls, "launches": cuda_bnstats.bn_stats_cuda.launches,
                          "contiguous_copies": cuda_bnstats.bn_stats_cuda.copies}
        ms = [r["ms"] for r in steps[1:]]  # the first step builds cuDNN's plans
        runs[run] = {"s2grad": s2grad, "bnstats": bnstats, "loss": [r["loss"] for r in steps], "items": [r["items"] for r in steps],
                     "step_ms_median": float(np.median(ms)), "img_per_s": TRAIN["batch"] / float(np.median(ms)) * 1e3,
                     "first_step_ms": steps[0]["ms"], "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "s2_calls": s2_calls[run], "s2_launches": s2_launches[run], "s2_impl_calls": s2_impls[run],
                     "s2_contiguous_copies": cuda_s2bwd.s2_bwd_cuda.copies,
                     "bn_stats": bn_counts[run]}
        trainers[run] = trainer
    per_step = {cuda_s2bwd.NAMES[k]: n_sites[k] for k in KINDS}
    want_launches = {cuda_s2bwd.NAMES[k]: TRAIN["steps"] * sum(3 if s["need_dx"] else 2 for s in sites if s["k"] == k) for k in KINDS}
    for run in ("kernel", "both"):
        if s2_calls[run] != {n: TRAIN["steps"] * c for n, c in per_step.items()} or s2_launches[run] != want_launches:
            raise AssertionError(f"{run} run: stride-2 backward calls {s2_calls[run]} and launches {s2_launches[run]}, "
                                 f"expected {per_step} calls per step and {want_launches} launches")
        tensor_cores = cuda_s2bwd.IMPLS[torch.bfloat16]
        if s2_impls[run][tensor_cores] != s2_calls[run]:
            raise AssertionError(f"{run} run: every bf16 stride-2 call should run on {tensor_cores}, got {s2_impls[run]}")
    if any(s2_calls["stock"].values()):
        raise AssertionError(f"the stock run called the stride-2 backward kernel: {s2_calls['stock']}")
    want_bn = {"calls": TRAIN["steps"] * len(bn), "launches": TRAIN["steps"] * len(bn)}
    if {k: bn_counts["both"][k] for k in want_bn} != want_bn:
        raise AssertionError(f"both run: BN-statistics kernel {bn_counts['both']}, expected {want_bn}")
    if bn_counts["kernel"]["calls"] or bn_counts["stock"]["calls"]:
        raise AssertionError(f"runs without bnstats called the BN-statistics kernel: {bn_counts}")
    loss_s = np.array(runs["stock"]["loss"])
    loss_rel = {}
    for run in ("kernel", "both"):
        loss_k = np.array(runs[run]["loss"])
        if not (np.isfinite(loss_k).all() and np.isfinite(loss_s).all()):
            raise AssertionError(f"non-finite train losses: {run} {loss_k}, stock {loss_s}")
        loss_rel[run] = np.abs(loss_k - loss_s) / np.abs(loss_s)
        if not (loss_rel[run] <= TRAIN_LOSS_RTOL).all():
            raise AssertionError(f"train losses of the {run} run {loss_k} differ from stock {loss_s} by {loss_rel[run]}")
    in_turns = {run: [] for run in modes}  # the three paths again, in turns on one card: median ms of 5 steps each
    for run in (*modes, *reversed(modes)):
        in_turns[run].append(float(np.median([r["ms"] for r in trainers[run].run_steps(5)])))
    emit("train", t, model=FLAGSHIP, **{k: v for k, v in TRAIN.items()}, dtype="bfloat16 autocast", optimizer="SGD",
         kernel=runs["kernel"], stock=runs["stock"], both=runs["both"],
         loss_rel_diff={k: v.tolist() for k, v in loss_rel.items()}, loss_rtol=TRAIN_LOSS_RTOL,
         s2_calls_per_step=per_step, bn_stats_calls_per_step=len(bn), in_turns_step_ms=in_turns)
    kernel_trainer, both_trainer = trainers["kernel"], trainers["both"]
    del trainers

    # 6. validate: the EMA weights of the run with both kernels, multi-label NMS at K = 4096 --------
    t = time.perf_counter()
    both_trainer.val_loader = [synthetic_batch(np.random.default_rng(100 + i), VAL["batch"], VAL["imgsz"], VAL["nc"], val=True)
                               for i in range(VAL["batches"])]
    validation = {}
    for conf in (0.001, 0.0):
        if both_trainer.validator is not None:
            both_trainer.validator.args.conf = conf
        cuda_nms.reset_counts()
        t_call = time.perf_counter()
        metrics = both_trainer.validate()
        wall = time.perf_counter() - t_call
        val_calls, val_launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
        validator = both_trainer.validator
        if validator.args.conf != conf or validator.args.pre_nms_topk != VAL["pre_nms_topk"]:
            raise AssertionError(f"validator ran at conf {validator.args.conf}, pre_nms_topk {validator.args.pre_nms_topk}")
        if val_calls != VAL["batches"] or val_launches != 2 * val_calls:
            raise AssertionError(f"validation called the greedy-NMS kernels {val_calls} times ({val_launches} launches) "
                                 f"for {VAL['batches']} batches")
        values = [metrics[k] for k in validator.metrics.keys]
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
            raise AssertionError(f"validation metrics out of [0, 1]: {metrics}")
        with torch.inference_mode():  # one batch's predictions: the NMS step with the kernel and with the plain keep
            x = validator.preprocess(both_trainer.val_loader[0])
            val_preds = validator.forward(x)
            dets, n_valid = validator.postprocess(val_preds)
            cand_boxes, top_scores, cls_idx, val_valid, val_off, cand_extra = select_candidates(
                val_preds, conf, VAL["pre_nms_topk"], multi_label=True)
            val_keep_plain = greedy_keep_reference(val_off, val_valid, validator.args.iou)
            dets_plain, n_plain = compact(val_keep_plain, cand_boxes, top_scores, cls_idx, validator.args.max_det,
                                          cand_extra)
        if val_valid.shape != (VAL["batch"], VAL["pre_nms_topk"]):
            raise AssertionError(f"validation NMS ran on {tuple(val_valid.shape)} candidates, expected K = {VAL['pre_nms_topk']}")
        if not (torch.equal(dets, dets_plain) and torch.equal(n_valid, n_plain)):
            raise AssertionError(f"conf {conf}: validation NMS step with the kernel differs from the step with the plain keep")
        if conf == 0.0 and not bool(val_valid.all()):
            raise AssertionError(f"conf=0.0 should make all {VAL['pre_nms_topk']} candidates valid, got {int(val_valid.sum())}")
        validation[str(conf)] = {"metrics": metrics, "nms_calls": val_calls, "nms_launches": val_launches, "K": int(val_valid.shape[1]),
                                 "valid_candidates": int(val_valid.sum()), "n_det": n_valid.tolist(),
                                 "step_equals_plain_keep": True, "speed_ms_per_img": validator.speed,
                                 "img_per_s": validator.seen / wall, "images": validator.seen}
    emit("validate", t, model=FLAGSHIP, dtype=validator.args.dtype, weights="EMA of the s2grad+bnstats run",
         iou=validator.args.iou, max_det=validator.args.max_det, runs=validation)

    # 7. the kernels at the main path's shapes ------------------------------------
    t = time.perf_counter()

    def nms_timing(boxes, valid, thr, keep_plain) -> dict:
        """The greedy-NMS kernel at one shape of the main path: its time, its plain version's, and its bound."""
        keep = greedy_keep(boxes, valid, thr)
        if not torch.equal(keep, keep_plain):
            raise AssertionError(f"kernel and plain keep masks differ at B, K = {tuple(valid.shape)}")
        b, k = valid.shape
        n_bytes = b * k * (16 + 1 + 1)  # boxes and valid read once, keep written once
        n_ops = IOU_OPS * ious_needed(boxes, valid, keep, thr)
        bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_FP32_PER_S * 1e3
        by_kernel = profile_device(lambda: greedy_keep(boxes, valid, thr), steps=20)["top"]
        return {"B": b, "K": k, "thr": thr, "kept": int(keep.sum()), "valid": int(valid.sum()),
                "max_abs_err": float((keep.int() - keep_plain.int()).abs().max()),
                "workspace_bytes": cuda_nms.workspace_bytes(b, k),
                "device_ms_by_kernel": {r["name"]: r["device_ms"] for r in by_kernel},
                **kernel_times(lambda: greedy_keep(boxes, valid, thr), reps=20),
                **kernel_times(lambda: greedy_keep_reference(boxes, valid, thr), reps=3, prefix="plain_"),
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    nms_predict = nms_timing(off_boxes, valid, args.iou, keep_plain)  # predict: B=8, K=1024, conf 0
    nms_val = nms_timing(val_off, val_valid, validator.args.iou, val_keep_plain)  # validate: B=8, K=4096, conf 0
    del val_off, val_valid, val_keep_plain
    val_calls = sum(v["nms_calls"] for v in validation.values())
    val_launches = sum(v["nms_launches"] for v in validation.values())
    kernels = [{
        "name": "greedy_nms", "route": "cuda", "impl": "cuda", "source": "drone_yolo_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "drone_yolo_tpu/ops/pallas_nms.py:89", "launches": launches + val_launches, "calls": nms_calls + val_calls,
        "launches_by_path": {"predict": launches, "validate": val_launches}, "match": True,
        **{k: nms_predict[k] for k in ("max_abs_err", "ms", "event_ms", "plain_ms", "plain_event_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": nms_predict, "shape_k4096": nms_val,
    }]
    replaces = {3: "drone_yolo_tpu/ops/pallas_s2bwd.py:203", 1: "drone_yolo_tpu/ops/pallas_s2bwd.py:220"}
    for kind in KINDS:
        name = cuda_s2bwd.NAMES[kind]
        p = KINDS[kind]
        kind_sites = [s for s in sites if s["k"] == kind]
        inputs = [s2_site_inputs(site, torch.bfloat16, seed=100 + i) for i, site in enumerate(kind_sites)]
        calls = {  # one train step's calls at these sites: the kernel, its plain version, cuDNN's backward
            "": lambda: [cuda_s2bwd.s2_bwd_cuda(x, w, dy, kind, site["need_dx"]) for site, (x, w, dy) in zip(kind_sites, inputs)],
            "plain_": lambda: [s2_bwd_reference(x, w, dy, kind, site["need_dx"]) for site, (x, w, dy) in zip(kind_sites, inputs)],
            "library_": lambda: [torch.ops.aten.convolution_backward(dy, x, w, None, [2, 2], [p, p], [1, 1], False, [0, 0], 1,
                                                                     [site["need_dx"], True, False])
                                 for site, (x, w, dy) in zip(kind_sites, inputs)]}
        times = {}
        for prefix, fn in calls.items():
            times.update(kernel_times(fn, reps=2 if prefix == "plain_" else 5, prefix=prefix))
        per_site = []
        for site, (x, w, dy) in zip(kind_sites, inputs):  # each site alone: the kernel against cuDNN there
            n_bytes, n_ops = s2_cost(site)
            b, ci, h, wd = site["x"]
            row = {"site": site["name"], "x": site["x"], "w": site["w"], "need_dx": site["need_dx"],
                   "plan": cuda_s2bwd.device_plan(x.device, b, ci, h, wd, site["w"][0], kind, torch.bfloat16)._asdict(),
                   "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3, "ops_ms": n_ops / PEAK_BF16_PER_S * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row.update(kernel_times(lambda x=x, w=w, dy=dy, nd=site["need_dx"]: cuda_s2bwd.s2_bwd_cuda(x, w, dy, kind, nd),
                                    reps=10, site=True))
            row.update(kernel_times(lambda x=x, w=w, dy=dy, nd=site["need_dx"]: torch.ops.aten.convolution_backward(
                dy, x, w, None, [2, 2], [p, p], [1, 1], False, [0, 0], 1, [nd, True, False]), reps=10, prefix="library_",
                site=True))
            row.update(tflop_per_s=n_ops / row["ms"] / 1e9, gb_per_s=n_bytes / row["ms"] / 1e6,
                       bound_share=row["bound_ms"] / row["ms"], library_bound_share=row["bound_ms"] / row["library_ms"],
                       vs_library=row["ms"] / row["library_ms"])
            per_site.append(row)
        del inputs, x, w, dy
        bf16 = [c for c in s2_cases if c["k"] == kind and c["dtype"] == "bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "impl": cuda_s2bwd.IMPLS[torch.bfloat16], "source": "drone_yolo_tpu_torch/csrc/s2_bwd.cu",
            "replaces": replaces[kind], "launches": s2_launches["kernel"][name], "calls": s2_calls["kernel"][name],
            "launches_per_step": s2_launches["kernel"][name] // TRAIN["steps"], "calls_per_step": per_step[name],
            "max_abs_err": max(max(c["dw_err"], c.get("dx_err", 0.0)) for c in bf16), "match": True, **times,
            "bound_ms": sum(r["bound_ms"] for r in per_site),
            "bound_by": "bytes" if sum(r["bytes_ms"] for r in per_site) >= sum(r["ops_ms"] for r in per_site) else "operations",
            "per": "train step: one bf16 call at each of the flagship's sites (batch 8, 640 px); ms is device time "
                   "(torch.profiler), event_ms CUDA events around back-to-back calls; library: cuDNN convolution_backward; "
                   "sites: each site alone, kernel and cuDNN, each ms from its ms_source",
            "sites_ms_from_cuda_events": sum(r[f"{q}ms_source"] == "cuda_events" for r in per_site for q in ("", "library_")),
            "sites": per_site,
        })
    xs = [site_input(site["x"], torch.bfloat16, seed=200 + i) for i, site in enumerate(bn)]
    times = {}  # one train step's 77 calls: the kernel, its plain version (the stock path's cast and two reductions),
    for prefix, fn in {"": lambda: [cuda_bnstats.bn_stats_cuda(x) for x in xs],  # and torch.batch_norm_stats
                       "plain_": lambda: [bn_stats_reference(x) for x in xs],
                       "library_": lambda: [torch.batch_norm_stats(x, 1e-3) for x in xs]}.items():
        times.update(kernel_times(fn, reps=5, prefix=prefix))
    per_site = [{"site": site["name"], "x": site["x"], "plan": cuda_bnstats.split_channel(x.shape[0] * x.shape[2] * x.shape[3]),
                 "bytes_ms": (2 * x.numel() + 2 * 4 * x.shape[1]) / PEAK_BYTES_PER_S * 1e3,  # bf16 x read, (2, C) f32 written
                 "ops_ms": BN_OPS * x.numel() / PEAK_FP32_PER_S * 1e3} for site, x in zip(bn, xs)]
    by_shape = {}  # each distinct shape alone (device time by torch.profiler): the kernel and torch.batch_norm_stats;
    for site, x in zip(bn, xs):  # 100 calls a trace, as a few microseconds of work each can leave a trace empty
        if site["x"] not in by_shape:
            by_shape[site["x"]] = {}
            for prefix, fn in (("", lambda x=x: cuda_bnstats.bn_stats_cuda(x)),
                               ("library_", lambda x=x: torch.batch_norm_stats(x, 1e-3))):
                ms, source = device_ms(fn, reps=100, fallback=True)
                by_shape[site["x"]].update({f"{prefix}ms": ms, f"{prefix}ms_source": source})
    del xs
    for row in per_site:
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row.update(by_shape[row["x"]])
        row.update(bound_share=row["bound_ms"] / row["ms"], library_bound_share=row["bound_ms"] / row["library_ms"],
                   vs_library=row["ms"] / row["library_ms"])
    kernels.append({
        "name": "bn_stats", "route": "cuda", "impl": "cuda", "source": "drone_yolo_tpu_torch/csrc/bn_stats.cu",
        "replaces": "tools/bn_stat_probe.py:70", "launches": bn_counts["both"]["launches"], "calls": bn_counts["both"]["calls"],
        "launches_per_step": bn_counts["both"]["launches"] // TRAIN["steps"], "calls_per_step": len(bn),
        "max_abs_err": max(max(c["sum_err"], c["sumsq_err"]) for c in bn_cases if c["dtype"] == "bfloat16"),
        "max_err_over_tol": max(max(c["sum_err_over_tol"], c["sumsq_err_over_tol"]) for c in bn_cases), "match": True,
        **times, "bound_ms": sum(r["bound_ms"] for r in per_site),
        "bound_by": "bytes" if sum(r["bytes_ms"] for r in per_site) >= sum(r["ops_ms"] for r in per_site) else "operations",
        "per": "train step: one bf16 call at each of the flagship's 77 BN inputs (batch 8, 640 px); ms is device time "
               "(torch.profiler), event_ms CUDA events around back-to-back calls; plain: the stock path's cast and two "
               "reductions; library: torch.batch_norm_stats; sites: each distinct shape alone, kernel and library, each "
               "ms from its ms_source",
        "sites_ms_sum": sum(r["ms"] for r in per_site),
        "sites_ms_from_cuda_events": sum(r[f"{q}ms_source"] == "cuda_events" for r in per_site for q in ("", "library_")),
        "sites": per_site,
    })
    emit("kernels", t, kernels=kernels)

    # 8. profile ---------------------------------------------------------------
    t = time.perf_counter()
    train_hyp = kernel_trainer._warmup_hyp(kernel_trainer.ni, 0)
    both_hyp = both_trainer._warmup_hyp(both_trainer.ni, 0)
    emit("profile", t, predict={"batch": len(frames), **profile_device(lambda: model.predict(frames, verbose=False), steps=5)},
         train={"batch": TRAIN["batch"], "s2grad": "cuda",
                **profile_device(lambda: kernel_trainer.train_step(batch, *train_hyp)[0].item(), steps=3)},
         train_both={"batch": TRAIN["batch"], "s2grad": "cuda", "bnstats": "cuda",
                     **profile_device(lambda: both_trainer.train_step(batch, *both_hyp)[0].item(), steps=3)})

    # 9. loop: the epoch loop over a dataset on disk -------------------------------
    t = time.perf_counter()
    loop = run_loop(len(bn), n_sites)
    for kern in kernels:
        n = loop["counts"]["launches"][kern["name"]]
        kern["launches"] += n
        kern.setdefault("launches_by_path", {"train": kern["launches"] - n})["loop"] = n
    emit("loop", t, **{k: v for k, v in loop.items() if k != "counts"}, counts=loop["counts"])

    # 10. track: the drone-video pipeline, detect + ByteTrack + pose + geo ------------------
    t = time.perf_counter()
    track = run_track()
    nms_row = kernels[0]
    nms_row["launches"] += track["nms_launches"]
    nms_row["calls"] += track["nms_calls"]
    nms_row["launches_by_path"]["track"] = track["nms_launches"]
    emit("track", t, **track)

    # 11. botsort: BoT-SORT with camera-motion compensation over a panning clip, tiled inference of a 4K frame ------
    t = time.perf_counter()
    bots = run_botsort()
    nms_row["launches"] += bots["nms_launches"]
    nms_row["calls"] += bots["nms_calls"]
    nms_row["launches_by_path"]["botsort"] = bots["nms_launches_botsort"]
    nms_row["launches_by_path"]["tiled"] = bots["nms_launches_tiled"]
    emit("botsort", t, **bots)

    # 12. entry: the command line, files, MJPEG AVI, PNG, rect validation ------------------
    t = time.perf_counter()
    media = Path(tempfile.mkdtemp(prefix="chip_smoke_media_"))
    try:
        entry = run_entry(smi, media)
        nms_row["launches"] += entry["nms_launches"]
        nms_row["calls"] += entry["nms_calls"]
        nms_row["launches_by_path"]["entry"] = entry["nms_launches"]
        emit("entry", t, **entry)

        # 13. draw: save=True, annotated images and MJPEG AVI ----------------------------------
        t = time.perf_counter()
        draw = run_draw(smi, media)
    finally:
        shutil.rmtree(media, ignore_errors=True)
    nms_row["launches"] += draw["nms_launches"]
    nms_row["calls"] += draw["nms_calls"]
    nms_row["launches_by_path"]["draw"] = draw["nms_launches"]
    emit("draw", t, **draw)

    # 14. pose: training and validation of yolov8s-pose ------------------------------
    t = time.perf_counter()
    pose = run_pose(smi)
    for kern in kernels:
        n = pose["counts"]["launches"][kern["name"]]
        kern["launches"] += n
        kern["launches_by_path"]["pose"] = n
    nms_row["calls"] += pose["counts"]["train"]["nms_calls"] + pose["counts"]["val"]["nms_calls"]
    emit("pose", t, **pose)

    # 15. segment: prediction, training and validation of yolov8s-seg ---------------------
    t = time.perf_counter()
    seg = run_segment(smi)
    for kern in kernels:
        n = seg["counts"]["launches"][kern["name"]]
        kern["launches"] += n
        kern["launches_by_path"]["segment"] = n
    nms_row["calls"] += sum(seg["counts"][k]["nms_calls"] for k in ("predict", "train", "val"))
    emit("segment", t, **seg)

    # 16. obb: prediction, training and validation of yolov8s-obb at 1024 px ---------------
    t = time.perf_counter()
    obb = run_obb(smi)
    for kern in kernels:
        n = obb["counts"]["launches"][kern["name"]]
        kern["launches"] += n
        kern["launches_by_path"]["obb"] = n
    emit("obb", t, **obb)

    # 17. families: YOLO11 and YOLO12 on every ported task ------------------------------
    t = time.perf_counter()
    families = run_families(smi)
    for kern in kernels:
        n = families["launches"][kern["name"]]
        kern["launches"] += n
        kern["launches_by_path"]["families"] = n
    emit("families", t, **families)

    # 18. classify: yolov8s-cls and the other classifiers ------------------------------------
    t = time.perf_counter()
    classify = run_classify(smi)
    for kern in kernels:
        n = classify["launches"][kern["name"]]
        kern["launches"] += n
        kern["launches_by_path"]["classify"] = n
    emit("classify", t, **classify)

    # 19. zoo: the v3, v5, v6, P6, Ghost and YOLOv9 yamls ---------------------------------------
    t = time.perf_counter()
    zoo = run_zoo(smi)
    for kern in kernels:
        n = zoo["launches"].get(kern["name"], 0)
        kern["launches"] += n
        kern["launches_by_path"]["zoo"] = n
    emit("zoo", t, **zoo)

    # 20. v10: YOLOv10, the NMS-free end-to-end detector -----------------------------------------
    t = time.perf_counter()
    v10 = run_v10(smi)
    for kern in kernels:
        n = v10["launches"].get(kern["name"], 0)
        kern["launches"] += n
        kern["launches_by_path"]["v10"] = n
    emit("v10", t, **v10)

    # 21. solutions: the analytics apps over tracks and the gait study ---------------------------
    t = time.perf_counter()
    sol = run_solutions(smi)
    nms_row["launches"] += sol["nms_launches"]
    nms_row["calls"] += sol["nms_calls"]
    nms_row["launches_by_path"]["solutions"] = sol["nms_launches"]
    emit("solutions", t, **sol)

    # 22. export: torchscript and onnx artifacts of the flagship, AutoBackend, a served model -------------------------
    t = time.perf_counter()
    exp = run_export(smi)
    nms_row["launches"] += exp["nms_launches"]
    nms_row["calls"] += exp["nms_calls"]
    nms_row["launches_by_path"]["export"] = exp["nms_launches"]
    emit("export", t, **exp)

    # 23. imports ---------------------------------------------------------------
    t = time.perf_counter()
    import drone_yolo_tpu_torch.apps  # noqa: F401  (the modules of every path, imported by now)
    import drone_yolo_tpu_torch.data.loaders  # noqa: F401
    import drone_yolo_tpu_torch.models.yolo  # noqa: F401
    import drone_yolo_tpu_torch.models.yolo.pose  # noqa: F401  (the pose trainer and validator)
    import drone_yolo_tpu_torch.models.yolo.segment  # noqa: F401  (the segment predictor, trainer and validator)
    import drone_yolo_tpu_torch.models.yolo.obb  # noqa: F401  (the obb predictor, trainer and validator)
    import drone_yolo_tpu_torch.models.yolo.classify  # noqa: F401  (the classify predictor, trainer and validator)
    import drone_yolo_tpu_torch.ops.rotated  # noqa: F401  (min_area_rect, OpenCV's without cv2)
    import drone_yolo_tpu_torch.solutions  # noqa: F401  (the analytics apps and the browser app)
    import drone_yolo_tpu_torch.trackers  # noqa: F401
    import drone_yolo_tpu_torch.export.onnx_export  # noqa: F401  (the ONNX writer, no onnx and no google.protobuf)
    import drone_yolo_tpu_torch.nn.onnx_graph  # noqa: F401  (the ONNX reader and runner)
    import drone_yolo_tpu_torch.utils.triton  # noqa: F401  (the KServe-v2 client; grpc only inside its gRPC transport)
    from drone_yolo_tpu_torch.models.yolo import TASK_MAP

    if {TASK_MAP["pose"][k].__name__ for k in ("trainer", "validator")} != {"PoseTrainer", "PoseValidator"}:
        raise AssertionError(f"TASK_MAP['pose'] = {TASK_MAP['pose']}")
    if [v.__name__ for v in TASK_MAP["segment"].values()] != ["SegmentationTrainer", "SegmentationValidator",
                                                               "SegmentationPredictor"]:
        raise AssertionError(f"TASK_MAP['segment'] = {TASK_MAP['segment']}")
    if [v.__name__ for v in TASK_MAP["obb"].values()] != ["OBBTrainer", "OBBValidator", "OBBPredictor"]:
        raise AssertionError(f"TASK_MAP['obb'] = {TASK_MAP['obb']}")
    if [v.__name__ for v in TASK_MAP["classify"].values()] != ["ClassificationTrainer", "ClassificationValidator",
                                                                "ClassificationPredictor"]:
        raise AssertionError(f"TASK_MAP['classify'] = {TASK_MAP['classify']}")

    absent = ["jax", "jaxlib", "drone_yolo_tpu", "cv2", "PIL", "yaml", "sklearn", "matplotlib", "streamlit",
              "google.protobuf", "onnx", "grpc"]
    loaded = sorted(m for m in absent if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    emit("imports", t, absent=absent, port_modules=sorted(m for m in sys.modules if m.startswith("drone_yolo_tpu_torch")),
         total_s=round(time.perf_counter() - T0, 3))

    print(smi, flush=True)
    print(f"per-site device_ms timed by CUDA events where torch.profiler recorded nothing: {len(PROFILER_FALLBACKS)} calls",
          flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in kern.items() if k != "sites"} for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["accuracy"]:
        accuracy([int(s) for s in sys.argv[2:]] or [0, 1])
    else:
        main()
