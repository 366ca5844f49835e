"""Training classifiers in the port against the JAX package, on the CPU in float32.

- `v8ClassificationLoss` on the same logits within 1e-6, and a whole model's train-mode loss within `LOSS_TOL`;
- one SGD step of yolov8n-cls (three parameter groups, EMA, the BN merge) against the JAX `step_fn` within
  `REF_NOISE` (tests/test_torch_train.py), with both kernels' plain versions (`s2grad="cuda"`, `bnstats="cuda"`);
- the loader's batches over an image folder against the JAX loader's (the same permutation, labels exactly, pixels
  within the `resize_linear_u8` bound);
- `YOLO("yolov8s-cls.yaml").train|val|predict` from an image folder, the checkpoints read by the JAX package, resume,
  and `dyt-torch classify train|val|predict`.
"""

import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.cfg import TASK2DATA as JAX_TASK2DATA
from drone_yolo_tpu.cfg import TASK2METRIC as JAX_TASK2METRIC
from drone_yolo_tpu.cfg import TASK2MODEL as JAX_TASK2MODEL
from drone_yolo_tpu.data.build import build_dataloader as jax_build_dataloader
from drone_yolo_tpu.data.dataset import ClassificationDataset as JaxClassificationDataset
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.trainer import BaseTrainer as JaxTrainer
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.utils.loss import v8ClassificationLoss as JaxClassificationLoss
from drone_yolo_tpu.utils.optimizer import init_momentum, label_tree
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import TASK2DATA, TASK2METRIC, TASK2MODEL, entrypoint
from drone_yolo_tpu_torch.data.build import build_dataloader
from drone_yolo_tpu_torch.data.dataset import ClassificationDataset
from drone_yolo_tpu_torch.data.jpeg import decode_jpeg
from drone_yolo_tpu_torch.engine.checkpoint import (from_jax_train_state, from_jax_variables, read_resume_state,
                                                    to_jax_variables)
from drone_yolo_tpu_torch.models.yolo.classify import ClassificationTrainer
from drone_yolo_tpu_torch.nn import modules as TM
from drone_yolo_tpu_torch.nn.model import ClassificationModel
from drone_yolo_tpu_torch.utils.loss import v8ClassificationLoss
from test_torch_classify import IMGSZ, NC, RESIZE_EQUAL_SHARE, _jax_model, _pair, write_folder
from test_torch_train import LOSS_TOL, _close

torch.set_num_threads(1)

BATCH = 2


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(tmp_path_factory.mktemp("cls_train"), seed=1)


def test_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, NC)) * 3).astype(np.float32)
    cls = rng.integers(0, NC, 6).astype(np.int32)
    want, want_items = JaxClassificationLoss()(jnp.asarray(logits), {"cls": jnp.asarray(cls)})
    got, items = v8ClassificationLoss()(torch.from_numpy(logits), {"cls": torch.from_numpy(cls)})
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    assert items.shape == (1,) and float(items[0]) == float(got) and np.asarray(want_items).shape == (1,)


def test_model_loss_matches_jax():
    """yolov8n-cls's train-mode logits of one batch through each package's loss."""
    port, ref, variables = _pair("yolov8n-cls.yaml")
    rng = np.random.default_rng(1)
    x = rng.random((4, IMGSZ, IMGSZ, 3), dtype=np.float32)
    cls = rng.integers(0, NC, 4).astype(np.int32)

    def run(v, x):
        return JaxClassificationLoss()(ref.apply(v, x, ctx=JM.Ctx(train=True, dtype=jnp.float32)), {"cls": jnp.asarray(cls)})

    want, _ = jax.jit(run)(variables, jnp.asarray(x))
    port.train()
    with torch.no_grad(), TM.collect_bn_stats():
        got, _ = v8ClassificationLoss()(port(torch.from_numpy(x.transpose(0, 3, 1, 2))), {"cls": torch.from_numpy(cls)})
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=LOSS_TOL)


def test_train_step_matches_jax_step_fn():
    """One SGD step from one init: the whole state (params, BN statistics, momentum, EMA) against the JAX step_fn,
    with `s2grad="cuda"` and `bnstats="cuda"` (their plain versions on CPU tensors). The port's init, as
    tests/test_torch_families.py steps it."""
    port = ClassificationModel("yolov8n-cls.yaml", nc=NC)
    port.init(0, imgsz=IMGSZ)
    ref, variables = _jax_model("yolov8n-cls.yaml", NC), to_jax_variables(port.state_dict())
    rng = np.random.default_rng(10)
    batch = {"img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8),
             "cls": rng.integers(0, NC, BATCH).astype(np.int32)}
    trainer = ClassificationTrainer(overrides=dict(model="yolov8n-cls.yaml", batch=BATCH, imgsz=IMGSZ, device="cpu",
                                                   amp=False, optimizer="SGD", nbs=BATCH, s2grad="cuda",
                                                   bnstats="cuda"), train_loader=[batch], data={"nc": NC})
    trainer._setup_train()
    assert [len(g["params"]) > 0 for g in trainer.optimizer.param_groups] == [True] * 3
    stub = types.SimpleNamespace(
        model=ref, criterion=JaxClassificationLoss(), accumulate=trainer.accumulate, opt_name="SGD",
        weight_decay=trainer.weight_decay, device_aug=False, labels=label_tree(variables),
        args=types.SimpleNamespace(amp=False, imgsz=IMGSZ, multi_scale=False, seed=0, sp=1))
    JaxTrainer._build_train_step(stub)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    state = {"params": params, "opt": init_momentum(params), "ema": jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True), params),
             "acc": jax.tree_util.tree_map(jnp.zeros_like, params), "count": jnp.zeros((), jnp.int32),
             "step": jnp.zeros((), jnp.int32)}
    trainer.load_train_state(from_jax_train_state(state))
    start = from_jax_variables(variables)
    hyp = trainer._warmup_hyp(50, 0)
    state, _, items_j = stub.train_step(state, batch, *(jnp.float32(h) for h in hyp), target_sz=IMGSZ)
    _, items = trainer.train_step(batch, *hyp)
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=0, atol=LOSS_TOL)
    want, got = from_jax_train_state(state), trainer.train_state()
    names = sorted(dict(trainer.model.named_parameters()))
    buffers = sorted(set(want["params"]) - set(names))
    _close(got["params"], want["params"], names + buffers, base=start)
    _close(got["ema"], want["ema"], names + buffers, base=start)
    _close(got["opt"]["momentum"], want["opt"]["momentum"], names,
           base={k: 0 * v for k, v in want["opt"]["momentum"].items()})
    moved = [k for k in names if not np.array_equal(got["params"][k].numpy(), start[k].numpy())]
    assert len(moved) > 0.9 * len(names) and "model.9.linear.weight" in moved


def test_loader_batches_match_jax(folder):
    """Two epochs of shuffled, augmented batches: the same images in the same order (labels exactly), pixels within 1
    grey level with at least 99.5% equal."""
    port = build_dataloader(ClassificationDataset(folder / "train", imgsz=IMGSZ, augment=True), 4, 2, seed=3)
    ref = jax_build_dataloader(JaxClassificationDataset(folder / "train", imgsz=IMGSZ, augment=True), 4, 2, seed=3)
    diffs = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3 * NC // 4
        for g, w in zip(got, want):
            assert np.array_equal(g["cls"], w["cls"]) and g["cls"].dtype == np.int32
            diffs.append(np.abs(g["img"].astype(int) - w["img"]))
    d = np.stack(diffs)
    assert d.max() <= 1 and (d == 0).mean() >= RESIZE_EQUAL_SHARE


def test_train_val_predict_and_the_command_line(folder, tmp_path):
    """`YOLO("yolov8s-cls.yaml")` trains 2 epochs from the folder (both kernels' plain versions), validates and
    predicts; its checkpoints are read by the JAX package (the same probabilities from last.npz) and it resumes from
    its resume state; then `dyt-torch classify train|val|predict` on the CPU with save and save_txt."""
    model = YOLO("yolov8s-cls.yaml", device="cpu")
    metrics = model.train(data=str(folder), epochs=2, imgsz=IMGSZ, batch=4, nbs=4, workers=2, amp=False, s2grad="cuda",
                          bnstats="cuda", project=str(tmp_path), name="t", plots=True)
    tr = model.trainer
    assert set(metrics) == {"metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"}
    assert model.model.nc == NC and model.names == {i: f"class{i}" for i in range(NC)}
    assert not list(tr.save_dir.glob("train_batch*.jpg"))  # the JAX trainer draws only batches with boxes
    header = (tr.save_dir / "results.csv").read_text().splitlines()[0].split(",")
    assert header == ["epoch", "train/loss", "lr", "metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"]
    assert all(np.isfinite(e["loss_items"]).all() for e in tr.epoch_stats) and len(tr.epoch_stats) == 2
    val = model.val(data=str(folder), imgsz=IMGSZ, batch=4)
    assert all(0.0 <= v <= 1.0 for v in val.values())

    frame = np.random.default_rng(2).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    last = tr.wdir / "last.npz"
    got = YOLO(last, device="cpu").predict(frame, imgsz=IMGSZ, verbose=False)[0].probs.data
    assert jax_load_checkpoint(last)[2]["task"] == "classify"
    want = JaxYOLO(str(last)).predict(source=frame, imgsz=IMGSZ, verbose=False)[0].probs.data  # an integer factor
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    ts, epoch = read_resume_state(tr.wdir / "resume_state.npz")
    assert epoch == 1 and ts["step"] == tr.step

    resumed = ClassificationTrainer(overrides=dict(model="yolov8s-cls.yaml", data=str(folder), epochs=3, imgsz=IMGSZ,
                                                   batch=4, nbs=4, workers=2, amp=False, device="cpu",
                                                   resume=str(tr.wdir / "resume_state.npz"), project=str(tmp_path),
                                                   name="r"))
    resumed.train()
    assert resumed.start_epoch == 2 and [e["epoch"] for e in resumed.epoch_stats] == [2]

    assert (TASK2MODEL, TASK2DATA, TASK2METRIC) == (JAX_TASK2MODEL, JAX_TASK2DATA, JAX_TASK2METRIC)
    assert (TASK2MODEL["classify"], TASK2METRIC["classify"]) == ("yolov8n-cls.yaml", "metrics/accuracy_top1")
    args = f"model={last} data={folder} imgsz={IMGSZ} batch=4 device=cpu project={tmp_path} exist_ok=True"
    entrypoint(f"classify val {args} name=v")
    entrypoint(f"classify predict {args} source={folder / 'val' / 'class3'} save=True save_txt=True name=p")
    pred = tmp_path / "p"
    sources = sorted(p.name for p in (folder / "val" / "class3").iterdir())
    assert sorted(p.name for p in pred.iterdir() if p.is_file()) == sources
    assert len(list((pred / "labels").glob("*.txt"))) == len(sources)
    jpg = next(p for p in pred.iterdir() if p.suffix == ".jpg")
    assert decode_jpeg(jpg.read_bytes()).shape == cv2.imread(str(folder / "val" / "class3" / jpg.name)).shape
    entrypoint(f"classify train model=yolov8n-cls.yaml data={folder} epochs=1 imgsz={IMGSZ} batch=4 nbs=4 workers=2 "
               f"device=cpu amp=False project={tmp_path} name=c")
    assert (tmp_path / "c" / "weights" / "last.npz").exists()
