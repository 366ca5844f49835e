"""AutoBackend: one forward over the port's artifacts and over serving URLs.

Counterpart of `drone_yolo_tpu/nn/autobackend.py` for the artifacts the port writes and reads:
a `drone_yolo_tpu.v1` npz (built and fused here), a `.torchscript` file (`torch.jit.load` onto the
device), an `.onnx` file (run by the port's own graph runner, `nn/onnx_graph.py`, on the device;
the JAX package reads it with `cv2.dnn`), and `http://`, `https://`, `grpc://`, `grpcs://` and
`triton://` URLs of a KServe-v2 server (`utils/triton.py`). `.stablehlo` (JAX bytecode), `.tflite`
and `*_saved_model` (TensorFlow) are refused by name.

The contract is the port's own: `backend(x)` takes a (B, 3, H, W) float tensor in [0, 1] and gives,
on the backend's device, the raw predictions in the layout of the port's eager fused model: (B, A,
4 + nc [+ extra]) decoded predictions, a list [predictions, prototypes (B, nm, Hm, Wm)] for a
segment model, (B, nc) probabilities for a classifier. A YOLOv10 artifact gives its decoded
one-to-one predictions (B, A, 4 + nc), as the JAX exporter writes them: NMS follows, as it does
over every artifact in the JAX package. An ONNX file and a served model give (B, 4 + nc, A) as
ONNX does; the backend turns them to (B, A, 4 + nc). `names`, `nc`, `task`, `stride`,
`kpt_shape` and the artifact's input shape come from the artifact's `.json` sidecar and its sibling
npz (`_sibling_meta`), or from the server's metadata.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from drone_yolo_tpu_torch.nn import modules as M

LOGGER = logging.getLogger("drone_yolo_tpu_torch")
URL_SCHEMES = ("http://", "https://", "grpc://", "grpcs://", "triton://")
REFUSED = {
    ".stablehlo": "a .stablehlo artifact is JAX bytecode (jax.export): running it needs JAX, which the port does not "
                  "use; export the model to torchscript or onnx instead",
    ".tflite": "a .tflite artifact needs TensorFlow, which the card's machine does not have",
    "_saved_model": "a TensorFlow SavedModel needs TensorFlow, which the card's machine does not have",
}


def refusal(weights) -> str | None:
    """Why the port does not read the artifact `weights`, or None."""
    p = str(weights).rstrip("/")
    return next((why for suffix, why in REFUSED.items() if p.endswith(suffix)), None)


def is_artifact(weights) -> bool:
    """An export artifact or a serving URL, which runs through AutoBackend (an npz is a checkpoint the facade loads
    itself)."""
    p = str(weights)
    return p.startswith(URL_SCHEMES) or p.endswith((".torchscript", ".onnx")) or refusal(p) is not None


class ArtifactModel(nn.Module):
    """The forward of an artifact of the fused `model`: the decoded predictions (with the prototypes for a segment
    model), the probabilities of a classifier, YOLOv10's decoded one-to-one predictions. This is what the TorchScript
    export traces and what an npz backend runs."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        m = self.model
        if isinstance(m.head, M.Classify):
            return m(x)
        xs = m.head_input(x)
        if isinstance(m.head, M.v10Detect):
            return m.head.decode(m.head.one2one_maps(xs))
        preds, aux = m.head(xs)
        return (preds, aux[2]) if isinstance(m.head, M.Segment) else preds


def model_meta(model, imgsz: int | None = None, batch: int | None = None) -> dict:
    """The sidecar's keys for `model` (the JAX exporter's input, nms, names, task, stride, with kpt_shape for a pose
    model)."""
    meta = {"input": [batch, 3, imgsz, imgsz] if imgsz else None, "nms": False,
            "names": {int(k): v for k, v in model.names.items()}, "task": model.task,
            "stride": [float(s) for s in model.head.stride]}
    if isinstance(model.head, M.Pose):
        meta["kpt_shape"] = list(model.head.kpt_shape)
    return meta


def _ordered(out):
    """ONNX's (B, C, A) detections as the port's (B, A, C); prototypes and probabilities as they are. One output
    alone, else the list."""
    out = [o.transpose(1, 2) if o.dim() == 3 else o for o in out]
    return out[0] if len(out) == 1 else out


class AutoBackend:
    """Uniform forward over the port's artifacts and serving URLs on `device` (the card unless the caller passes
    "cpu")."""

    def __init__(self, weights, device=None, half: bool = False):
        from drone_yolo_tpu_torch.engine.model import select_device

        self.device = select_device(device)
        self.half = half
        self.path = str(weights)
        self.meta: dict = {}
        why = refusal(self.path)
        if why:
            raise NotImplementedError(f"{self.path}: {why}")
        p = self.path
        if p.startswith(URL_SCHEMES):
            self.kind = "triton"
            self._init_triton(p)
        elif p.endswith(".npz"):
            self.kind = "npz"
            self._init_npz()
        elif p.endswith(".torchscript"):
            self.kind = "torchscript"
            self._init_torchscript()
        elif p.endswith(".onnx"):
            self.kind = "onnx"
            self._init_onnx()
        else:
            raise ValueError(f"unrecognized artifact: {weights} (npz, .torchscript, .onnx or a serving URL)")
        LOGGER.info(f"AutoBackend: {self.kind} <- {self.path} on {self.device}")

    # -- per-format loaders --------------------------------------------------------------------------------------------
    def _sibling_meta(self) -> None:
        """names, task, stride (and kpt_shape) from whichever sidecar exists: `<artifact>.json`, then the npz header."""
        js = Path(self.path + ".json")
        if js.exists():
            self.meta.update(json.loads(js.read_text()))
        npz = Path(self.path).with_suffix(".npz")
        if npz.exists():
            with np.load(npz, allow_pickle=False) as data:
                hdr = json.loads(bytes(data["__header__"]).decode()) if "__header__" in data.files else {}
            for k in ("names", "task", "stride"):
                self.meta.setdefault(k, hdr.get(k))
            if "kpt_shape" in hdr.get("yaml", {}):
                self.meta.setdefault("kpt_shape", hdr["yaml"]["kpt_shape"])

    def _init_npz(self) -> None:
        from drone_yolo_tpu_torch.engine.checkpoint import load_checkpoint

        model, _ = load_checkpoint(self.path)
        model = model.eval().to(self.device, torch.float32).fuse()
        net = ArtifactModel(model.to(torch.bfloat16) if self.half else model)

        def call(x):
            out = net(x)
            return [o.float() for o in out] if isinstance(out, tuple) else out.float()

        self._call = call
        self.meta = {**model_meta(model), "input": None, "nc": model.nc}

    def _init_torchscript(self) -> None:
        module = torch.jit.load(self.path, map_location=self.device).eval()
        self._sibling_meta()

        def call(x):
            out = module(x)
            return [o.float() for o in out] if isinstance(out, (tuple, list)) else out.float()

        self._call = call

    def _init_onnx(self) -> None:
        from drone_yolo_tpu_torch.nn.onnx_graph import OnnxGraph

        graph = OnnxGraph(self.path, self.device)
        self._sibling_meta()
        self._call = lambda x: _ordered(graph(x))

    def _init_triton(self, url: str) -> None:
        """A model served over KServe-v2 (REST or gRPC); its outputs in the ONNX artifact's layout."""
        from drone_yolo_tpu_torch.utils.triton import TritonRemoteModel

        remote = TritonRemoteModel(url.replace("triton://", "http://"))
        if remote.metadata:
            self.meta.update(remote.metadata)

        def call(x):
            outs = remote(x.detach().float().cpu().numpy())
            return _ordered([torch.from_numpy(np.ascontiguousarray(o)).to(self.device) for o in outs])

        self._call = call

    # -- the uniform surface ----------------------------------------------------------------------------------------
    @property
    def names(self) -> dict:
        n = self.meta.get("names") or {}
        return {int(k): v for k, v in n.items()} if isinstance(n, dict) else dict(enumerate(n))

    @property
    def nc(self) -> int:
        return int(self.meta.get("nc") or len(self.names) or 80)

    @property
    def task(self) -> str:
        return self.meta.get("task") or "detect"

    @property
    def stride(self) -> list[float]:
        return [float(s) for s in np.atleast_1d(np.asarray(self.meta.get("stride") or [32.0], np.float32))]

    @property
    def kpt_shape(self) -> tuple | None:
        k = self.meta.get("kpt_shape")
        return tuple(int(v) for v in k) if k else None

    @property
    def input_shape(self) -> list | None:
        """The fixed (B, 3, H, W) input of an exported artifact, or None where any shape goes (an npz)."""
        shape = self.meta.get("input")
        return [int(v) for v in shape] if shape and all(v is not None for v in shape) else None

    @torch.no_grad()
    def __call__(self, x: torch.Tensor):
        """x: (B, 3, H, W) float in [0, 1] on the backend's device -> the raw predictions."""
        return self._call(x)

    @torch.no_grad()
    def model_output(self, x: torch.Tensor):
        """The output in the structure of the eager fused model's: (predictions, the rest as a tuple: a segment
        model's (prototypes,)), or a classifier's probabilities."""
        out = self._call(x)
        if self.task == "classify":
            return out
        return (out[0], tuple(out[1:])) if isinstance(out, list) else (out, ())

    def warmup(self, imgsz=(1, 3, 64, 64)) -> AutoBackend:
        self._call(torch.zeros(imgsz, device=self.device))
        return self
