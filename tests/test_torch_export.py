"""Export and AutoBackend of the port against the JAX package, on the CPU in float32.

One set of weights per model: the port's seeded init redrawn by `chip_smoke.spread_weights` (the class
branches spread by `scored_weights`), saved once as a `drone_yolo_tpu.v1` npz that both facades load. Then:

- `utils/pbwire.py` raises on malformed input as the JAX codec does, and `export/onnx_pb.py` writes the bytes that
  `google.protobuf` writes for the same messages (the JAX package's generated `onnx_pb2`, here for the test only),
  and reads both packages' files back to the same messages;
- for the flagship (fused RepVGG), -seg, -pose, -obb, -cls, yolov10n, yolo11n, yolo12n, yolov5n, yolov9t and
  yolov8n-p6, the port's `.onnx` read by `cv2.dnn` equals the port's eager fused forward, and the JAX package's
  `.onnx` of the same weights read by `cv2.dnn` (`ONNX_TOL`); the port's graph runner (`nn/onnx_graph.py`) gives
  what `cv2.dnn` gives for both files (`RUNNER_TOL`);
- a TorchScript round trip equals the eager forward (`TS_TOL`) and its sidecar holds names, task and stride;
  `AutoBackend` over npz, `.torchscript` and `.onnx` agrees (`BACKEND_TOL`);
- `YOLO(artifact).predict` on the file the JAX package wrote gives the JAX facade's detections (the same kept
  boxes, within `BOX_ATOL_PX`; the same masks for segment), and `YOLO(artifact).val` its metrics (`MAP_ATOL`);
- `TritonRemoteModel` and `AutoBackend(url)` against a copy of the JAX tests' KServe-v2 REST double and a gRPC
  double; `dyt-torch export`; each refusal by name; and an export and predict through both artifacts with jax, cv2,
  PIL, yaml, google.protobuf, onnx and grpc blocked.
"""

import json
import os
import subprocess
import sys
import threading
from http.server import HTTPServer
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import scored_weights, spread_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import entrypoint
from drone_yolo_tpu_torch.export import onnx_pb as P
from drone_yolo_tpu_torch.nn.autobackend import ArtifactModel, AutoBackend
from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, guess_model_task
from drone_yolo_tpu_torch.nn.onnx_graph import OnnxGraph
from drone_yolo_tpu_torch.ops import masks as MASK
from drone_yolo_tpu_torch.utils import pbwire as pb
from drone_yolo_tpu_torch.utils.triton import TritonRemoteModel
from make_dataset import make_dataset
from test_torch_predict import BLOCKER, REPO
from test_torch_segment import _assert_masks_close

sys.path.insert(0, str(REPO / "drone_yolo_tpu" / "export"))
import onnx_pb2 as O  # noqa: E402  (the JAX package's generated protobuf classes)

torch.set_num_threads(1)

ONNX_TOL = dict(rtol=1e-4, atol=1e-4)  # a float32 graph against another float32 computation of it
RUNNER_TOL = dict(rtol=1e-4, atol=1e-4)
TS_TOL = dict(rtol=1e-5, atol=1e-5)
BACKEND_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_ATOL_PX, SCORE_ATOL, MAP_ATOL = 1e-3, 1e-5, 1e-6
BATCH = 2
MODELS = {"yolov8n-p2-repvgg-sf.yaml": 64, "yolov8n-seg.yaml": 64, "yolov8n-pose.yaml": 64, "yolov8n-obb.yaml": 64,
          "yolov8n-cls.yaml": 64, "yolov10n.yaml": 64, "yolo11n.yaml": 64, "yolo12n.yaml": 64, "yolov5n.yaml": 64,
          "yolov9t.yaml": 64, "yolov8n-p6.yaml": 128}


def port_facade(name: str, imgsz: int, nc: int | None = None) -> YOLO:
    """The port's facade on the CPU with spread weights (class logits spread for the detection heads)."""
    m = YOLO(name, device="cpu")
    if nc:
        m.model = TASK2MODELCLASS[guess_model_task(name)](name, nc=nc)
    m.ensure_variables(imgsz=imgsz)
    sd, rng = m.model.state_dict(), np.random.default_rng(0)
    m.model.load_state_dict(spread_weights(sd, rng) if m.task == "classify" else scored_weights(sd, rng, -2.0, 3.0))
    return m


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> {"port": the port's facade, "onnx": its .onnx, "jax_onnx": the JAX package's .onnx of the same npz}."""
    root = tmp_path_factory.mktemp("export")
    cache = {}

    def get(name):
        if name not in cache:
            imgsz = MODELS[name]
            m = port_facade(name, imgsz)
            m.save(root / f"{Path(name).stem}.npz")
            onnx = m.export(format="onnx", imgsz=imgsz, batch=BATCH, project=str(root / "port"))
            jax_onnx = JaxYOLO(str(root / f"{Path(name).stem}.npz")).export(format="onnx", imgsz=imgsz, batch=BATCH,
                                                                            project=str(root / "jax"))
            cache[name] = {"port": m, "onnx": onnx, "jax_onnx": jax_onnx, "root": root}
        return cache[name]

    return get


def cv2_outputs(path, x: np.ndarray) -> list:
    net = cv2.dnn.readNetFromONNX(str(path))
    names = [o.name for o in P.ModelProto.FromString(Path(path).read_bytes()).graph.output]
    net.setInput(x)
    return list(net.forward(names))


def eager(m: YOLO, x: np.ndarray) -> list:
    """The port's eager fused forward in the artifact's layout: ONNX's (B, C, A), prototypes, probabilities."""
    net = ArtifactModel(m.model.eval().fuse())
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    out = list(out) if isinstance(out, tuple) else [out]
    return [o.transpose(1, 2).numpy() if o.dim() == 3 else o.numpy() for o in out]


# -- the wire formats ---------------------------------------------------------------------------------------------
def test_pbwire_varints_and_malformed_input():
    """Varints both ways (a negative int as 10 bytes); truncated or overlong data raises ValueError, as the JAX
    codec's test asks."""
    for v in (0, 1, 127, 128, 300, 2**35, 2**63 - 1):
        assert pb.decode_varint(pb.encode_varint(v), 0) == (v, len(pb.encode_varint(v)))
    assert len(pb.encode_int(-1)) == 10 and pb.signed(pb.decode_varint(pb.encode_int(-5), 0)[0]) == -5
    assert pb.unpack_int64(pb.packed_int64_field(1, [3, -2, 2**40])[2:]) == [3, -2, 2**40]
    assert pb.unpack_float(pb.packed_float_field(1, [1.5, -2.0])[2:]) == [1.5, -2.0]
    with pytest.raises(ValueError, match="truncated"):
        pb.decode_varint(b"\x80\x80", 0)
    with pytest.raises(ValueError, match="64 bits"):
        pb.decode_varint(b"\x80" * 10 + b"\x01", 0)
    good = pb.bytes_field(1, b"payload-bytes")
    assert list(pb.fields(good)) == [(1, pb.LEN, b"payload-bytes")]
    with pytest.raises(ValueError, match="truncated"):
        list(pb.fields(good[:-4]))
    with pytest.raises(ValueError, match="truncated"):
        list(pb.fields(pb.key(2, pb.I64) + b"\x00\x01"))
    with pytest.raises(ValueError, match="malformed"):
        pb.unpack_float(b"\x00\x00\x00")


def _pb2_model():
    """A ModelProto through the generated classes, with every field kind the emitter writes and the defaults that
    proto3 leaves out or writes by presence."""
    m = O.ModelProto()
    m.ir_version = 8
    m.producer_name = "p"
    m.opset_import.add().version = 13
    g = m.graph
    g.name = "main"
    for name, dims in (("images", (2, 3, 0, 64)), ("output0", (2, 84, 340))):
        vi = (g.input if name == "images" else g.output).add()
        vi.name = name
        vi.type.tensor_type.elem_type = O.TensorProto.FLOAT
        for d in dims:
            vi.type.tensor_type.shape.dim.add().dim_value = d
    for name, arr in (("w", np.arange(6, dtype=np.float32).reshape(2, 3)), ("s", np.array([0, -1, 2**40], np.int64)),
                      ("z", np.array(0.0, np.float32))):
        t = g.initializer.add()
        t.name = name
        t.dims.extend(arr.shape)
        t.data_type = O.TensorProto.INT64 if arr.dtype == np.int64 else O.TensorProto.FLOAT
        t.raw_data = arr.tobytes()
    n = g.node.add()
    n.op_type, n.name = "Conv", "Conv_1"
    n.input.extend(["images", "w", ""])
    n.output.append("y")
    for k, kind, val in (("group", "i", 1), ("zero", "i", 0), ("f", "f", 0.0), ("mode", "s", b"nearest"),
                         ("pads", "ints", [0, -1, 3]), ("scales", "floats", [1.0, 2.5])):
        a = n.attribute.add()
        a.name = k
        a.type = {"i": O.AttributeProto.INT, "f": O.AttributeProto.FLOAT, "s": O.AttributeProto.STRING,
                  "ints": O.AttributeProto.INTS, "floats": O.AttributeProto.FLOATS}[kind]
        getattr(a, kind).extend(val) if isinstance(val, list) else setattr(a, kind, val)
    return m


def test_onnx_pb_bytes_equal_onnx_pb2(exported):
    """The same messages serialize to the same bytes as google.protobuf's; each package's file parses to a message
    that serializes back to the file's bytes, and google.protobuf reads the port's file to the same bytes."""
    A = P.AttributeProto
    want = _pb2_model().SerializeToString()
    got = P.ModelProto(
        ir_version=8, producer_name="p", opset_import=[P.OperatorSetIdProto(version=13)],
        graph=P.GraphProto(
            name="main",
            input=[P.ValueInfoProto(name="images", type=P.TypeProto(tensor_type=P.TensorType(
                elem_type=1, shape=P.TensorShapeProto(dim=[P.Dimension(dim_value=d) for d in (2, 3, 0, 64)]))))],
            output=[P.ValueInfoProto(name="output0", type=P.TypeProto(tensor_type=P.TensorType(
                elem_type=1, shape=P.TensorShapeProto(dim=[P.Dimension(dim_value=d) for d in (2, 84, 340)]))))],
            initializer=[P.TensorProto(name="w", dims=[2, 3], data_type=1, raw_data=np.arange(6, dtype=np.float32).tobytes()),
                         P.TensorProto(name="s", dims=[3], data_type=7, raw_data=np.array([0, -1, 2**40], np.int64).tobytes()),
                         P.TensorProto(name="z", dims=[], data_type=1, raw_data=np.float32(0).tobytes())],
            node=[P.NodeProto(op_type="Conv", name="Conv_1", input=["images", "w", ""], output=["y"], attribute=[
                A(name="group", type=A.INT, i=1), A(name="zero", type=A.INT, i=0), A(name="f", type=A.FLOAT, f=0.0),
                A(name="mode", type=A.STRING, s=b"nearest"), A(name="pads", type=A.INTS, ints=[0, -1, 3]),
                A(name="scales", type=A.FLOATS, floats=[1.0, 2.5])])]))
    assert got.SerializeToString() == want
    assert P.ModelProto.FromString(want) == got
    art = exported("yolov8n-seg.yaml")
    for path in (art["onnx"], art["jax_onnx"]):
        data = Path(path).read_bytes()
        assert P.ModelProto.FromString(data).SerializeToString() == data
        ref = O.ModelProto()
        ref.ParseFromString(data)
        assert ref.SerializeToString() == data


# -- ONNX against the eager forward, the JAX package's file and cv2 --------------------------------------------------
@pytest.mark.parametrize("name", list(MODELS))
def test_onnx_matches_eager_jax_and_cv2(name, exported):
    art = exported(name)
    imgsz = MODELS[name]
    x = np.random.default_rng(1).random((BATCH, 3, imgsz, imgsz), np.float32)
    port_cv2 = cv2_outputs(art["onnx"], x)
    jax_cv2 = cv2_outputs(art["jax_onnx"], x)
    want = eager(art["port"], x)
    assert [o.shape for o in port_cv2] == [o.shape for o in want] == [o.shape for o in jax_cv2]
    for got, w, j in zip(port_cv2, want, jax_cv2):
        np.testing.assert_allclose(got, w, **ONNX_TOL)
        np.testing.assert_allclose(got, j, **ONNX_TOL)
    for path, ref in ((art["onnx"], port_cv2), (art["jax_onnx"], jax_cv2)):
        runner = OnnxGraph(path, "cpu")(torch.from_numpy(x))
        for got, w in zip(runner, ref):
            np.testing.assert_allclose(got.numpy(), w, **RUNNER_TOL)
    graph = P.ModelProto.FromString(Path(art["onnx"]).read_bytes())
    assert graph.ir_version == 8 and graph.opset_import[0].version == 13
    assert [v.name for v in graph.graph.input] == ["images"]
    assert [v.name for v in graph.graph.output] == (["output0", "output1"] if "seg" in name else ["output0"])
    jax_graph = P.ModelProto.FromString(Path(art["jax_onnx"]).read_bytes()).graph  # the JAX graph node for node (the
    assert [nd.op_type for nd in graph.graph.node] == [nd.op_type for nd in jax_graph.node]  # RepVGGBlocks one conv)
    assert [list(t.dims) for t in graph.graph.initializer] == [list(t.dims) for t in jax_graph.initializer]


def test_graph_runner_edge_semantics_match_cv2(tmp_path):
    """Opset-13 semantics the emitters exercise little, in one graph against cv2.dnn: Pad's pads as an input, Resize by
    scales and by sizes, Slice with axes and steps as inputs (a negative step, ends of INT64_MAX), MaxPool with
    asymmetric pads, ReduceSum's axes as an input, Flatten."""
    from drone_yolo_tpu_torch.export.onnx_export import Builder, _value_info

    b = Builder()
    i64 = lambda *v: b.const(np.array(v, np.int64))  # noqa: E731
    y = b.node("Pad", ["images", i64(0, 0, 1, 2, 0, 0, 3, 0)], mode="constant")
    y = b.node("Resize", [y, b.const(np.zeros(0, np.float32)), b.const(np.array([1.0, 1.0, 2.0, 2.0], np.float32))],
               mode="nearest", coordinate_transformation_mode="asymmetric", nearest_mode="floor")
    y = b.node("Resize", [y, b.const(np.zeros(0, np.float32)), b.const(np.zeros(0, np.float32)), i64(1, 3, 22, 10)],
               mode="nearest", coordinate_transformation_mode="asymmetric", nearest_mode="floor")  # by sizes
    y = b.node("Slice", [y, i64(1, 2**63 - 1), i64(2**63 - 1, 0), i64(2, 3), i64(2, -3)])
    y = b.node("MaxPool", [y], kernel_shape=[3, 3], strides=[2, 2], pads=[0, 1, 1, 0])
    y = b.node("Flatten", [b.node("ReduceSum", [y, i64(1)], keepdims=1)], axis=1)
    doc = P.ModelProto(ir_version=8, opset_import=[P.OperatorSetIdProto(version=13)],
                       graph=P.GraphProto(node=b.nodes, name="g", initializer=b.inits,
                                          input=[_value_info("images", (1, 3, 8, 8))], output=[_value_info(y, ())]))
    path = tmp_path / "edge.onnx"
    path.write_bytes(doc.SerializeToString())
    x = np.random.default_rng(0).random((1, 3, 8, 8), np.float32)
    want = cv2_outputs(path, x)[0]
    got = OnnxGraph(doc.SerializeToString(), "cpu")(torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape and got.size > 1
    np.testing.assert_allclose(got, want, **RUNNER_TOL)


# -- TorchScript, AutoBackend ---------------------------------------------------------------------------------------
def test_torchscript_round_trip_and_backends_agree(exported):
    art = exported("yolov8n-seg.yaml")
    m, root = art["port"], art["root"]
    ts = m.export(format="torchscript", imgsz=64, batch=BATCH, project=str(root / "ts"))
    assert ts.endswith("yolov8n-seg_64.torchscript") and (root / "ts" / "yolov8n-seg_64.npz").exists()
    meta = json.loads(Path(ts + ".json").read_text())
    assert meta["task"] == "segment" and meta["stride"] == [8.0, 16.0, 32.0] and len(meta["names"]) == 80
    assert meta["input"] == [BATCH, 3, 64, 64] and meta["nms"] is False
    x = np.random.default_rng(2).random((BATCH, 3, 64, 64), np.float32)
    loaded = torch.jit.load(ts)
    with torch.no_grad():
        out = loaded(torch.from_numpy(x))
    want = eager(m, x)
    np.testing.assert_allclose(out[0].transpose(1, 2).numpy(), want[0], **TS_TOL)
    np.testing.assert_allclose(out[1].numpy(), want[1], **TS_TOL)
    outs = {}
    for kind, path in (("npz", str(root / "ts" / "yolov8n-seg_64.npz")), ("torchscript", ts), ("onnx", art["onnx"])):
        b = AutoBackend(path, "cpu")
        assert b.kind == kind and b.task == "segment" and b.nc == 80 and b.stride == [8.0, 16.0, 32.0]
        outs[kind] = b(torch.from_numpy(x))
        assert isinstance(outs[kind], list) and outs[kind][0].shape == (BATCH, 84, 116)
    for kind in ("torchscript", "onnx"):
        for got, w in zip(outs[kind], outs["npz"]):
            np.testing.assert_allclose(got.numpy(), w.numpy(), **BACKEND_TOL)
    pose = AutoBackend(exported("yolov8n-pose.yaml")["onnx"], "cpu")
    assert pose.kpt_shape == (17, 3) and pose.task == "pose" and pose.input_shape == [BATCH, 3, 64, 64]


# -- predict and val through an artifact, against the JAX facade ------------------------------------------------------
@pytest.mark.parametrize("name", ["yolov8n-p2-repvgg-sf.yaml", "yolov8n-seg.yaml"])
def test_artifact_predict_matches_jax(name, exported):
    """On the .onnx the JAX package wrote: the JAX facade (cv2.dnn) and the port's (the graph runner, NMS after)."""
    art = exported(name)
    frames = [np.random.default_rng(i).integers(0, 256, (96, 128, 3), dtype=np.uint8) for i in range(2)]
    port, ref = YOLO(art["jax_onnx"], device="cpu"), JaxYOLO(art["jax_onnx"])
    assert port.model is None and port.backend.kind == "onnx" and port.task == ref.task
    got = port.predict(frames, conf=0.05, verbose=False)
    want = ref.predict(frames, imgsz=64, conf=0.05, verbose=False)
    n_det = 0
    for g, w in zip(got, want, strict=True):
        assert len(g.boxes) == len(w.boxes)
        n_det += len(g.boxes)
        np.testing.assert_allclose(g.boxes.data[:, :4], w.boxes.data[:, :4], atol=BOX_ATOL_PX)
        np.testing.assert_allclose(g.boxes.data[:, 4:], w.boxes.data[:, 4:], atol=SCORE_ATOL)
    assert n_det > 0
    if "seg" in name:  # the masks: equal but where the port's value lies within MASK_TOL of 0.5
        pred = port.predictor
        x = pred.preprocess(frames)
        (dets, protos), n_valid = pred.inference(x)
        for i, (g, w) in enumerate(zip(got, want)):
            d = dets[i, : int(n_valid[i])]
            values = MASK.scale_masks(MASK.process_mask(protos[i], d[:, 6:], d[:, :4], x.shape[2:]), g.orig_shape,
                                      x.shape[2:]).numpy()
            assert g.masks.data.shape == np.asarray(w.masks.data).shape
            _assert_masks_close(g.masks.data, np.asarray(w.masks.data), values)


def test_artifact_val_matches_jax(tmp_path):
    """`YOLO(artifact).val` on the JAX package's .onnx and the port's own: the JAX facade's metrics; a fixed-shape
    artifact validates in square batches at its own batch and imgsz."""
    data = make_dataset(tmp_path / "d", n_train=1, n_val=5, size=96, nc=4, seed=0)
    rng = np.random.default_rng(0)  # GT boxes of 40-90% of the image: the random model's boxes are that large
    for f in sorted((tmp_path / "d" / "labels" / "val").glob("*.txt")):
        f.write_text("".join(f"{rng.integers(0, 4)} {rng.uniform(0.3, 0.7):.4f} {rng.uniform(0.3, 0.7):.4f} "
                             f"{rng.uniform(0.4, 0.9):.4f} {rng.uniform(0.4, 0.9):.4f}\n" for _ in range(3)))
    m = port_facade("yolov8n-p2-repvgg-sf.yaml", 64, nc=4)
    m.save(tmp_path / "m.npz")
    jax_onnx = JaxYOLO(str(tmp_path / "m.npz")).export(format="onnx", imgsz=64, batch=BATCH, project=str(tmp_path / "j"))
    want = JaxYOLO(jax_onnx).val(data=str(data), imgsz=64, batch=BATCH, verbose=False).results_dict
    port = YOLO(jax_onnx, device="cpu")
    port.val(data=str(data), verbose=False)
    got = port.validator.metrics.results_dict  # unrounded, as the JAX facade's
    assert port.validator.args.rect is False and port.validator.args.batch == BATCH
    assert got["metrics/recall(B)"] > 0 and got["metrics/mAP50(B)"] > 0
    for k, v in want.items():
        assert abs(got[k] - v) <= MAP_ATOL, (k, got[k], v)
    own = YOLO(m.export(format="onnx", imgsz=64, batch=BATCH, project=str(tmp_path / "p")), device="cpu")
    own.val(data=str(data), verbose=False)
    for k, v in own.validator.metrics.results_dict.items():
        assert abs(v - got[k]) <= MAP_ATOL, (k, v, got[k])


# -- serving URLs -----------------------------------------------------------------------------------------------------
class _FakeTritonHandler:
    """KServe-v2 test double: config + binary-extension infer for a y=2x model (a copy of the JAX tests')."""

    def make(meta_json):
        from http.server import BaseHTTPRequestHandler

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_GET(self):
                cfg = {
                    "input": [{"name": "images", "data_type": "TYPE_FP32", "dims": [-1, 3, -1, -1]}],
                    "output": [{"name": "output0", "data_type": "TYPE_FP32", "dims": [-1]}],
                    "parameters": {"metadata": {"string_value": meta_json}},
                }
                body = json.dumps(cfg).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                hlen = int(self.headers["Inference-Header-Content-Length"])
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                req = json.loads(raw[:hlen])
                x = np.frombuffer(raw[hlen:], np.float32).reshape(req["inputs"][0]["shape"])
                blob = (x * 2).astype(np.float32).tobytes()
                hdr = json.dumps({"outputs": [{"name": "output0", "datatype": "FP32", "shape": list(x.shape),
                                               "parameters": {"binary_data_size": len(blob)}}]}).encode()
                self.send_response(200)
                self.send_header("Inference-Header-Content-Length", str(len(hdr)))
                self.send_header("Content-Length", str(len(hdr) + len(blob)))
                self.end_headers()
                self.wfile.write(hdr + blob)

        return H

    make = staticmethod(make)


def test_triton_remote_model_rest():
    meta = json.dumps({"names": {"0": "obj"}, "task": "detect", "stride": [8.0], "nc": 1})
    srv = HTTPServer(("127.0.0.1", 0), _FakeTritonHandler.make(meta))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/yolo"
        m = TritonRemoteModel(url)
        assert m.endpoint == "yolo" and m.input_names == ["images"] and m.output_names == ["output0"]
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
        (y,) = m(x)
        np.testing.assert_allclose(y, x * 2)
        b = AutoBackend(url, "cpu")
        assert b.kind == "triton" and b.task == "detect" and b.nc == 1 and b.stride == [8.0]
        np.testing.assert_allclose(b(torch.from_numpy(x)).numpy(), x * 2)  # 4-D: passed through as it is
        x3 = np.arange(12, dtype=np.float32).reshape(1, 3, 4)  # (B, C, A) as ONNX gives it -> (B, A, C)
        np.testing.assert_allclose(b(torch.from_numpy(x3)).numpy(), (x3 * 2).transpose(0, 2, 1))
    finally:
        srv.shutdown()


def test_triton_remote_model_grpc():
    """KServe-v2 gRPC against an in-process generic-handler double: raw contents with ModelConfig metadata, then
    typed contents without ModelConfig."""
    grpc = pytest.importorskip("grpc")
    from concurrent import futures

    def tensor_shape(request):
        shape = raw = None
        for f, _, v in pb.fields(request):
            if f == 5:
                shape = next(pb.unpack_int64(v2) for f2, _, v2 in pb.fields(v) if f2 == 3)
            elif f == 7:
                raw = v
        return (np.frombuffer(raw, np.float32).reshape(shape) * 2).astype(np.float32)

    def model_metadata(request, context):
        tin = pb.string_field(1, "images") + pb.string_field(2, "FP32") + pb.packed_int64_field(3, [-1, 3, -1, -1])
        tout = pb.string_field(1, "output0") + pb.string_field(2, "FP32") + pb.packed_int64_field(3, [-1])
        return pb.string_field(1, "yolo") + pb.bytes_field(4, tin) + pb.bytes_field(5, tout)

    def model_config(request, context):
        entry = pb.string_field(1, "metadata") + pb.bytes_field(2, pb.string_field(1, json.dumps({"task": "detect"})))
        return pb.bytes_field(1, pb.bytes_field(14, entry))

    def model_infer(request, context):
        y = tensor_shape(request)
        out = pb.string_field(1, "output0") + pb.string_field(2, "FP32") + pb.packed_int64_field(3, list(y.shape))
        return pb.string_field(1, "yolo") + pb.bytes_field(5, out) + pb.bytes_field(6, y.tobytes())

    def model_infer_contents(request, context):
        y = tensor_shape(request)
        out = (pb.string_field(1, "output0") + pb.string_field(2, "FP32") + pb.packed_int64_field(3, list(y.shape))
               + pb.bytes_field(5, pb.bytes_field(6, y.astype("<f4").tobytes())))
        return pb.string_field(1, "yolo") + pb.bytes_field(5, out)

    def serve(methods):
        ident = lambda b: b  # noqa: E731
        handler = grpc.method_handlers_generic_handler(
            "inference.GRPCInferenceService",
            {n: grpc.unary_unary_rpc_method_handler(fn, ident, ident) for n, fn in methods.items()})
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        server.add_generic_rpc_handlers((handler,))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        return server, port

    x = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    for methods, meta in (({"ModelMetadata": model_metadata, "ModelConfig": model_config, "ModelInfer": model_infer},
                           {"task": "detect"}),
                          ({"ModelMetadata": model_metadata, "ModelInfer": model_infer_contents}, None)):
        server, port = serve(methods)
        try:
            m = TritonRemoteModel(f"grpc://127.0.0.1:{port}/yolo")
            assert m.input_names == ["images"] and m.metadata == meta
            np.testing.assert_allclose(m(x)[0], x * 2)
            b = AutoBackend(f"grpc://127.0.0.1:{port}/yolo", "cpu")
            np.testing.assert_allclose(b(torch.from_numpy(x)).numpy(), x * 2)
        finally:
            server.stop(0)


# -- the command line, the refusals, the blocked-import run -----------------------------------------------------------
def test_cli_export(tmp_path):
    entrypoint(f"dyt-torch export model=yolov8n.yaml format=onnx imgsz=64 device=cpu project={tmp_path}")
    assert (tmp_path / "yolov8n_64.onnx").exists() and (tmp_path / "yolov8n_64.npz").exists()
    assert json.loads((tmp_path / "yolov8n_64.onnx.json").read_text())["input"] == [16, 3, 64, 64]  # batch's default
    cv2.imwrite(str(tmp_path / "a.jpg"), np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8))
    entrypoint(f"dyt-torch predict model={tmp_path / 'yolov8n_64.onnx'} source={tmp_path / 'a.jpg'} device=cpu "
               f"save_txt=True conf=0.0 project={tmp_path} name=p")
    assert (tmp_path / "p" / "labels" / "a.txt").read_text().count("\n") > 0


def test_refusals_by_name(tmp_path, exported):
    m = YOLO("yolov8n.yaml", device="cpu")
    for fmt in ("savedmodel", "tflite"):
        with pytest.raises(NotImplementedError, match=f"{fmt}.*TensorFlow"):
            m.export(format=fmt, imgsz=64, project=str(tmp_path))
    with pytest.raises(NotImplementedError, match="int8=True"):
        m.export(format="onnx", int8=True, imgsz=64, project=str(tmp_path))
    with pytest.raises(NotImplementedError, match="nms=True for torchscript.*ctypes"):
        m.export(format="torchscript", nms=True, imgsz=64, project=str(tmp_path))
    with pytest.raises(ValueError, match="unknown format 'engine'"):
        m.export(format="engine", imgsz=64, project=str(tmp_path))
    with pytest.raises(ValueError, match="imgsz=48 must be a multiple of the model's largest stride, 32"):
        m.export(format="onnx", imgsz=48, project=str(tmp_path))
    for suffix, why in ((".stablehlo", "needs JAX"), (".tflite", "TensorFlow"), ("_saved_model", "TensorFlow")):
        with pytest.raises(NotImplementedError, match=why):
            YOLO(str(tmp_path / f"m{suffix}"), device="cpu")
    for name in ("yolov8-cls-resnet50.yaml", "yolov9e.yaml", "yolov6n.yaml"):  # ResNetLayer, CBLinear, ConvTranspose2d
        with pytest.raises(NotImplementedError, match="ONNX export: module (ResNetLayer|CBLinear|ConvTranspose2d)"):
            YOLO(name, device="cpu").export(format="onnx", imgsz=64, batch=1, project=str(tmp_path))
    art = YOLO(exported("yolov8n-p2-repvgg-sf.yaml")["onnx"], device="cpu")
    for call in (lambda: art.train(data="d.yaml"), lambda: art.export(format="onnx"), lambda: art.save(tmp_path / "x.npz")):
        with pytest.raises(NotImplementedError, match="export artifact or a serving URL"):
            call()
    for mode in ("tune", "benchmark"):
        with pytest.raises(NotImplementedError, match=f"{mode}.*not ported"):
            getattr(m, mode)()
    bad = tmp_path / "bad.onnx"
    doc = P.ModelProto.FromString(Path(exported("yolov8n-p2-repvgg-sf.yaml")["onnx"]).read_bytes())
    doc.graph.node[0].op_type = "LSTM"
    bad.write_bytes(doc.SerializeToString())
    with pytest.raises(NotImplementedError, match="op type 'LSTM'"):
        OnnxGraph(bad)


# onnx, grpc and google.protobuf as None entries too, as sklearn: torch's optional-import probes ask for onnx
EXPORT_RUN = BLOCKER.replace('"sklearn"}', '"sklearn", "google", "onnx", "grpc"}') + """
sys.modules.update(dict.fromkeys(("onnx", "grpc", "google", "google.protobuf")))
import json, sys, tempfile
import numpy as np
from drone_yolo_tpu_torch import YOLO
import drone_yolo_tpu_torch.utils.triton  # noqa: F401  (grpc only inside the gRPC transport)
d = tempfile.mkdtemp()
m = YOLO("yolov8n-p2-repvgg-sf.yaml", device="cpu")
frames = [np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)]
n = []
for fmt in ("onnx", "torchscript"):
    path = m.export(format=fmt, imgsz=64, batch=1, project=d)
    n.append(len(YOLO(path, device="cpu").predict(frames, conf=0.0, verbose=False)[0].boxes))
print(json.dumps({"n": n, "loaded": sorted(b for b in BLOCKED if sys.modules.get(b) is not None)}))
"""


def test_export_runs_without_jax_cv2_pil_yaml_protobuf_onnx_grpc():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", EXPORT_RUN], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [] and all(k > 0 for k in out["n"])
