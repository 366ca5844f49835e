"""Triton Inference Server client over the open KServe-v2 protocol (REST + gRPC).

Counterpart of `drone_yolo_tpu/utils/triton.py` (TritonRemoteModel), with no `tritonclient`: the v2
inference protocol is plain HTTP + JSON (with the binary-tensor extension), spoken through urllib;
its gRPC flavour is spoken through grpcio's generic unary calls with the wire codec of
`utils/pbwire.py`, no generated stubs, and `grpc` is imported only when a `grpc://` or `grpcs://`
URL is opened. Works against Triton and any KServe-v2 server (the test doubles of the tests, the
local server of `chip_smoke.py`).

Protocol notes (REST)
---------------------
* model config:  GET  {server}/v2/models/{name}/config        (Triton extension)
  fallback:      GET  {server}/v2/models/{name}               (KServe metadata)
* inference:     POST {server}/v2/models/{name}/infer
  Requests use the binary-data extension (JSON header + concatenated raw
  little-endian tensor bytes, sized by the ``Inference-Header-Content-Length``
  header); responses may come back either binary or pure-JSON — both parsed.

Protocol notes (gRPC, scheme ``grpc://`` / ``grpcs://``)
--------------------------------------------------------
* service ``inference.GRPCInferenceService``: ``ModelMetadata`` for the tensor
  signature, ``ModelConfig`` (best-effort, Triton extension) for
  ``parameters.metadata`` (class names/task/imgsz), ``ModelInfer`` with
  ``raw_input_contents`` / ``raw_output_contents`` (little-endian tensor
  bytes, the same layout the REST binary extension uses). Servers that answer
  with typed ``InferTensorContents`` instead of raw buffers are decoded too.
"""

from __future__ import annotations

import json
import urllib.request
from typing import List
from urllib.parse import urlsplit

import numpy as np

from drone_yolo_tpu_torch.utils import pbwire as pb

# Triton config files use TYPE_-prefixed names; v2 metadata uses the bare ones.
_DTYPES = {
    "BOOL": np.bool_,
    "UINT8": np.uint8,
    "UINT16": np.uint16,
    "UINT32": np.uint32,
    "UINT64": np.uint64,
    "INT8": np.int8,
    "INT16": np.int16,
    "INT32": np.int32,
    "INT64": np.int64,
    "FP16": np.float16,
    "FP32": np.float32,
    "FP64": np.float64,
}


def _np_dtype(name: str):
    return _DTYPES[name.replace("TYPE_", "")]


# InferTensorContents field number per datatype (KServe-v2 grpc proto): which
# typed repeated field a non-raw server puts this datatype's values in.
_CONTENTS_FIELD = {
    "BOOL": 1, "INT8": 2, "INT16": 2, "INT32": 2, "INT64": 3,
    "UINT8": 4, "UINT16": 4, "UINT32": 4, "UINT64": 5, "FP32": 6, "FP64": 7,
}  # fmt: skip


def _decode_contents(datatype: str, buf: bytes) -> bytes:
    """Decode an InferTensorContents submessage into raw little-endian tensor
    bytes of `datatype` (the same layout raw_output_contents would carry).
    Fallback path for KServe servers that return typed contents instead of raw
    buffers; FP16/BYTES have no typed field and must use raw contents."""
    want = _CONTENTS_FIELD.get(datatype.replace("TYPE_", ""))
    if want is None:
        raise ValueError(f"datatype {datatype} has no InferTensorContents field; server must use raw_output_contents")
    np_dt = _np_dtype(datatype)
    fixed = datatype.replace("TYPE_", "") in ("FP32", "FP64")
    vals, raw = [], b""
    for f, w, v in pb.fields(buf):
        if f != want:
            continue
        if fixed:  # packed fixed32/64 LEN chunks are already raw LE bytes
            raw += v if w == pb.LEN else v
        elif w == pb.LEN:  # packed varints
            vals += pb.unpack_int64(v)
        else:  # unpacked single varint
            vals.append(v - (1 << 64) if v >= 1 << 63 else v)
    if fixed:
        return np.frombuffer(raw, dtype="<f4" if np_dt == np.float32 else "<f8").astype(np_dt).tobytes()
    return np.asarray(vals, dtype=np.int64).astype(np_dt).tobytes()


class _GrpcInference:
    """KServe-v2 gRPC transport: generic unary calls + pbwire message codec."""

    _SVC = "/inference.GRPCInferenceService/"

    def __init__(self, target: str, secure: bool, timeout: float):
        import grpc  # only here: the optional transport

        self.timeout = timeout
        channel = grpc.secure_channel(target, grpc.ssl_channel_credentials()) if secure else grpc.insecure_channel(target)
        ident = lambda b: b  # noqa: E731 — messages are pre-encoded bytes
        self._meta_call = channel.unary_unary(self._SVC + "ModelMetadata", request_serializer=ident, response_deserializer=ident)
        self._infer_call = channel.unary_unary(self._SVC + "ModelInfer", request_serializer=ident, response_deserializer=ident)
        self._config_call = channel.unary_unary(self._SVC + "ModelConfig", request_serializer=ident, response_deserializer=ident)

    # -- ModelMetadata -------------------------------------------------------
    def metadata(self, model: str) -> dict:
        req = pb.string_field(1, model)  # ModelMetadataRequest.name
        resp = self._meta_call(req, timeout=self.timeout)

        def tensor_meta(buf: bytes) -> dict:  # TensorMetadata{name=1, datatype=2, shape=3}
            t = {"name": "", "datatype": "", "shape": []}
            for f, w, v in pb.fields(buf):
                if f == 1:
                    t["name"] = v.decode()
                elif f == 2:
                    t["datatype"] = v.decode()
                elif f == 3:
                    t["shape"] += pb.unpack_int64(v) if w == pb.LEN else [v]
            return t

        md = {"inputs": [], "outputs": []}
        for f, _, v in pb.fields(resp):
            if f == 4:  # ModelMetadataResponse.inputs
                md["inputs"].append(tensor_meta(v))
            elif f == 5:  # .outputs
                md["outputs"].append(tensor_meta(v))
        return md

    # -- ModelConfig (Triton extension) ---------------------------------------
    def config_parameters(self, model: str) -> dict:
        """Triton's ModelConfig call -> the config's string `parameters` map
        (where the exporter stashes names/task/imgsz as parameters.metadata).
        Best-effort: non-Triton KServe servers don't implement ModelConfig, so
        any transport/parse failure returns {}."""
        try:
            resp = self._config_call(pb.string_field(1, model), timeout=self.timeout)
            params = {}
            for f, _, v in pb.fields(resp):
                if f != 1:  # ModelConfigResponse.config
                    continue
                for f2, _, v2 in pb.fields(v):
                    if f2 != 14:  # ModelConfig.parameters map<string, ModelParameter>
                        continue
                    k = sv = None
                    for f3, _, v3 in pb.fields(v2):  # map entry {key=1, value=2}
                        if f3 == 1:
                            k = v3.decode()
                        elif f3 == 2:  # ModelParameter{string_value=1}
                            for f4, _, v4 in pb.fields(v3):
                                if f4 == 1:
                                    sv = v4.decode()
                    if k is not None and sv is not None:
                        params[k] = sv
            return params
        except Exception:
            return {}

    # -- ModelInfer ------------------------------------------------------------
    def infer(self, model: str, inputs, output_names) -> dict:
        """inputs: [(name, datatype, shape, raw_bytes)] -> {name: (datatype, shape, raw)}."""
        req = bytearray(pb.string_field(1, model))  # ModelInferRequest.model_name
        for name, datatype, shape, _ in inputs:
            tensor = pb.string_field(1, name) + pb.string_field(2, datatype) + pb.packed_int64_field(3, list(shape))
            req += pb.bytes_field(5, tensor)  # .inputs (InferInputTensor)
        for name in output_names:
            req += pb.bytes_field(6, pb.string_field(1, name))  # .outputs
        for _, _, _, raw in inputs:
            req += pb.bytes_field(7, raw)  # .raw_input_contents
        resp = self._infer_call(bytes(req), timeout=self.timeout)

        outs, raws = [], []
        for f, w, v in pb.fields(resp):
            if f == 5:  # ModelInferResponse.outputs (InferOutputTensor)
                o = {"name": "", "datatype": "", "shape": [], "contents": b""}
                for f2, w2, v2 in pb.fields(v):
                    if f2 == 1:
                        o["name"] = v2.decode()
                    elif f2 == 2:
                        o["datatype"] = v2.decode()
                    elif f2 == 3:
                        o["shape"] += pb.unpack_int64(v2) if w2 == pb.LEN else [v2]
                    elif f2 == 5:  # .contents (InferTensorContents) — non-raw servers
                        o["contents"] += v2
                outs.append(o)
            elif f == 6:  # .raw_output_contents
                raws.append(v)
        if len(raws) == len(outs):  # Triton: raw buffers, positionally matched
            return {o["name"]: (o["datatype"], o["shape"], raw) for o, raw in zip(outs, raws)}
        if not raws and all(o["contents"] for o in outs):  # KServe typed contents
            return {o["name"]: (o["datatype"], o["shape"], _decode_contents(o["datatype"], o["contents"])) for o in outs}
        raise ValueError(
            f"server returned {len(outs)} output tensors but {len(raws)} raw buffers "
            "and no typed InferTensorContents — unsupported response encoding"
        )


class TritonRemoteModel:
    """Callable remote model: ``outputs = model(*numpy_inputs)``.

    The attributes of the JAX package's client: `endpoint`, `url`, `input_names`, `input_formats`,
    `np_input_formats`, `output_names` and `metadata` (the JSON of the config's `parameters.metadata`).
    """

    def __init__(self, url: str, endpoint: str = "", scheme: str = "", timeout: float = 60.0):
        if not endpoint and not scheme:  # parse "<scheme>://<netloc>/<endpoint>"
            splits = urlsplit(url)
            endpoint = splits.path.strip("/").split("/")[0]
            scheme = splits.scheme
            url = splits.netloc
        if scheme not in ("", "http", "https", "grpc", "grpcs"):
            raise ValueError(f"unsupported scheme '{scheme}' (use http(s):// or grpc(s)://)")
        self.endpoint = endpoint
        self.url = url
        self.timeout = timeout
        self._grpc = None
        if scheme in ("grpc", "grpcs"):
            self._grpc = _GrpcInference(url, secure=scheme == "grpcs", timeout=timeout)
        # keep the caller's scheme: downgrading https:// to cleartext would leak payloads and auth headers
        self._base = f"{scheme or 'http'}://{url}/v2/models/{endpoint}"

        config = self._get_config()
        config["output"] = sorted(config["output"], key=lambda x: x.get("name"))
        self.input_formats = [x["data_type"] for x in config["input"]]
        self.np_input_formats = [_np_dtype(x) for x in self.input_formats]
        self.input_names = [x["name"] for x in config["input"]]
        self.output_names = [x["name"] for x in config["output"]]
        meta = config.get("parameters", {}).get("metadata", {})
        if isinstance(meta, dict):
            meta = meta.get("string_value", "")
        try:
            self.metadata = json.loads(meta) if meta else None
        except json.JSONDecodeError:
            self.metadata = None

    # -- HTTP ------------------------------------------------------------------
    def _http(self, path: str, data: bytes | None = None, headers: dict | None = None):
        req = urllib.request.Request(self._base + path, data=data, headers=headers or {})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:  # noqa: S310 (user-supplied server)
            return dict(r.headers), r.read()

    def _get_config(self) -> dict:
        if self._grpc is not None:  # gRPC: ModelMetadata carries the tensor signature
            md = self._grpc.metadata(self.endpoint)
            conv = lambda ts: [{"name": t["name"], "data_type": t["datatype"], "dims": t.get("shape", [])} for t in ts]  # noqa: E731
            # Triton's ModelConfig call (best-effort) carries parameters.metadata
            # — class names/task/imgsz, same as the REST /config endpoint
            params = self._grpc.config_parameters(self.endpoint)
            return {"input": conv(md.get("inputs", [])), "output": conv(md.get("outputs", [])), "parameters": params}
        try:  # Triton's config endpoint: {"input": [{"name","data_type","dims"}..], "output": [..]}
            _, body = self._http("/config")
            return json.loads(body)
        except Exception:
            # KServe metadata: {"inputs": [{"name","datatype","shape"}..], "outputs": [..]}
            _, body = self._http("")
            md = json.loads(body)
            conv = lambda ts: [{"name": t["name"], "data_type": t["datatype"], "dims": t.get("shape", [])} for t in ts]
            return {"input": conv(md.get("inputs", [])), "output": conv(md.get("outputs", [])), "parameters": {}}

    # -- inference -------------------------------------------------------------
    def __call__(self, *inputs: np.ndarray) -> List[np.ndarray]:
        out_format = inputs[0].dtype
        if self._grpc is not None:
            gin = []
            for i, x in enumerate(inputs):
                x = np.ascontiguousarray(x, dtype=self.np_input_formats[i])
                gin.append((self.input_names[i], self.input_formats[i].replace("TYPE_", ""), x.shape, x.tobytes()))
            by_name = self._grpc.infer(self.endpoint, gin, self.output_names)
            outs = []
            for n in self.output_names:
                datatype, shape, raw = by_name[n]
                outs.append(np.frombuffer(raw, dtype=_np_dtype(datatype)).reshape(shape).astype(out_format))
            return outs
        header_inputs, blobs = [], []
        for i, x in enumerate(inputs):
            x = np.ascontiguousarray(x, dtype=self.np_input_formats[i])
            blob = x.tobytes()
            header_inputs.append(
                {
                    "name": self.input_names[i],
                    "shape": list(x.shape),
                    "datatype": self.input_formats[i].replace("TYPE_", ""),
                    "parameters": {"binary_data_size": len(blob)},
                }
            )
            blobs.append(blob)
        header = json.dumps(
            {
                "inputs": header_inputs,
                "outputs": [{"name": n, "parameters": {"binary_data": True}} for n in self.output_names],
            }
        ).encode()
        body = header + b"".join(blobs)
        resp_headers, resp = self._http(
            "/infer",
            data=body,
            headers={
                "Content-Type": "application/octet-stream",
                "Inference-Header-Content-Length": str(len(header)),
            },
        )
        return [o.astype(out_format) for o in self._parse_response(resp_headers, resp)]

    def _parse_response(self, headers: dict, resp: bytes) -> List[np.ndarray]:
        hlen = next((int(v) for k, v in headers.items() if k.lower() == "inference-header-content-length"), len(resp))
        rj = json.loads(resp[:hlen])
        by_name, offset = {}, hlen
        for o in rj["outputs"]:
            dt, shape = _np_dtype(o["datatype"]), o["shape"]
            nbytes = int(o.get("parameters", {}).get("binary_data_size", 0))
            if nbytes:  # binary extension payload
                arr = np.frombuffer(resp[offset : offset + nbytes], dtype=dt).reshape(shape)
                offset += nbytes
            else:  # pure-JSON data array
                arr = np.asarray(o["data"], dtype=dt).reshape(shape)
            by_name[o["name"]] = arr
        return [by_name[n] for n in self.output_names]
