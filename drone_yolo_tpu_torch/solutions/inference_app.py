"""A browser app for live detection and tracking (streamlit): the counterpart of
`drone_yolo_tpu/solutions/inference_app.py`.

As in the JAX package the UI module is injected (`st_module`; streamlit by default, which the app then needs) and so
is the frame source (`capture_factory`, called with the source and used as OpenCV's `VideoCapture`: `isOpened`,
`read`, `release`). The default source is `FrameCapture`: the port's own loader, which reads image files and MJPEG
AVI (`data/loaders.py`, `data/avi.py`); a webcam index and a container the port does not decode are refused by name.
An uploaded video is written to `drone_yolo_upload` with the upload's own suffix (the JAX app names every upload
`.mp4`). The model is built on `device` (the CUDA card unless "cpu").
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

LOGGER = logging.getLogger("drone_yolo_tpu_torch")

# the model choices of the dropdown (a yaml is a random init; users pass model="path/to/weights.npz")
DEFAULT_MODELS = ["yolov8n.yaml", "yolov8s.yaml", "yolo11n.yaml", "yolov8s-p2-repvgg-sf.yaml"]


class FrameCapture:
    """OpenCV's `VideoCapture` interface over the port's loader: frames of an image file, a directory or an MJPEG AVI,
    one a `read`. No source ("") opens nothing."""

    def __init__(self, source):
        from drone_yolo_tpu_torch.data.loaders import LoadImagesAndVideos

        if isinstance(source, int) or str(source).isdigit():
            raise NotImplementedError(f"webcam {source}: the port reads no camera device (it decodes image files and "
                                      "MJPEG AVI on the host; streams are refused by the loader too)")
        self._frames = iter(LoadImagesAndVideos(str(source))) if source else None

    def isOpened(self) -> bool:
        return self._frames is not None

    def read(self):
        try:
            return True, next(self._frames)[1][0]
        except StopIteration:
            self._frames = None
            return False, None

    def release(self) -> None:
        self._frames = None


class Inference:
    """Real-time detect or track UI: a model picker, confidence and IoU sliders, a class filter, a webcam or an
    uploaded video, the original and the annotated frame side by side."""

    def __init__(self, st_module=None, capture_factory=None, **kwargs: Any):
        if st_module is None:
            try:
                import streamlit as st_module  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "The interactive inference app needs streamlit (`pip install streamlit`)."
                ) from e
        self.st = st_module
        self._capture = capture_factory or FrameCapture
        self.source = None
        self.enable_trk = False
        self.conf = 0.25
        self.iou = 0.45
        self.org_frame = None
        self.ann_frame = None
        self.vid_file_name = None
        self.selected_ind: list[int] = []
        self.model = None
        self.model_path = kwargs.get("model")
        self.device = kwargs.get("device")
        LOGGER.info(f"Solutions inference app: {kwargs}")

    def web_ui(self):
        """Page config and header."""
        self.st.set_page_config(page_title="Drone-YOLO", layout="wide")
        self.st.markdown("<style>MainMenu {visibility: hidden;}</style>", unsafe_allow_html=True)
        self.st.markdown("<h1 style='text-align:center'>Drone-YOLO live inference</h1>", unsafe_allow_html=True)

    def sidebar(self):
        """Source, tracking and threshold controls; the two frame panes."""
        self.st.sidebar.title("Configuration")
        self.source = self.st.sidebar.selectbox("Video", ("webcam", "video"))
        self.enable_trk = self.st.sidebar.radio("Enable Tracking", ("Yes", "No"))
        self.conf = float(self.st.sidebar.slider("Confidence Threshold", 0.0, 1.0, self.conf, 0.01))
        self.iou = float(self.st.sidebar.slider("IoU Threshold", 0.0, 1.0, self.iou, 0.01))
        col1, col2 = self.st.columns(2)
        self.org_frame = col1.empty()
        self.ann_frame = col2.empty()

    def source_upload(self):
        """Webcam index 0, or the uploaded video written to a file of its own suffix."""
        self.vid_file_name = ""
        if self.source == "video":
            vid_file = self.st.sidebar.file_uploader("Upload Video File", type=["mp4", "mov", "avi", "mkv"])
            if vid_file is not None:
                self.vid_file_name = "drone_yolo_upload" + Path(vid_file.name).suffix.lower()
                Path(self.vid_file_name).write_bytes(vid_file.read())
        elif self.source == "webcam":
            self.vid_file_name = 0

    def configure(self):
        """The model dropdown (local choices only) and the class multiselect."""
        from drone_yolo_tpu_torch.engine.model import YOLO

        available = list(DEFAULT_MODELS)
        if self.model_path:
            available.insert(0, self.model_path)
        selected_model = self.st.sidebar.selectbox("Model", available)
        with self.st.spinner("Loading model..."):
            self.model = YOLO(selected_model, device=self.device)
            class_names = list(self.model.names.values())
        self.st.success("Model loaded!")
        selected_classes = self.st.sidebar.multiselect("Classes", class_names, default=class_names[:3])
        self.selected_ind = [class_names.index(option) for option in selected_classes]

    def inference(self):
        """The whole app: UI, configuration, then the frame loop."""
        self.web_ui()
        self.sidebar()
        self.source_upload()
        self.configure()

        if self.st.sidebar.button("Start"):
            stop_button = self.st.button("Stop")
            cap = self._capture(self.vid_file_name)
            if not cap.isOpened():
                self.st.error("Could not open source.")
            while cap.isOpened():
                success, frame = cap.read()
                if not success:
                    self.st.warning("Failed to read frame.")
                    break
                if self.enable_trk == "Yes":
                    results = self.model.track(frame, conf=self.conf, iou=self.iou,
                                               classes=self.selected_ind or None, persist=True)
                else:
                    results = self.model(frame, conf=self.conf, iou=self.iou, classes=self.selected_ind or None)
                annotated_frame = results[0].plot()
                if stop_button:
                    cap.release()
                    self.st.stop()
                self.org_frame.image(frame, channels="BGR")
                self.ann_frame.image(annotated_frame, channels="BGR")
            cap.release()


if __name__ == "__main__":  # pragma: no cover
    import sys

    Inference(model=sys.argv[1] if len(sys.argv) > 1 else None).inference()
