"""The callback bus: named lifecycle events of the trainer, validator and predictor, each a list of functions.

Counterpart of `drone_yolo_tpu/utils/callbacks.py` (EVENTS, get_default_callbacks,
CallbackMixin) without the logger integrations. A function gets the trainer, validator or
predictor that fires the event; `YOLO.add_callback` forwards to every one a facade makes.
"""

from __future__ import annotations

from collections import defaultdict

EVENTS = [
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start", "on_train_epoch_start",
    "on_train_batch_start", "on_train_batch_end", "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_postprocess_end", "on_predict_batch_end",
    "on_predict_end",
]


def get_default_callbacks() -> defaultdict:
    """A fresh event -> list-of-functions registry."""
    return defaultdict(list, {e: [] for e in EVENTS})


class CallbackMixin:
    """`add_callback` and `run_callbacks` over `self.callbacks`."""

    def add_callback(self, event: str, func) -> None:
        self.callbacks[event].append(func)

    def run_callbacks(self, event: str) -> None:
        for cb in self.callbacks.get(event, []):
            cb(self)
