"""`python -m drone_yolo_tpu_torch [task] [mode] k=v ...`: the port's command line (`cfg.entrypoint`)."""

from drone_yolo_tpu_torch.cfg import entrypoint

if __name__ == "__main__":
    entrypoint()
