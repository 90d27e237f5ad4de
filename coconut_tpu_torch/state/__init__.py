"""The port's durable-state helpers: `atomic`, the tmp + fsync +
os.replace + directory-fsync replacement the stream checkpoints use (a
copy of `coconut_tpu/state/atomic.py`)."""

from .atomic import fsync_dir, replace_file, replace_json

__all__ = ["fsync_dir", "replace_file", "replace_json"]
