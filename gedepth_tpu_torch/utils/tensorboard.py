"""TensorBoard logging (the port of `gedepth_tpu.utils.tensorboard`): scalar
tags at every train record and evaluation, rgb / pred / gt triptychs on
request, in `work_dir/tb`.

The JAX package writes through `tf.summary`; this writes the same records
with the `tensorboard` package's protos and record framing into a plain
file, without tensorflow (tensorboard's own event writer imports it where
it is installed), torch.utils.tensorboard or PIL: a scalar is a float32
tensor of the `scalars` plugin, an image a [width, height, PNG] string
tensor of the `images` plugin (PNG from `utils.png`, colours from
`utils.color_depth`). Where `tensorboard` does not import, the logger does
nothing, as the JAX one does without tensorflow. It is imported when a
logger is made, never with this module.
"""
from __future__ import annotations

import itertools
import os
import socket
import time
from typing import Optional

import numpy as np

_FILES = itertools.count()


class TensorboardLogger:
    """A new event file in `log_dir`, written and flushed at each call; a
    no-op (`active` False) without the `tensorboard` package. `close()`
    closes the file."""

    def __init__(self, log_dir: str):
        try:
            from tensorboard.compat.proto import (
                event_pb2, summary_pb2, tensor_pb2, tensor_shape_pb2,
                types_pb2)
            from tensorboard.summary.writer.record_writer import (
                RecordWriter)
        except ImportError:
            self._writer = None
            return
        self._pb = (event_pb2, summary_pb2, tensor_pb2, tensor_shape_pb2,
                    types_pb2)
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_FILES)}")
        self.path = os.path.join(log_dir, name)
        self._writer = RecordWriter(open(self.path, "wb"))
        self._add(event_pb2.Event(wall_time=time.time(),
                                  file_version="brain.Event:2"))

    def _add(self, event):
        self._writer.write(event.SerializeToString())

    @property
    def active(self):
        return self._writer is not None

    def _write(self, step, tag, tensor, plugin, data_class):
        event_pb2, summary_pb2 = self._pb[:2]
        meta = summary_pb2.SummaryMetadata(
            plugin_data=summary_pb2.SummaryMetadata.PluginData(
                plugin_name=plugin),
            data_class=data_class)
        value = summary_pb2.Summary.Value(tag=tag, tensor=tensor,
                                          metadata=meta)
        self._add(event_pb2.Event(
            wall_time=time.time(), step=int(step),
            summary=summary_pb2.Summary(value=[value])))

    def scalars(self, step: int, values: dict, prefix: str = ""):
        """Every int or float of `values` (numpy scalars too; strings and
        the rest skipped) as the scalar `prefix + key`, in float32."""
        if not self.active:
            return
        _, summary_pb2, tensor_pb2, shape_pb2, types_pb2 = self._pb
        for k, v in values.items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                tensor = tensor_pb2.TensorProto(
                    dtype=types_pb2.DT_FLOAT,
                    tensor_shape=shape_pb2.TensorShapeProto(),
                    tensor_content=np.float32(v).tobytes())
                self._write(step, prefix + k, tensor, "scalars",
                            summary_pb2.DATA_CLASS_SCALAR)
        self._writer.flush()

    def _image(self, step, tag, rgb_u8):
        from gedepth_tpu_torch.utils.png import encode_png

        _, summary_pb2, tensor_pb2, shape_pb2, types_pb2 = self._pb
        h, w = rgb_u8.shape[:2]
        tensor = tensor_pb2.TensorProto(
            dtype=types_pb2.DT_STRING,
            tensor_shape=shape_pb2.TensorShapeProto(
                dim=[shape_pb2.TensorShapeProto.Dim(size=3)]),
            string_val=[str(w).encode(), str(h).encode(),
                        encode_png(rgb_u8)])
        self._write(step, tag, tensor, "images",
                    summary_pb2.DATA_CLASS_BLOB_SEQUENCE)

    def depth_triptych(self, step: int, rgb: np.ndarray, pred: np.ndarray,
                       gt: Optional[np.ndarray] = None, tag: str = "val"):
        """`tag`/rgb (clipped to 0..255), `tag`/pred and `tag`/gt (each
        coloured by `colorize_depth` over its own range)."""
        if not self.active:
            return
        from gedepth_tpu_torch.utils.color_depth import colorize_depth

        self._image(step, f"{tag}/rgb",
                    np.clip(rgb, 0, 255).astype(np.uint8))
        self._image(step, f"{tag}/pred", colorize_depth(pred))
        if gt is not None:
            self._image(step, f"{tag}/gt", colorize_depth(gt))
        self._writer.flush()

    def close(self):
        if self.active:
            self._writer.close()
            self._writer = None
