"""Fixed-shape packed training records and the feed that streams them.

Port of ``lipreading_video_generation_tpu/data/records.py``: training
samples drawn once (GAN windows, diffusion frame pairs) are packed into one
file a record, the fields back to back in C order, and streamed into
batches by the native prefetch loader (``data/native_loader``) or, where it
cannot run, by plain reads. File names and ``records_spec.json`` are the
JAX package's, byte for byte, so records packed by either package load in
the other.

``iter_record_batches.route_counts`` counts the iterators that took each
route ("native", "plain"), so a run can show which one fed it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

SPEC_FILENAME = "records_spec.json"


@dataclasses.dataclass(frozen=True)
class GanRecordSpec:
    """Byte layout of one packed GAN training sample: window, wrong_window
    (T, H, W, 3) uint8, start_frame int32, wav (wav_len,) float32 and, with
    ``max_text_len``, text_tokens (max_text_len,) int32. Its spec file keeps
    the window and wav parameters (no ``kind``)."""

    syncnet_T: int
    height: int
    width: int
    wav_len: int
    max_text_len: int = 0  # 0 = no text_tokens section

    def _tensor_spec(self) -> "TensorRecordSpec":
        t, h, w = self.syncnet_T, self.height, self.width
        fields = [
            ("window", (t, h, w, 3), "uint8"),
            ("wrong_window", (t, h, w, 3), "uint8"),
            ("start_frame", (), "int32"),
            ("wav", (self.wav_len,), "float32"),
        ]
        if self.max_text_len:
            fields.append(("text_tokens", (self.max_text_len,), "int32"))
        return TensorRecordSpec(fields=tuple(fields))

    @property
    def record_bytes(self) -> int:
        return self._tensor_spec().record_bytes

    def pack(self, sample: Dict[str, np.ndarray]) -> bytes:
        """A sample → its record's bytes; a longer wav keeps its head."""
        sample = dict(sample)
        sample["wav"] = np.ascontiguousarray(sample["wav"], np.float32)[: self.wav_len]
        sample["start_frame"] = np.asarray(sample["start_frame"], np.int32).reshape(())
        return self._tensor_spec().pack(sample)

    def unpack(self, raw: np.ndarray) -> Dict[str, np.ndarray]:
        """(record_bytes,) uint8 → sample dict (copies, C-contiguous)."""
        return self._tensor_spec().unpack(raw)

    def save(self, directory: str) -> None:
        with open(os.path.join(directory, SPEC_FILENAME), "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, directory: str) -> "GanRecordSpec":
        with open(os.path.join(directory, SPEC_FILENAME)) as f:
            return cls(**json.load(f))


@dataclasses.dataclass(frozen=True)
class TensorRecordSpec:
    """Generic fixed-shape record: an ordered tuple of named tensors
    ``(name, shape, dtype)``, packed back to back in C order."""

    fields: tuple  # ((name, (dims...), dtype-str), ...)

    @staticmethod
    def _field_bytes(shape, dtype) -> int:
        return int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize

    @property
    def record_bytes(self) -> int:
        return sum(self._field_bytes(s, d) for _, s, d in self.fields)

    def pack(self, sample: Dict[str, np.ndarray]) -> bytes:
        """A sample → its record's bytes; ``ValueError`` on a shape that is
        not the spec's."""
        parts = []
        for name, shape, dtype in self.fields:
            # np.asarray, not ascontiguousarray: that one makes a 0-d array 1-d
            a = np.asarray(sample[name], dtype, order="C")
            if a.shape != tuple(shape):
                raise ValueError(f"{name}: shape {a.shape} != spec {tuple(shape)}")
            parts.append(a.tobytes())
        return b"".join(parts)

    def unpack(self, raw: np.ndarray) -> Dict[str, np.ndarray]:
        out, o = {}, 0
        for name, shape, dtype in self.fields:
            n = self._field_bytes(shape, dtype)
            out[name] = np.frombuffer(raw[o: o + n].tobytes(), dtype).reshape(tuple(shape)).copy()
            o += n
        return out

    def save(self, directory: str) -> None:
        with open(os.path.join(directory, SPEC_FILENAME), "w") as f:
            json.dump({"kind": "tensor", "fields": list(self.fields)}, f)

    @classmethod
    def from_json(cls, obj: dict) -> "TensorRecordSpec":
        return cls(fields=tuple((name, tuple(shape), dtype) for name, shape, dtype in obj["fields"]))


def load_spec(directory: str):
    """Read ``records_spec.json``: a ``TensorRecordSpec`` where its ``kind``
    is "tensor", else a ``GanRecordSpec``."""
    with open(os.path.join(directory, SPEC_FILENAME)) as f:
        obj = json.load(f)
    if obj.get("kind") == "tensor":
        return TensorRecordSpec.from_json(obj)
    return GanRecordSpec(**obj)


def _record_name(i: int, num_records: int) -> str:
    return f"{i:0{max(6, len(str(num_records)))}d}.rec"


def write_gan_records(sampler, out_dir: str, num_records: int,
                      wav_len: Optional[int] = None) -> GanRecordSpec:
    """Draw ``num_records`` windows from a ``GanWindowSampler`` (after one
    probe draw that fixes the shapes, as in JAX) and write one record file
    each, the wav zero-padded to ``wav_len`` (default the probe's)."""
    os.makedirs(out_dir, exist_ok=True)
    probe = sampler.sample_batch(1)
    t, h, w = probe["window"].shape[1:4]
    wav_len = int(wav_len or probe["wav"].shape[1])
    spec = GanRecordSpec(
        syncnet_T=t, height=h, width=w, wav_len=wav_len,
        max_text_len=probe["text_tokens"].shape[1] if "text_tokens" in probe else 0,
    )
    spec.save(out_dir)
    for i in range(num_records):
        sample = {k: v[0] for k, v in sampler.sample_batch(1).items()}
        if len(sample["wav"]) < wav_len:
            sample["wav"] = np.pad(sample["wav"], (0, wav_len - len(sample["wav"])))
        with open(os.path.join(out_dir, _record_name(i, num_records)), "wb") as f:
            f.write(spec.pack(sample))
    return spec


def record_paths(records_dir: str) -> Sequence[str]:
    """The ``.rec`` files of ``records_dir``, sorted."""
    return sorted(os.path.join(records_dir, f) for f in os.listdir(records_dir)
                  if f.endswith(".rec"))


def iter_record_batches(records_dir: str, batch_size: int, loop: bool = True,
                        prefer_native: bool = True, num_threads: int = 2,
                        capacity: int = 16) -> Iterator[Dict[str, np.ndarray]]:
    """Stream packed records (either spec kind) as batches of stacked
    fields, for ever with ``loop``, else once with a trailing partial batch.

    With ``prefer_native`` the native loader reads them (the order is the
    order its threads finish); where no C++ compiler exists, or with
    ``prefer_native=False``, plain reads in file order. The route taken is
    counted in ``iter_record_batches.route_counts`` when the first record is
    asked for."""
    from . import native_loader

    spec = load_spec(records_dir)
    paths = record_paths(records_dir)
    if not paths:
        raise ValueError(f"no .rec files under {records_dir!r}")
    use_native = prefer_native and native_loader.native_available()
    iter_record_batches.route_counts["native" if use_native else "plain"] += 1

    def raw_records() -> Iterator[np.ndarray]:
        while True:
            if use_native:
                with native_loader.NativePrefetchLoader(
                        paths, (spec.record_bytes,), np.uint8, capacity=capacity,
                        num_threads=num_threads) as ldr:
                    for _, arr in ldr:
                        yield arr
            else:
                for p in paths:
                    yield np.fromfile(p, np.uint8)
            if not loop:
                return

    buf = []
    for raw in raw_records():
        buf.append(spec.unpack(raw))
        if len(buf) == batch_size:
            yield {k: np.stack([s[k] for s in buf]) for k in buf[0]}
            buf = []
    if buf:  # trailing partial batch (loop=False, count % batch_size != 0)
        yield {k: np.stack([s[k] for s in buf]) for k in buf[0]}


iter_record_batches.route_counts = {"native": 0, "plain": 0}
iter_gan_record_batches = iter_record_batches


def diffusion_record_spec(im_size: int, audio_samples: int) -> TensorRecordSpec:
    """One ``DiffusionPairSampler`` sample (condition frame, target frame,
    audio slice) at the train resolution."""
    return TensorRecordSpec(fields=(
        ("cond_frame", (im_size, im_size, 3), "uint8"),
        ("target_frame", (im_size, im_size, 3), "uint8"),
        ("audio", (audio_samples,), "float32"),
    ))


def write_diffusion_records(sampler, out_dir: str, num_records: int,
                            im_size: int) -> TensorRecordSpec:
    """Draw ``num_records`` frame pairs (after one probe draw, as in JAX),
    resize both frames to ``im_size`` on the CPU with ``ops/image.resize``
    (the op the train step uses; at the train size it is the identity, so
    the records equal the JAX package's byte for byte) and write one record
    file each."""
    import torch

    from ..ops import image as image_ops

    os.makedirs(out_dir, exist_ok=True)
    probe = sampler.sample_batch(1)
    spec = diffusion_record_spec(im_size, probe["audio"].shape[1])
    spec.save(out_dir)

    def sized(frame: np.ndarray) -> np.ndarray:
        return image_ops.resize(torch.from_numpy(np.ascontiguousarray(frame)),
                                (im_size, im_size)).numpy()

    for i in range(num_records):
        b = sampler.sample_batch(1)
        sample = {"cond_frame": sized(b["cond_frame"][0]),
                  "target_frame": sized(b["target_frame"][0]), "audio": b["audio"][0]}
        with open(os.path.join(out_dir, _record_name(i, num_records)), "wb") as f:
            f.write(spec.pack(sample))
    return spec
