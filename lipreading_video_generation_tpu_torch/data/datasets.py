"""Dataset samplers: fixed-shape numpy batches for the trainers.

Port of ``lipreading_video_generation_tpu/data/datasets.py``, copied in
numpy so that a seed gives batches and clips equal to the JAX package's bit
for bit: ``WordClipSampler`` and ``synthetic_word_clips`` (ViViT);
``GanClip``, ``GanWindowSampler``, ``load_gan_clip``, ``synthetic_gan_clips``
and ``synthetic_av_clips`` (with ``_formant_wave`` and ``_render_face_clip``)
(the GAN), ``synthetic_word_av_clips`` and ``mouth_aperture_proxy`` (the
lip expert); ``FrameItem``, ``build_frame_index``, ``save_frame_index`` /
``load_frame_index`` (pickles interchangeable with the JAX package's),
``split_records``, ``DiffusionPairSampler``, ``condition_from_video``,
``condition_windows_from_video`` and ``load_full_video_sample`` (diffusion).

Videos are decoded with OpenCV, imported on call. Where it is absent the
diffusion side takes frames through seams: ``frame_count=path -> int`` and
``read_frames=path -> (frames, fps)``, defaulting to ``data/video``'s
``video_frame_count`` and ``read_video_frames``. Transcript batches
(``with_text``: ``text_tokens``, the clip's transcript through
``models.lip_expert.encode_transcript``) feed the GAN's lip-expert loss;
``synthetic_word_av_clips`` codes a word in the mouth's motion for the
expert's training, and ``mouth_aperture_proxy`` measures a drawn mouth's
opening for ``pipelines/expert_proof``.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import video
from .video import _cv2, load_wav


class WordClipSampler:
    """Per-word mouth-ROI windows → fixed (T, H, W) uint8 clips + label ids.

    Clips shorter than ``max_frames`` are zero-padded, longer ones cut.
    """

    def __init__(
        self,
        clips: Sequence[np.ndarray],   # each (t, H, W) or (t, H, W, C) uint8
        labels: Sequence[int],
        max_frames: int = 5,
        seed: int = 0,
    ):
        if len(clips) != len(labels):
            raise ValueError(f"{len(clips)} clips but {len(labels)} labels")
        self.clips = list(clips)
        self.labels = np.asarray(labels, np.int32)
        self.max_frames = max_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.clips)

    def _fix(self, clip: np.ndarray) -> np.ndarray:
        if clip.ndim == 3:
            clip = clip[..., None]
        t = len(clip)
        if t >= self.max_frames:
            return clip[: self.max_frames]
        pad = np.zeros((self.max_frames - t,) + clip.shape[1:], clip.dtype)
        return np.concatenate([clip, pad])

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Whole batches of ``{"clips": (B, T, H, W, C) uint8, "labels": (B,)
        int32}``; a shuffled pass draws its order from the sampler's own
        generator, so each epoch has another."""
        idx = np.arange(len(self.clips))
        if shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            pick = idx[i : i + batch_size]
            yield {
                "clips": np.stack([self._fix(self.clips[j]) for j in pick]),
                "labels": self.labels[pick],
            }


@dataclass
class GanClip:
    """One preprocessed clip: face-crop frames and the raw waveform (and a
    transcript, where there is one)."""

    frames: np.ndarray  # (T, H, W, 3) uint8 face crops
    wav: np.ndarray     # float32 @ 16 kHz
    text: Optional[str] = None


class GanWindowSampler:
    """{window, wrong_window, start_frame, wav} batches: a random clip (of at
    least 3·T frames), a random T-frame window and an independent "wrong"
    reference window of the same clip, the whole wave zero-padded to the
    longest clip's; with ``with_text`` also ``text_tokens`` (B,
    ``max_text_len``) int32, the clip's transcript PAD-padded (an empty one
    for a clip without). The draws come from ``np.random.default_rng(seed)``
    in the JAX package's order."""

    def __init__(self, clips: Sequence[GanClip], syncnet_T: int = 5, seed: int = 0,
                 with_text: bool = False, max_text_len: int = 48):
        self.clips = [c for c in clips if len(c.frames) >= 3 * syncnet_T]
        if not self.clips:
            raise ValueError("no clip long enough for windowed sampling")
        self.T = syncnet_T
        self.rng = np.random.default_rng(seed)
        self.with_text = with_text
        self.max_text_len = max_text_len

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        from ..models.lip_expert import encode_transcript

        windows, wrongs, starts, wavs, tokens = [], [], [], [], []
        max_wav = max(len(c.wav) for c in self.clips)
        for _ in range(batch_size):
            clip = self.clips[self.rng.integers(len(self.clips))]
            n = len(clip.frames)
            start = int(self.rng.integers(0, n - self.T + 1))
            wrong = int(self.rng.integers(0, n - self.T + 1))
            while wrong == start and n > self.T:
                wrong = int(self.rng.integers(0, n - self.T + 1))
            windows.append(clip.frames[start: start + self.T])
            wrongs.append(clip.frames[wrong: wrong + self.T])
            starts.append(start)
            wavs.append(np.pad(clip.wav, (0, max_wav - len(clip.wav))))
            if self.with_text:
                tokens.append(encode_transcript(clip.text or "", self.max_text_len))
        batch = {
            "window": np.stack(windows),          # (B, T, H, W, 3) uint8
            "wrong_window": np.stack(wrongs),     # (B, T, H, W, 3) uint8
            "start_frame": np.asarray(starts, np.int32),
            "wav": np.stack(wavs).astype(np.float32),
        }
        if self.with_text:
            batch["text_tokens"] = np.stack(tokens)
        return batch


def load_gan_clip(frames_dir: str, img_size: Optional[int] = None) -> GanClip:
    """A preprocessed clip directory of ``{i}.jpg`` frames, ``audio.wav``
    and an optional ``text.txt`` (``preprocess-gan``'s layout) → ``GanClip``
    (RGB frames, resized to ``img_size`` square if given)."""
    cv2 = _cv2("load_gan_clip")
    names = sorted((f for f in os.listdir(frames_dir) if f.endswith(".jpg")),
                   key=lambda f: int(os.path.splitext(f)[0]))
    frames = []
    for name in names:
        img = cv2.imread(os.path.join(frames_dir, name))[:, :, ::-1]
        if img_size is not None:
            img = cv2.resize(img, (img_size, img_size))
        frames.append(img)
    wav = load_wav(os.path.join(frames_dir, "audio.wav"))
    text = None
    text_path = os.path.join(frames_dir, "text.txt")
    if os.path.exists(text_path):
        with open(text_path) as f:
            text = f.readline().strip().lower()
    return GanClip(np.stack(frames), wav, text=text)


FrameCount = Callable[[str], int]
ReadFrames = Callable[[str], Tuple[np.ndarray, float]]


@dataclass(frozen=True)
class FrameItem:
    """(video_path, frame_start, frame_end): one diffusion frame pair."""

    video_path: str
    frame_start: int
    frame_end: int


def build_frame_index(video_paths: Sequence[str], step: int = 6,
                      fps_effective: float = 30.0,
                      frame_count: Optional[FrameCount] = None) -> List[FrameItem]:
    """Frame pairs (start, start + ``step``) every ``step`` frames of each
    video, up to the last full step. ``frame_count(path)`` gives a video's
    frame count (default ``video.video_frame_count``, OpenCV)."""
    frame_count = frame_count or video.video_frame_count
    items: List[FrameItem] = []
    for path in video_paths:
        n = frame_count(path)
        for start in range(0, max(0, n - step), step):
            items.append(FrameItem(path, start, start + step))
    return items


def save_frame_index(items: Sequence[FrameItem], path: str) -> None:
    """Pickle the index as a list of plain (path, start, end) tuples, as the
    JAX package writes it (once, by the primary rank under a process group:
    ``parallel.distributed.write_once``)."""
    from ..parallel.distributed import write_once

    rows = [(it.video_path, it.frame_start, it.frame_end) for it in items]

    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            pickle.dump(rows, f)

    write_once(path, write)


def load_frame_index(path: str) -> List[FrameItem]:
    """An index pickle of tuples, ``FrameItem``s or any objects with
    ``video_path``/``frame_start``/``frame_end`` (the reference's). Only
    load pickles this program or a trusted tool wrote: unpickling runs code."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    out = []
    for item in raw:
        if isinstance(item, FrameItem):
            out.append(item)
        elif isinstance(item, (tuple, list)):
            out.append(FrameItem(*item))
        else:
            out.append(FrameItem(item.video_path, item.frame_start, item.frame_end))
    return out


def split_records(items: Sequence, train: float = 0.8, val: float = 0.1,
                  seed: int = 0) -> Tuple[list, list, list]:
    """Deterministic train/val/test split of a permutation drawn from
    ``np.random.default_rng(seed)`` (80/10/10 by default)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(items))
    n_train = int(train * len(items))
    n_val = int(val * len(items))
    pick = lambda ids: [items[i] for i in ids]  # noqa: E731
    return pick(idx[:n_train]), pick(idx[n_train: n_train + n_val]), pick(idx[n_train + n_val:])


class DiffusionPairSampler:
    """FrameItem → (condition frame ``frame_start``, target frame
    ``frame_end``, the audio slice starting ``buffer_frames`` frames before
    the target at the video's fps, zero-padded to ``audio_samples`` at
    16 kHz). A video's wav is its sidecar ``.wav`` (else 1 s of silence);
    the last ``cache_size`` videos stay decoded. ``read_frames(path)`` gives
    (frames, fps) (default ``video.read_video_frames``, OpenCV)."""

    def __init__(self, items: Sequence[FrameItem], audio_samples: int = 4000,
                 buffer_frames: int = 5, fps: float = 25.0, seed: int = 0,
                 cache_size: int = 64, read_frames: Optional[ReadFrames] = None):
        self.items = list(items)
        self.audio_samples = audio_samples
        self.buffer_frames = buffer_frames
        self.fps = fps
        self.rng = np.random.default_rng(seed)
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray, float]] = {}
        self._cache_size = cache_size
        self._read_frames = read_frames or video.read_video_frames

    def _load(self, path: str):
        if path not in self._cache:
            if len(self._cache) >= self._cache_size:
                self._cache.pop(next(iter(self._cache)))
            frames, fps = self._read_frames(path)
            wav_path = os.path.splitext(path)[0] + ".wav"
            wav = load_wav(wav_path) if os.path.exists(wav_path) else np.zeros(16000, np.float32)
            self._cache[path] = (frames, wav, fps)
        return self._cache[path]

    def get(self, item: FrameItem) -> Dict[str, np.ndarray]:
        frames, wav, fps = self._load(item.video_path)
        t_end = min(item.frame_end, len(frames) - 1)
        cond = frames[min(item.frame_start, len(frames) - 1)]
        target = frames[t_end]
        sr = 16000
        start = int(max(0.0, (t_end - self.buffer_frames) / fps) * sr)
        sl = wav[start: start + self.audio_samples]
        sl = np.pad(sl, (0, self.audio_samples - len(sl)))
        return {"cond_frame": cond, "target_frame": target, "audio": sl.astype(np.float32)}

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        picks = self.rng.integers(0, len(self.items), batch_size)
        rows = [self.get(self.items[i]) for i in picks]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def condition_from_video(video_path: str, cfg, audio_path: Optional[str] = None,
                         frame_step: int = 6,
                         read_frames: Optional[ReadFrames] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(condition frame uint8, audio window float32) for sampling from a real
    clip: its first frame, and the ``buffer_frames``-before-target window of
    its audio for the target frame ``frame_step``."""
    frames, fps = (read_frames or video.read_video_frames)(video_path)
    target_idx = min(frame_step, len(frames) - 1)
    wav = _clip_audio(video_path, audio_path)
    return frames[0], _audio_window(wav, target_idx, fps, cfg)


def _clip_audio(video_path: str, audio_path: Optional[str] = None,
                sr: int = 16000) -> np.ndarray:
    """A clip's whole wave: ``audio_path``, else the sidecar ``.wav``, else
    extracted with ffmpeg; ``ValueError`` when none of them is there."""
    if audio_path is not None:
        return load_wav(audio_path, sr)
    sidecar = os.path.splitext(video_path)[0] + ".wav"
    if os.path.exists(sidecar):
        return load_wav(sidecar, sr)
    import tempfile

    # a temporary file in a writable directory: the source tree may be read-only
    fd, tmp = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        if video.extract_audio(video_path, tmp, sr):
            return load_wav(tmp, sr)
    finally:
        os.unlink(tmp)
    raise ValueError(f"no audio for {video_path!r}: pass --cond-audio, add a sidecar .wav, "
                     "or install ffmpeg")


def _audio_window(wav: np.ndarray, target_idx: int, fps: float, cfg,
                  sr: int = 16000) -> np.ndarray:
    """The slice from ``buffer_frames`` frames before the target, zero-padded
    to ``cfg.audio_samples``."""
    start = int(max(0.0, (target_idx - cfg.buffer_frames) / fps) * sr)
    sl = wav[start: start + cfg.audio_samples]
    return np.pad(sl, (0, cfg.audio_samples - len(sl))).astype(np.float32)


def condition_windows_from_video(
        video_path: str, cfg, n_frames: int, audio_path: Optional[str] = None,
        read_frames: Optional[ReadFrames] = None) -> Tuple[np.ndarray, np.ndarray, float]:
    """(condition frame uint8, (n_frames, audio_samples) windows, fps) for
    whole-clip sampling: the first frame conditions every target frame j,
    whose window is the slice before frame j."""
    frames, fps = (read_frames or video.read_video_frames)(video_path)
    wav = _clip_audio(video_path, audio_path)
    windows = np.stack([_audio_window(wav, j, fps, cfg) for j in range(n_frames)])
    return frames[0], windows, fps


def load_full_video_sample(video_path: str, transcript_path: Optional[str] = None,
                           audio_samples_per_frame: int = 640) -> Dict[str, object]:
    """A whole video: every frame, the sidecar wav (else silence as long as
    the video at ``audio_samples_per_frame`` a frame), the transcript's
    text and the fps."""
    from .manifest import parse_transcript

    frames, fps = video.read_video_frames(video_path)
    wav_path = os.path.splitext(video_path)[0] + ".wav"
    wav = load_wav(wav_path) if os.path.exists(wav_path) else np.zeros(
        int(len(frames) * audio_samples_per_frame), np.float32)
    text = ""
    if transcript_path and os.path.exists(transcript_path):
        text, _ = parse_transcript(transcript_path)
    return {"frames": frames, "audio": wav, "text": text, "fps": fps}


def synthetic_gan_clips(n_clips: int = 4, frames: int = 25, img: int = 96, seed: int = 0,
                        with_text: bool = False) -> List[GanClip]:
    """Uncorrelated clips: uniform noise frames and a Gaussian wave of 1 s
    (with ``with_text``, a transcript of three words drawn after each)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clips):
        f = rng.integers(0, 256, (frames, img, img, 3), dtype=np.uint8)
        wav = (rng.standard_normal(16000) * 0.1).astype(np.float32)
        out.append(GanClip(f, wav, text=_three_words(rng) if with_text else None))
    return out


_WORDS = ["hello", "world", "about", "place", "think", "right"]


def _three_words(rng: np.random.Generator) -> str:
    return " ".join(_WORDS[int(j)] for j in rng.integers(0, len(_WORDS), 3))


def synthetic_av_clips(n_clips: int = 6, frames: int = 50, img: int = 96, seed: int = 0,
                       sr: int = 16000, fps: float = 25.0,
                       with_text: bool = False) -> List[GanClip]:
    """Audio-visually correlated clips: a smooth per-frame envelope in (0, 1]
    drives both the wave (``_formant_wave``) and the opening of a dark mouth
    ellipse on a static drawn face (``_render_face_clip``), so a sync expert
    trained on them has the audio↔lip correspondence to learn (with
    ``with_text``, a transcript of three words drawn after each)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_clips):
        env = rng.uniform(0.05, 1.0, frames)
        env = np.convolve(env, [0.25, 0.5, 0.25], mode="same")
        env = env / env.max()
        wav = _formant_wave(env, sr=sr, fps=fps, f0=110.0 + 13.0 * i)
        f = _render_face_clip(env, img, rng)
        out.append(GanClip(f, wav, text=_three_words(rng) if with_text else None))
    return out


def _formant_wave(env: np.ndarray, sr: int = 16000, fps: float = 25.0,
                  f0: float = 110.0) -> np.ndarray:
    """Envelope → wave: a harmonic stack on ``f0`` whose spectral centroid
    (400 + 3000·env Hz) tracks the per-frame envelope, amplitude-modulated
    by it."""
    frames = len(env)
    spf = int(sr / fps)
    t_frame = (np.arange(frames) + 0.5) * spf
    t_sample = np.arange(frames * spf, dtype=np.float32)
    env_s = np.interp(t_sample, t_frame, env)
    centroid = 400.0 + 3000.0 * env_s
    carrier = np.zeros_like(t_sample)
    for h in range(1, 31):
        fh = f0 * h
        if fh > 7000:
            break
        weight = np.exp(-((fh - centroid) / 800.0) ** 2)
        carrier += weight * np.sin(2 * np.pi * fh * t_sample / sr)
    carrier = carrier / (np.abs(carrier).max() + 1e-6)
    return ((0.3 + 0.6 * env_s) * carrier).astype(np.float32)


def _render_face_clip(env: np.ndarray, img: int, rng) -> np.ndarray:
    """Envelope → (frames, img, img, 3) uint8 drawn face whose mouth ellipse
    opens with env[t]; static eyes and face, ±6 levels of noise."""
    frames = len(env)
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32)
    skin = int(rng.integers(150, 200))
    base = np.full((img, img, 3), int(rng.integers(60, 100)), np.uint8)
    face = ((xx - img / 2) ** 2 / (img * 0.42) ** 2
            + (yy - img / 2) ** 2 / (img * 0.48) ** 2) <= 1.0
    base[face] = (skin, max(0, skin - 30), max(0, skin - 45))
    for ex in (img * 3 // 8, img * 5 // 8):       # static eyes
        eye = ((xx - ex) ** 2 + (yy - img * 3 // 8) ** 2) <= (img * 0.04) ** 2
        base[eye] = 25
    cy, cx = img * 0.72, img * 0.5
    mouth_w = img * 0.24
    f = np.repeat(base[None], frames, axis=0)
    for t in range(frames):
        ap = 1.5 + env[t] * img * 0.13            # half-height of the opening
        mouth = ((xx - cx) ** 2 / mouth_w ** 2 + (yy - cy) ** 2 / ap ** 2) <= 1.0
        f[t][mouth] = 15
    return np.clip(f.astype(np.int16) + rng.integers(-6, 7, f.shape), 0, 255).astype(np.uint8)


#: synthetic_word_av_clips: word i's aperture oscillates at WORD_RATE_HZ[i]
#: with peak opening WORD_PEAK[i].
WORD_CODED_WORDS = ["hello", "world", "about", "place", "think", "right"]
WORD_RATE_HZ = [0.5, 2.0, 3.5, 5.0, 6.5, 8.0]
WORD_PEAK = [1.0, 0.52, 0.88, 0.4, 0.76, 0.64]


def synthetic_word_av_clips(n_clips: int = 24, frames: int = 40, img: int = 96, seed: int = 0,
                            sr: int = 16000, fps: float = 25.0, n_words: int = 4
                            ) -> List[GanClip]:
    """Single-word clips whose word is coded in the mouth's motion: clip i
    says word i % ``n_words``, its aperture oscillating at that word's rate
    and peak (random phase), the wave following the same envelope
    (``_formant_wave``): a video → transcript correspondence for the lip
    expert to learn."""
    if not 1 <= n_words <= len(WORD_CODED_WORDS):
        raise ValueError(f"n_words must be in [1, {len(WORD_CODED_WORDS)}]")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_clips):
        w = i % n_words
        t = np.arange(frames) / fps
        phase = rng.uniform(0, 2 * np.pi)
        env = 0.08 + 0.92 * WORD_PEAK[w] * (0.5 + 0.5 * np.sin(
            2 * np.pi * WORD_RATE_HZ[w] * t + phase))
        wav = _formant_wave(env, sr=sr, fps=fps, f0=110.0 + 13.0 * (i % 7))
        out.append(GanClip(_render_face_clip(env, img, rng), wav, text=WORD_CODED_WORDS[w]))
    return out


def mouth_aperture_proxy(frames01: np.ndarray, img: Optional[int] = None) -> np.ndarray:
    """Per-frame mouth opening of a drawn face (``_render_face_clip``): the
    darkness (1 − mean) of the mouth box, rows 0.58-0.86 and columns
    0.28-0.72 of the frame; frames01 (..., H, W, 3) in [0, 1] → (...)."""
    h, w = frames01.shape[-3], frames01.shape[-2]
    region = frames01[..., int(h * 0.58):int(h * 0.86), int(w * 0.28):int(w * 0.72), :]
    return 1.0 - region.mean(axis=(-1, -2, -3))


def synthetic_word_clips(
    n: int = 64, t: int = 5, hw: int = 32, num_classes: int = 8, seed: int = 0
):
    """Clips whose mean brightness encodes the label — linearly separable,
    so training-convergence smoke tests can assert learning."""
    rng = np.random.default_rng(seed)
    clips, labels = [], []
    for i in range(n):
        label = int(rng.integers(num_classes))
        base = 255.0 * (label + 0.5) / num_classes
        clip = np.clip(
            rng.normal(base, 20.0, (t, hw, hw)), 0, 255
        ).astype(np.uint8)
        clips.append(clip)
        labels.append(label)
    return clips, labels
