"""Gradio finetuning UI: dataset preparation, vocab tools, checkpoint
utilities, training (counterpart of `f5e_tts_tpu/train/finetune_gradio.py`).

reference: src/f5_tts/train/finetune_gradio.py (1.9k lines). The pieces that
do the work are plain functions, usable headless; `build_app` wraps them in
gradio Blocks and raises ImportError naming gradio when it is absent. The
transcription tab needs local Whisper weights (`infer/transcribe.py`), the
training tab launches `python -m f5e_tts_tpu_torch.train.train` on the card
unless told "cpu", and the system tab lists the CUDA devices.
"""

from __future__ import annotations

from typing import List

import numpy as np


# ---------------------------------------------------------------------------
# audio slicer (reference: finetune_gradio.py:219-335, Slicer class semantics)
# ---------------------------------------------------------------------------


def slice_audio(
    wav: np.ndarray,
    sr: int,
    threshold_db: float = -40.0,
    min_length_ms: float = 5000,
    min_interval_ms: float = 300,
    hop_ms: float = 10,
    max_sil_kept_ms: float = 500,
) -> List[np.ndarray]:
    """RMS-threshold silence slicing into utterances."""
    hop = max(int(sr * hop_ms / 1000), 1)
    win = hop * 2
    n_frames = max((len(wav) - win) // hop + 1, 0)
    if n_frames <= 0:
        return [wav]
    rms = np.asarray([
        np.sqrt(np.mean(wav[i * hop : i * hop + win] ** 2) + 1e-12)
        for i in range(n_frames)
    ])
    db = 20 * np.log10(rms + 1e-12)
    silent = db < threshold_db

    min_len = int(min_length_ms / hop_ms)
    min_int = int(min_interval_ms / hop_ms)
    max_kept = int(max_sil_kept_ms / hop_ms)

    # find silence runs long enough to cut at
    cuts = []
    i = 0
    while i < n_frames:
        if silent[i]:
            j = i
            while j < n_frames and silent[j]:
                j += 1
            if j - i >= min_int:
                cuts.append((i, j))
            i = j
        else:
            i += 1

    segments = []
    prev = 0
    for (a, b) in cuts:
        cut_at = (a + b) // 2
        if cut_at - prev >= min_len:
            start = max(prev - 0, 0)
            end = min(cut_at + max_kept, n_frames)
            segments.append(wav[start * hop : end * hop])
            prev = cut_at
    if n_frames - prev >= 1:
        segments.append(wav[prev * hop :])
    return [s for s in segments if len(s) > 0] or [wav]


# ---------------------------------------------------------------------------
# vocab tools (reference: finetune_gradio.py:899-1034)
# ---------------------------------------------------------------------------


def vocab_check(texts: List[str], vocab: dict, tokenizer: str = "char") -> List[str]:
    """Return the characters/tokens missing from the vocab."""
    from f5e_tts_tpu_torch.utils.text import convert_char_to_pinyin

    missing = set()
    for t in texts:
        toks = convert_char_to_pinyin([t])[0] if tokenizer == "pinyin" else list(t)
        for tok in toks:
            if tok not in vocab:
                missing.add(tok)
    return sorted(missing)


def vocab_extend(vocab_path: str, new_tokens: List[str], out_path: str) -> int:
    """Append new tokens to vocab.txt; returns new size
    (finetune_gradio.py:995-1010)."""
    from f5e_tts_tpu_torch.utils.text import load_vocab_file

    vocab = load_vocab_file(vocab_path)
    tokens = [t for t in new_tokens if t not in vocab]
    with open(vocab_path, "r", encoding="utf-8") as f:
        lines = [line.rstrip("\n") for line in f]
    lines += tokens
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


def expand_embeddings_for_vocab(ckpt_path: str, out_path: str, new_vocab_size: int,
                                arch=None) -> int:
    """Grow the text embedding table of a checkpoint to a larger vocab
    (new rows drawn from np.random.default_rng(0) at the table's std),
    reference: finetune_gradio.py:1012-1034."""
    from f5e_tts_tpu_torch.utils.convert import load_state_dict

    sd = load_state_dict(ckpt_path, use_ema=True)
    key = "transformer.text_embed.text_embed.weight"
    old = sd[key]
    if old.shape[0] >= new_vocab_size + 1:
        added = 0
    else:
        added = new_vocab_size + 1 - old.shape[0]
        rng = np.random.default_rng(0)
        extra = rng.normal(0, old.std(), (added, old.shape[1])).astype(old.dtype)
        sd[key] = np.concatenate([old, extra], axis=0)
    from safetensors.numpy import save_file

    save_file({f"ema_model.{k}": np.ascontiguousarray(v) for k, v in sd.items()}, out_path)
    return added


def prune_checkpoint(ckpt_path: str, out_path: str) -> None:
    """Strip optimizer/EMA bookkeeping, keep inference weights only
    (reference: finetune_gradio.py:970-993)."""
    from safetensors.numpy import save_file

    from f5e_tts_tpu_torch.utils.convert import load_state_dict

    sd = load_state_dict(ckpt_path, use_ema=True)
    save_file({f"ema_model.{k}": np.ascontiguousarray(v) for k, v in sd.items()}, out_path)


# ---------------------------------------------------------------------------
# gradio wrapper (gated)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# project settings (reference: finetune_gradio.py:61-173)
# ---------------------------------------------------------------------------

DEFAULT_SETTINGS = {
    "exp_name": "F5TTS_v1_Base",
    "learning_rate": 1e-5,
    "batch_size_per_gpu": 3200,
    "batch_size_type": "frame",
    "max_samples": 64,
    "grad_accumulation_steps": 1,
    "max_grad_norm": 1.0,
    "epochs": 100,
    "num_warmup_updates": 100,
    "save_per_updates": 500,
    "keep_last_n_checkpoints": -1,
    "last_per_updates": 100,
    "finetune": True,
    "file_checkpoint_train": "",
    "tokenizer_type": "pinyin",
    "tokenizer_file": "",
    "mixed_precision": "bf16",
    "logger": "none",
    "bnb_optimizer": False,
}


def save_settings(project_dir: str, settings: dict) -> str:
    """Persist per-project training settings (finetune_gradio.py:61-111)."""
    import json
    import os

    os.makedirs(project_dir, exist_ok=True)
    merged = dict(DEFAULT_SETTINGS)
    merged.update(settings)
    with open(os.path.join(project_dir, "setting.json"), "w") as f:
        json.dump(merged, f, indent=4)
    return "Settings saved!"


def load_settings(project_dir: str) -> dict:
    """Settings with defaults filled (finetune_gradio.py:114-173)."""
    import json
    import os

    path = os.path.join(project_dir, "setting.json")
    settings = dict(DEFAULT_SETTINGS)
    if os.path.isfile(path):
        with open(path, "r") as f:
            settings.update(json.load(f))
    return settings


# ---------------------------------------------------------------------------
# dataset transcription (reference: finetune_gradio.py:658-726 transcribe_all)
# ---------------------------------------------------------------------------

def transcribe_all(project_dir: str, audio_files: List[str],
                   language: str = "english", transcriber=None,
                   progress=lambda it, **kw: it, device="cuda") -> dict:
    """Transcribe a list of wavs into {project}/wavs + metadata.csv
    (audio|text rows, the prepare-csv layout). `transcriber` defaults to the
    shared lazy Whisper pipeline on `device` (infer/transcribe.py, gated on
    local weights); inject a callable(path) -> str for tests."""
    import os
    import shutil

    if transcriber is None:
        from f5e_tts_tpu_torch.infer.transcribe import transcribe as _t

        def transcriber(path):  # noqa: F811
            return _t(path, language=language, device=device)

    wav_dir = os.path.join(project_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rows, errors = [], []
    for src in progress(audio_files, desc="transcribe files"):
        name = os.path.basename(src)
        dst = os.path.join(wav_dir, name)
        try:
            text = transcriber(src)
            if src != dst:
                shutil.copyfile(src, dst)
            rows.append(f"{name}|{text}")
        except Exception as e:  # noqa: BLE001 (reference collects errors too)
            errors.append(f"{name}: {e}")
    with open(os.path.join(project_dir, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("audio_file|text\n")
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return {"transcribed": len(rows), "errors": errors,
            "metadata": os.path.join(project_dir, "metadata.csv")}


def create_metadata(project_dir: str, out_dir: str, tokenizer: str = "pinyin") -> dict:
    """metadata.csv + wavs -> raw.arrow + duration.json + vocab.txt
    (finetune_gradio.py:767-874; reuses the csv corpus adapter)."""
    from f5e_tts_tpu_torch.data.prepare import prepare, rows_from_csv

    return prepare(rows_from_csv(project_dir), out_dir, tokenizer)


# ---------------------------------------------------------------------------
# training process management (reference: finetune_gradio.py:337-632)
# ---------------------------------------------------------------------------

class TrainingManager:
    """Spawn/stream/stop the training CLI as a subprocess.

    reference: finetune_gradio.py:365-632 — start_training builds the command,
    Popen-s it with streamed stdout, stop_training terminates the tree. Here
    the child (the port's training CLI on `device`) gets its own process
    group so stop() cannot hit unrelated processes."""

    def __init__(self):
        self.process = None
        self.lines: List[str] = []

    def start(self, config_path: str, *, data_dir: str = "data",
              dataset_name: str = None, pretrained: str = None,
              max_updates: int = None, extra_args: List[str] = (),
              python=None, device: str = "cuda") -> int:
        import os
        import subprocess
        import sys
        import threading

        if self.is_running():
            raise RuntimeError("train run already in progress "
                               "(finetune_gradio.py:413-417)")
        cmd = [python or sys.executable, "-m", "f5e_tts_tpu_torch.train.train",
               "--config", config_path, "--data_dir", data_dir, "--device", device]
        if dataset_name:
            cmd += ["--dataset_name", dataset_name]
        if pretrained:
            cmd += ["--pretrained", pretrained]
        if max_updates is not None:
            cmd += ["--max_updates", str(max_updates)]
        cmd += list(extra_args)
        self.lines = []
        self.process = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True, env=dict(os.environ))

        def pump():
            for line in self.process.stdout:
                self.lines.append(line.rstrip("\n"))

        self._pump = threading.Thread(target=pump, daemon=True)
        self._pump.start()
        return self.process.pid

    def is_running(self) -> bool:
        return self.process is not None and self.process.poll() is None

    def status(self) -> dict:
        if self.process is None:
            return {"state": "idle", "tail": []}
        code = self.process.poll()
        return {"state": "running" if code is None else f"exited({code})",
                "pid": self.process.pid, "tail": self.lines[-20:]}

    def stop(self, timeout: float = 10.0) -> str:
        """Terminate the training process group (finetune_gradio.py:623-631)."""
        import os
        import signal

        if self.process is None or self.process.poll() is not None:
            return "train not running !"
        os.killpg(os.getpgid(self.process.pid), signal.SIGTERM)
        try:
            self.process.wait(timeout=timeout)
        except Exception:  # noqa: BLE001
            os.killpg(os.getpgid(self.process.pid), signal.SIGKILL)
            self.process.wait()
        return "train stopped !"

    def wait(self, timeout=None) -> int:
        return self.process.wait(timeout=timeout)


def calculate_train(dataset_dir: str, *, batch_size_type: str = "frame",
                    max_samples: int = 64, num_warmup_updates: int = 100,
                    finetune: bool = True, hbm_gb_per_chip: float = 16.0,
                    n_chips: int = None) -> dict:
    """Suggest hyperparameters from the dataset (finetune_gradio.py:881-968)
    with the JAX package's arguments: `hbm_gb_per_chip` is each device's
    memory in GB, `n_chips` the device count (torch.cuda.device_count() when
    None, at least 1)."""
    import json
    import os

    fd = os.path.join(dataset_dir, "duration.json")
    if not os.path.isfile(fd):
        return {"error": "project not found !"}
    with open(fd, "r") as f:
        durations = json.load(f)["duration"]
    hop, sr = 256, 24000
    max_len = max(durations) * sr / hop
    total_samples = len(durations)
    total_duration = sum(durations)
    if n_chips is None:
        import torch

        n_chips = max(torch.cuda.device_count(), 1)

    if batch_size_type == "frame":
        # reference scales 38400 frames per 75 GB beyond a 5 GB floor
        batch = max(int(38400 * (hbm_gb_per_chip - 5) / 75), int(max_len))
        updates_per_epoch = total_duration / (batch * n_chips * hop / sr)
    else:
        batch = int(200 / (total_duration / total_samples))
        updates_per_epoch = total_samples / batch / n_chips
    if total_samples < 64:
        max_samples = int(total_samples * 0.25)
    num_warmup_updates = max(num_warmup_updates, int(total_samples * 0.05))
    epochs = int(1_200_000 / max(updates_per_epoch, 1e-9))
    return {
        "epochs": epochs,
        "learning_rate": 1e-5 if finetune else 7.5e-5,
        "batch_size_per_gpu": batch,
        "max_samples": max_samples,
        "num_warmup_updates": num_warmup_updates,
        "total_samples": total_samples,
    }


def system_stats() -> dict:
    """Device stats for the UI (the reference shows the GPU's name and
    memory): one row per CUDA device with the JAX package's keys, `kind`
    (its name), `id`, `platform` ("gpu"), `bytes_in_use` (allocated by
    torch) and `bytes_limit` (its total memory); no rows without a card."""
    import torch

    devices = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append({"kind": props.name, "id": i, "platform": "gpu",
                            "bytes_in_use": torch.cuda.memory_allocated(i),
                            "bytes_limit": props.total_memory})
    return {"devices": devices}


def build_app():
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed; pip install gradio for the UI") from e

    with gr.Blocks(title="F5E-TTS finetune (PyTorch)") as app:
        gr.Markdown("# Finetune (PyTorch/CUDA)")
        with gr.Tab("Prepare data"):
            inp = gr.Textbox(label="Corpus dir (metadata.csv + wavs)")
            out = gr.Textbox(label="Output dataset dir")
            tok = gr.Dropdown(["char", "pinyin", "byte"], value="pinyin", label="Tokenizer")
            log = gr.JSON(label="Stats")

            def _prep(inp, out, tok):
                from f5e_tts_tpu_torch.data.prepare import prepare, rows_from_csv

                return prepare(rows_from_csv(inp), out, tok)

            gr.Button("Prepare").click(_prep, [inp, out, tok], log)
        with gr.Tab("Vocab check"):
            vpath = gr.Textbox(label="vocab.txt path")
            texts = gr.Textbox(label="Texts (one per line)", lines=6)
            missing = gr.JSON(label="Missing tokens")

            def _check(vpath, texts):
                from f5e_tts_tpu_torch.utils.text import load_vocab_file

                return vocab_check(texts.splitlines(), load_vocab_file(vpath))

            gr.Button("Check").click(_check, [vpath, texts], missing)
        with gr.Tab("Prune checkpoint"):
            cin = gr.Textbox(label="Training ckpt (.pt/.safetensors)")
            cout = gr.Textbox(label="Output .safetensors")
            done = gr.Textbox(label="Status")
            gr.Button("Prune").click(
                lambda a, b: (prune_checkpoint(a, b) or f"wrote {b}"), [cin, cout], done)
        with gr.Tab("Transcribe dataset"):
            proj = gr.Textbox(label="Project dir")
            files = gr.Textbox(label="Audio files (one path per line)", lines=6)
            lang = gr.Dropdown(["english", "chinese"], value="english", label="Language")
            tstat = gr.JSON(label="Result")
            gr.Button("Transcribe").click(
                lambda p, fl, lg: transcribe_all(p, fl.splitlines(), lg),
                [proj, files, lang], tstat)
        with gr.Tab("Train"):
            mgr = TrainingManager()
            cfgp = gr.Textbox(label="Training yaml")
            ddir = gr.Textbox(label="Data dir", value="data")
            dname = gr.Textbox(label="Dataset name")
            pstat = gr.JSON(label="Status")
            gr.Button("Start").click(
                lambda c, d, n: (mgr.start(c, data_dir=d, dataset_name=n or None)
                                 and mgr.status()), [cfgp, ddir, dname], pstat)
            gr.Button("Status").click(lambda: mgr.status(), [], pstat)
            gr.Button("Stop").click(lambda: {"msg": mgr.stop()}, [], pstat)
        with gr.Tab("Suggest hyperparameters"):
            dsd = gr.Textbox(label="Dataset dir (with duration.json)")
            sug = gr.JSON(label="Suggestion")
            gr.Button("Calculate").click(lambda d: calculate_train(d), [dsd], sug)
        with gr.Tab("System"):
            sysj = gr.JSON(label="Devices")
            gr.Button("Refresh").click(lambda: system_stats(), [], sysj)
    return app


if __name__ == "__main__":
    build_app().launch()
