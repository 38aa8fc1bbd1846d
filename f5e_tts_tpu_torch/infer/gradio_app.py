"""Gradio web UI for inference (counterpart of `f5e_tts_tpu/infer/gradio_app.py`).

reference: src/f5_tts/infer/infer_gradio.py:131-1090: the basic TTS tab with
advanced settings (seed randomize, txt-file upload, spectrogram output),
multi-speech-type generation with JSON style markers and dynamic rows, the
model switcher (default / E2-TTS / Custom with last-used persistence,
reference :940-1005) and the voice-chat tab (reference :742-885;
orchestration in infer/voice_chat.py, the LLM's weights gated on a local HF
directory).

Every behaviour that needs no browser is a headless function at module level
(parse_speechtypes_text, load_text_from_file, validate_speech_types,
ModelChoice, generate_multistyle_core); `build_app` wraps them in gradio
Blocks over the port's `F5TTS` on `device` (the card unless "cpu") and raises
ImportError naming gradio when that package is absent.
"""

from __future__ import annotations

import json
import os
import re
from collections import OrderedDict
from typing import Callable, Optional

from f5e_tts_tpu_torch.infer.voice_chat import DEFAULT_SYSTEM_PROMPT as _DEFAULT_SYSTEM_PROMPT

MAX_SPEECH_TYPES = 16

# (ckpt path, vocab path, model-cfg json) — the reference persists the last
# used Custom triple across sessions (infer_gradio.py:946-976)
DEFAULT_CUSTOM_CFG = [
    "",
    "",
    json.dumps(dict(dim=1024, depth=22, heads=16, ff_mult=2,
                    text_dim=512, conv_layers=4)),
]


def parse_speechtypes_text(gen_text: str):
    """Split a script into styled segments.

    Markers are either `{Style}` or a JSON dict
    `{"name": str, "seed": int, "speed": float}`; a marker is sticky until the
    next one, and defaults are name=Regular, seed=-1 (randomize), speed=1.0
    (reference: infer_gradio.py:334-366).
    """
    tokens = re.split(r"(\{.*?\})", gen_text)
    segments = []
    current = {"name": "Regular", "seed": -1, "speed": 1.0}
    for i, tok in enumerate(tokens):
        if i % 2 == 0:
            text = tok.strip()
            if text:
                segments.append({**current, "text": text})
        else:
            type_str = tok.strip()
            try:
                d = json.loads(type_str)
                current = {"name": d.get("name", "Regular"),
                           "seed": int(d.get("seed", -1)),
                           "speed": float(d.get("speed", 1.0))}
            except json.JSONDecodeError:
                current = {"name": type_str[1:-1], "seed": -1, "speed": 1.0}
    return segments


def load_text_from_file(path: Optional[str]) -> str:
    """Read an uploaded .txt into the textbox (reference: infer_gradio.py:120-128)."""
    if not path:
        return ""
    with open(path, "r", encoding="utf-8") as f:
        return f.read().strip()


def validate_speech_types(gen_text: str, *names) -> bool:
    """True iff every style referenced in the script has a defined row
    (reference: infer_gradio.py:692-720)."""
    available = {n for n in names if n}
    segments = parse_speechtypes_text(gen_text)
    return all(seg["name"] in available for seg in segments)


class ModelChoice:
    """Model-switcher state with last-used-Custom persistence.

    reference: infer_gradio.py:946-976 (load_last_used_custom /
    switch_tts_model / set_custom_model). `choice` is either a builtin model
    name or ("Custom", ckpt, vocab, cfg_json).
    """

    def __init__(self, default_model: str = "F5TTS_v1_Base",
                 cache_path: Optional[str] = None):
        self.default_model = default_model
        self.choice = default_model
        self.cache_path = cache_path or os.path.join(
            os.path.expanduser("~"), ".cache", "f5e_tts_tpu_torch",
            "last_used_custom_model_info_v1.txt")

    def load_last_used_custom(self):
        try:
            with open(self.cache_path, "r", encoding="utf-8") as f:
                lines = [ln.strip() for ln in f]
            return (lines + DEFAULT_CUSTOM_CFG)[:3]
        except FileNotFoundError:
            os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
            return list(DEFAULT_CUSTOM_CFG)

    def switch(self, new_choice: str):
        """Returns the custom triple when switching to Custom, else None."""
        if new_choice == "Custom":
            ckpt, vocab, cfg = self.load_last_used_custom()
            self.choice = ("Custom", ckpt, vocab, cfg)
            return ckpt, vocab, cfg
        self.choice = new_choice
        return None

    def set_custom(self, ckpt: str, vocab: str, cfg_json: str) -> None:
        self.choice = ("Custom", ckpt, vocab, cfg_json)
        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
        with open(self.cache_path, "w", encoding="utf-8") as f:
            f.write(ckpt + "\n" + vocab + "\n" + cfg_json + "\n")


def _as_mono_float(wav):
    import numpy as np

    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if np.abs(wav).max() > 2:
        wav = wav / 32768.0
    return wav


def generate_multistyle_core(infer_fn: Callable, gen_text: str, voices: dict,
                             remove_silence: bool = False, seed_fn=None):
    """Headless multi-style generation (reference: infer_gradio.py:596-690).

    infer_fn(audio, ref_text, text, seed, speed, remove_silence)
      -> (wav, sr, ref_text_out)
    voices: name -> {"audio": ..., "ref_text": str}. Unknown styles fall back
    to Regular; seed=-1 draws from seed_fn. Returns (wav, sr, updated voices,
    metadata string of one JSON line per segment).
    """
    import numpy as np

    if seed_fn is None:
        seed_fn = lambda: int(np.random.randint(0, 2**31 - 1))
    segments = parse_speechtypes_text(gen_text)
    outs, meta, sr = [], "", None
    current = "Regular"
    for seg in segments:
        current = seg["name"] if seg["name"] in voices else "Regular"
        if current not in voices:
            raise ValueError(f"no reference defined for style {seg['name']!r} "
                             "and no Regular fallback")
        seed = seg["seed"] if seg["seed"] != -1 else seed_fn()
        v = voices[current]
        wav, sr, ref_text_out = infer_fn(v["audio"], v.get("ref_text", ""),
                                         seg["text"], seed, seg["speed"],
                                         remove_silence)
        v["ref_text"] = ref_text_out
        outs.append(wav)
        meta += json.dumps(dict(name=seg["name"], seed=seed,
                                speed=seg["speed"])) + f" {seg['text']}\n"
    final = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    return final, sr, voices, meta


def _require_gradio():
    try:
        import gradio as gr  # noqa: F401

        return gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; "
            "`pip install gradio` to use the web UI") from e


def build_app(tts=None, default_model: str = "F5TTS_v1_Base", device="cuda"):
    """Construct the gradio Blocks app around an F5TTS instance; the models it
    loads itself run on `device`."""
    gr = _require_gradio()
    import numpy as np

    from f5e_tts_tpu_torch.api import F5TTS

    state = {"tts": tts, "loaded_choice": None}
    models = ModelChoice(default_model)

    def ensure_model():
        """(Re)load the F5TTS engine to match the current model choice."""
        if state["tts"] is not None and state["loaded_choice"] == models.choice:
            return state["tts"]
        if isinstance(models.choice, tuple):
            _, ckpt, vocab, cfg_json = models.choice
            state["tts"] = F5TTS(model=default_model, ckpt_file=ckpt,
                                 vocab_file=vocab,
                                 model_cfg=json.loads(cfg_json) if cfg_json else None,
                                 device=device)
        else:
            name = "E2TTS_Base" if models.choice == "E2-TTS" else models.choice
            state["tts"] = F5TTS(model=name, device=device)
        state["loaded_choice"] = models.choice
        return state["tts"]

    def basic_tts(ref_audio, ref_text, gen_text, remove_silence, randomize_seed,
                  seed, cross_fade, nfe, speed):
        t = ensure_model()
        if randomize_seed:
            seed = int(np.random.randint(0, 2**31 - 1))
        sr_in, wav_in = ref_audio  # gradio numpy audio
        wav_in = _as_mono_float(wav_in)
        # ref preprocessing incl. auto-transcription when ref_text is blank
        # (reference infer_gradio.py routes through preprocess_ref_audio_text)
        from f5e_tts_tpu_torch.infer.pipeline import preprocess_ref_audio_text
        from f5e_tts_tpu_torch.infer.transcribe import make_cached_transcriber

        wav_in, ref_text = preprocess_ref_audio_text(
            wav_in, sr_in, ref_text or "",
            transcribe=make_cached_transcriber(getattr(t, "asr_model", None), device=t.device))
        out, sr, spec = t.engine.infer(
            wav_in, sr_in, ref_text, gen_text,
            seed=int(seed) if seed else 0,
            nfe_steps=int(nfe), speed=speed, cross_fade_duration=cross_fade)
        if remove_silence:
            from f5e_tts_tpu_torch.infer.audio import remove_silence_edges

            out = remove_silence_edges(out, sr)
        spec_path = None
        try:
            import tempfile

            spec_path = os.path.join(tempfile.mkdtemp(), "spec.png")
            t.export_spectrogram(np.asarray(spec), spec_path)
        except Exception:
            spec_path = None
        return (sr, out), spec_path, ref_text, seed

    def multistyle_tts(gen_text, remove_silence, *style_rows):
        """style_rows: flattened (name, (sr, wav), ref_text) triples."""
        t = ensure_model()
        voices = OrderedDict()
        for i in range(0, len(style_rows), 3):
            name, audio, rtext = style_rows[i : i + 3]
            if name and audio is not None:
                voices[name] = {"audio": audio, "ref_text": rtext or ""}

        def one(audio, rtext, text, seed, speed, rm):
            (sr_in, wav_in) = audio
            wav_in = _as_mono_float(wav_in)
            out, sr, _ = t.engine.infer(wav_in, sr_in, rtext, text, seed=seed,
                                        speed=speed, cross_fade_duration=0.0)
            if rm:
                from f5e_tts_tpu_torch.infer.audio import remove_silence_edges

                out = remove_silence_edges(out, sr)
            return out, sr, rtext

        final, sr, _, meta = generate_multistyle_core(one, gen_text, voices,
                                                      remove_silence)
        if sr is None:
            sr = t.target_sample_rate
        return (sr, final), meta

    with gr.Blocks(title="F5E-TTS (PyTorch)") as app:
        gr.Markdown("# F5E-TTS (PyTorch/CUDA)")

        # model switcher (reference: infer_gradio.py:978-1056)
        with gr.Row():
            choose_model = gr.Radio(choices=[default_model, "E2-TTS", "Custom"],
                                    label="Choose TTS Model", value=default_model)
            last = models.load_last_used_custom()
            custom_ckpt = gr.Dropdown(choices=[last[0]], value=last[0],
                                      allow_custom_value=True, visible=False,
                                      label="Model ckpt path")
            custom_vocab = gr.Dropdown(choices=[last[1]], value=last[1],
                                       allow_custom_value=True, visible=False,
                                       label="Vocab file path")
            custom_cfg = gr.Dropdown(choices=[DEFAULT_CUSTOM_CFG[2], last[2]],
                                     value=last[2], allow_custom_value=True,
                                     visible=False, label="Model cfg (json)")

        def on_switch(choice):
            custom = models.switch(choice)
            vis = custom is not None
            vals = custom or ("", "", DEFAULT_CUSTOM_CFG[2])
            return (gr.update(visible=vis, value=vals[0]),
                    gr.update(visible=vis, value=vals[1]),
                    gr.update(visible=vis, value=vals[2]))

        choose_model.change(on_switch, choose_model,
                            [custom_ckpt, custom_vocab, custom_cfg])
        for comp in (custom_ckpt, custom_vocab, custom_cfg):
            comp.change(lambda c, v, j: models.set_custom(c, v, j),
                        [custom_ckpt, custom_vocab, custom_cfg], None)

        with gr.Tab("Basic TTS"):
            ref_audio = gr.Audio(label="Reference audio", type="numpy")
            gen_text = gr.Textbox(label="Text to generate", lines=4)
            gen_file = gr.File(label="Load text from .txt", file_types=[".txt"])
            with gr.Accordion("Advanced Settings", open=False):
                ref_text = gr.Textbox(label="Reference text (blank = auto-transcribe)")
                ref_file = gr.File(label="Load reference text from .txt",
                                   file_types=[".txt"])
                with gr.Row():
                    remove_sil = gr.Checkbox(label="Remove silences", value=False)
                    randomize_seed = gr.Checkbox(label="Randomize seed", value=True)
                    seed = gr.Number(label="Seed", value=0, precision=0)
                with gr.Row():
                    cross_fade = gr.Slider(0.0, 1.0, 0.15, label="Cross-fade (s)")
                    nfe = gr.Slider(4, 64, 32, step=2, label="NFE steps")
                    speed = gr.Slider(0.3, 2.0, 1.0, label="Speed")
            out_audio = gr.Audio(label="Output")
            out_spec = gr.Image(label="Spectrogram")
            gen_file.upload(load_text_from_file, gen_file, gen_text)
            ref_file.upload(load_text_from_file, ref_file, ref_text)
            gr.Button("Synthesize", variant="primary").click(
                basic_tts,
                [ref_audio, ref_text, gen_text, remove_sil, randomize_seed,
                 seed, cross_fade, nfe, speed],
                [out_audio, out_spec, ref_text, seed])

        with gr.Tab("Multi-Speech-Type"):
            gr.Markdown(
                "Mark styles inline as `{Style}` or "
                '`{"name": "Style", "seed": -1, "speed": 1.0}`; define each '
                "style below. Unknown styles fall back to Regular.")
            ms_text = gr.Textbox(label="Script", lines=6)
            ms_file = gr.File(label="Load script from .txt", file_types=[".txt"])
            ms_file.upload(load_text_from_file, ms_file, ms_text)
            rows, row_groups = [], []
            for i in range(MAX_SPEECH_TYPES):
                with gr.Row(visible=(i < 4)) as rg:
                    rows += [gr.Textbox(label=f"Style {i} name",
                                        value="Regular" if i == 0 else ""),
                             gr.Audio(label="Ref audio", type="numpy"),
                             gr.Textbox(label="Ref text")]
                row_groups.append(rg)
            n_visible = gr.State(4)

            def add_row(n):
                n = min(n + 1, MAX_SPEECH_TYPES)
                return [n] + [gr.update(visible=(i < n))
                              for i in range(MAX_SPEECH_TYPES)]

            def del_row(n):
                n = max(n - 1, 1)
                return [n] + [gr.update(visible=(i < n))
                              for i in range(MAX_SPEECH_TYPES)]

            with gr.Row():
                gr.Button("Add speech type").click(add_row, n_visible,
                                                   [n_visible] + row_groups)
                gr.Button("Remove speech type").click(del_row, n_visible,
                                                      [n_visible] + row_groups)
            ms_remove_sil = gr.Checkbox(label="Remove silences", value=False)
            ms_out = gr.Audio(label="Output")
            ms_meta = gr.Textbox(label="Inference metadata", lines=4)
            gr.Button("Generate Multi-Style", variant="primary").click(
                multistyle_tts, [ms_text, ms_remove_sil] + rows, [ms_out, ms_meta])

        with gr.Tab("Voice Chat"):
            # reference: infer_gradio.py:742-885 (Qwen voice-chat tab)
            gr.Markdown("Chat with an LLM that replies in the reference voice. "
                        "Load a local HF causal-LM directory first.")
            chat_state = {"vc": None}
            llm_path = gr.Textbox(label="Chat model path (local HF dir)")
            vc_ref_audio = gr.Audio(label="Reference voice", type="numpy")
            vc_ref_text = gr.Textbox(label="Reference text (blank = unknown)")
            system_prompt = gr.Textbox(label="System prompt",
                                       value=_DEFAULT_SYSTEM_PROMPT, lines=2)
            chatbox = gr.Chatbot(label="Conversation", type="messages")
            user_text = gr.Textbox(label="Your message", lines=1)
            user_audio = gr.Audio(label="...or speak", type="filepath",
                                  sources=["microphone", "upload"])
            vc_out = gr.Audio(label="Spoken reply", autoplay=True)

            def chat_round(path, ref, rtext, sys_p, text, audio_path):
                from f5e_tts_tpu_torch.infer.voice_chat import VoiceChat, load_chat_model

                t = ensure_model()
                if chat_state["vc"] is None or chat_state["vc"].system_prompt != sys_p:
                    sr_in, wav_in = ref
                    chat_state["vc"] = VoiceChat(
                        t.engine, _as_mono_float(wav_in), sr_in, rtext or "",
                        respond_fn=load_chat_model(path, device=t.device),
                        system_prompt=sys_p)
                reply, wav, sr = chat_state["vc"].chat(
                    text=text or None, audio_path=audio_path or None)
                return chat_state["vc"].messages, (sr, wav) if wav is not None else None

            gr.Button("Send").click(
                chat_round, [llm_path, vc_ref_audio, vc_ref_text, system_prompt,
                             user_text, user_audio], [chatbox, vc_out])

            def clear_chat():
                if chat_state["vc"] is not None:
                    chat_state["vc"].clear()
                return [], None

            gr.Button("Clear Conversation").click(clear_chat, None, [chatbox, vc_out])
    return app


def main():
    app = build_app()
    app.launch()


if __name__ == "__main__":
    main()
