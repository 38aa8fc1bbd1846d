"""Voice-chat pipeline: speech/text in -> LLM reply -> TTS out (counterpart
of `f5e_tts_tpu/infer/voice_chat.py`).

reference: src/f5_tts/infer/infer_gradio.py:742-885 (voice-chat tab: Qwen chat
model via transformers, conversation state of {role, content} messages, user
turns from mic audio transcribed by Whisper or typed text, assistant reply
synthesized with the reference voice). Here the orchestration is a headless
class over the port's `TTSEngine`; the chat model loader is gated on locally
available weights and runs the model on the card unless device="cpu".
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

DEFAULT_SYSTEM_PROMPT = (
    "You are not an AI assistant, you are whoever the user says you are. You "
    "must stay in character. Keep your responses concise since they will be "
    "spoken out loud."
)


class VoiceChat:
    """Conversation state + turn orchestration (infer_gradio.py:834-885).

    respond_fn: messages -> assistant text (plug load_chat_model here)
    transcribe_fn: wav_path -> text (plug a CachedTranscriber / whisper here);
    only needed when user turns arrive as audio.
    """

    def __init__(self, engine, ref_audio: np.ndarray, ref_sr: int, ref_text: str,
                 respond_fn: Callable[[List[dict]], str],
                 transcribe_fn: Optional[Callable[[str], str]] = None,
                 system_prompt: str = DEFAULT_SYSTEM_PROMPT,
                 nfe_steps: Optional[int] = None):
        self.engine = engine
        self.ref_audio = ref_audio
        self.ref_sr = ref_sr
        self.ref_text = ref_text
        self.respond_fn = respond_fn
        self.transcribe_fn = transcribe_fn
        self.system_prompt = system_prompt
        self.nfe_steps = nfe_steps
        self.messages: List[dict] = []

    def clear(self) -> None:
        self.messages = []

    def user_turn(self, text: Optional[str] = None,
                  audio_path: Optional[str] = None) -> Optional[str]:
        """Append the user message; audio is transcribed when no text given
        (infer_gradio.py:834-848). Returns the user text or None if empty."""
        if audio_path and not (text and text.strip()):
            if self.transcribe_fn is None:
                raise ValueError("audio input requires a transcribe_fn "
                                 "(e.g. infer.transcribe.CachedTranscriber)")
            text = self.transcribe_fn(audio_path)
        if not text or not text.strip():
            return None
        self.messages.append({"role": "user", "content": text.strip()})
        return text.strip()

    def assistant_turn(self) -> str:
        """LLM reply over system prompt + history (infer_gradio.py:850-858)."""
        convo = [{"role": "system", "content": self.system_prompt}] + self.messages
        reply = self.respond_fn(convo)
        self.messages.append({"role": "assistant", "content": reply})
        return reply

    def speak(self, seed: int = 0) -> Tuple[np.ndarray, int]:
        """Synthesize the last assistant reply (infer_gradio.py:860-885)."""
        if not self.messages or self.messages[-1]["role"] != "assistant":
            raise ValueError("no assistant reply to speak")
        wav, sr, _ = self.engine.infer(self.ref_audio, self.ref_sr, self.ref_text,
                                       self.messages[-1]["content"], seed=seed,
                                       nfe_steps=self.nfe_steps)
        return np.asarray(wav), sr

    def chat(self, text: Optional[str] = None, audio_path: Optional[str] = None,
             seed: int = 0):
        """One full round: user turn -> LLM -> TTS. Returns (reply, wav, sr)
        or (None, None, None) on empty input."""
        if self.user_turn(text=text, audio_path=audio_path) is None:
            return None, None, None
        reply = self.assistant_turn()
        wav, sr = self.speak(seed=seed)
        return reply, wav, sr


def load_chat_model(model_path: str, max_new_tokens: int = 256, temperature: float = 0.7,
                    device="cuda") -> Callable[[List[dict]], str]:
    """Gated transformers chat model on `device` -> respond_fn
    (infer_gradio.py:97-118 chat_model_inference + :742-757 load_chat_model)."""
    import os

    if not os.path.exists(model_path):
        raise FileNotFoundError(
            f"chat model weights not found at {model_path} (offline build: "
            "supply a local HF causal-LM directory, e.g. Qwen2.5-3B-Instruct)")
    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    from f5e_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = AutoModelForCausalLM.from_pretrained(model_path, torch_dtype="auto").to(dev)
    model.eval()
    tokenizer = AutoTokenizer.from_pretrained(model_path)

    def respond(messages: List[dict]) -> str:
        text = tokenizer.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
        inputs = tokenizer([text], return_tensors="pt").to(dev)
        with torch.no_grad():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens,
                                 do_sample=temperature > 0, temperature=temperature)
        gen = out[0][inputs["input_ids"].shape[1]:]
        return tokenizer.decode(gen, skip_special_tokens=True).strip()

    return respond
