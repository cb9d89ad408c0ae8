"""Gradio web UI of the port, with the reference's modes.

Counterpart of ``cosyvoice2_eu_tpu/serving/webui.py``, after the reference's
webui: the four inference modes (pretrained voice / 3s voice clone /
cross-lingual clone / natural language control), a cached-speaker dropdown
backed by the speaker store with a save-speaker button, per-mode steps,
input validation warnings, prompt postprocessing (silence trim, peak
normalisation, 0.2 s pad), a seed and streaming playback.  ``build_demo``
needs gradio, imported when it is called.

The mode logic and the postprocessing are plain functions, tested without
gradio.

    python -m cosyvoice2_eu_torch.serving.webui --model-dir DIR --device cuda
"""

from __future__ import annotations

import numpy as np

MODES = (
    "pretrained voice",          # sft: cached speaker, no prompt needed
    "3s voice clone",            # zero-shot: prompt wav + transcription
    "cross-lingual clone",       # prompt wav only, different language
    "natural language control",  # instruct2: cached speaker or prompt + instruction
)

INSTRUCTIONS = {
    MODES[0]: "1. pick a saved speaker\n2. click generate",
    MODES[1]: "1. upload or record a prompt (<= 30 s)\n"
              "2. enter its exact transcription\n3. click generate",
    MODES[2]: "1. upload or record a prompt (<= 30 s)\n"
              "2. enter text in a different language\n3. click generate",
    MODES[3]: "1. upload/record a prompt or pick a saved speaker\n"
              "2. enter an instruction (e.g. 'parle avec émotion')\n"
              "3. click generate",
}

MAX_VAL = 0.8


def postprocess_prompt(wav: np.ndarray, sr: int, top_db: float = 60.0,
                       frame: int = 440, hop: int = 220) -> np.ndarray:
    """Prompt conditioning hygiene (reference webui.py:46-57): trim leading/
    trailing silence (energy threshold `top_db` below peak), normalize the
    peak to MAX_VAL, and append 0.2 s of silence."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if len(wav) >= frame:
        n = (len(wav) - frame) // hop + 1
        starts = np.arange(n) * hop
        rms = np.sqrt(
            np.mean(
                np.stack([wav[s : s + frame] for s in starts]) ** 2, axis=1
            )
        )
        ref = float(rms.max())
        if ref > 0:
            keep = np.flatnonzero(rms > ref * 10 ** (-top_db / 20.0))
            if len(keep):
                wav = wav[starts[keep[0]] : min(starts[keep[-1]] + frame, len(wav))]
    peak = float(np.abs(wav).max()) if len(wav) else 0.0
    if peak > MAX_VAL:
        wav = wav * (MAX_VAL / peak)
    return np.concatenate([wav, np.zeros(int(sr * 0.2), np.float32)])


def validate_request(mode: str, prompt_available: bool, prompt_text: str,
                     instruct_text: str, spk_id: str) -> list[str]:
    """Reference-parity input checks (webui.py:72-110); returns a list of
    warning strings — a non-empty FIRST element starting with 'error:' blocks
    generation, the rest are informational."""
    warnings: list[str] = []
    if mode == MODES[0]:
        if not spk_id:
            warnings.append("error: no saved speakers available — save one "
                            "from a prompt first")
        if prompt_available or prompt_text or instruct_text:
            warnings.append("pretrained-voice mode ignores prompt audio / "
                            "prompt text / instruction")
    elif mode == MODES[1]:
        if not prompt_available:
            warnings.append("error: prompt audio is required for voice cloning")
        elif not prompt_text:
            warnings.append("error: the prompt transcription is required in "
                            "3s-clone mode")
        if instruct_text:
            warnings.append("3s-clone mode ignores the instruction text")
    elif mode == MODES[2]:
        if not prompt_available:
            warnings.append("error: prompt audio is required for cross-lingual "
                            "cloning")
        if instruct_text:
            warnings.append("cross-lingual mode ignores the instruction text")
        warnings.append("make sure the text is in a different language than "
                        "the prompt")
    else:  # natural language control
        if not instruct_text:
            warnings.append("error: an instruction is required in control mode")
        if not prompt_available and not spk_id:
            warnings.append("error: control mode needs a prompt recording or "
                            "a saved speaker")
    return warnings


def build_demo(model):
    from cosyvoice2_eu_torch.serving.engine import check_servable

    check_servable(model)
    import gradio as gr

    from cosyvoice2_eu_torch.frontend.frontend import resample

    sr = model.sample_rate

    def spk_choices():
        return sorted(model._frontend.spk_info)

    def to_wav16(prompt_wav):
        if prompt_wav is None:
            return None
        in_sr, data = prompt_wav
        wav = data.astype(np.float32) / 32768.0 if data.dtype == np.int16 else data
        if in_sr < 16000:
            raise gr.Error(f"prompt sample rate {in_sr} is below 16 kHz")
        wav = wav.mean(axis=1) if wav.ndim > 1 else wav
        return postprocess_prompt(resample(wav, in_sr, 16000), 16000)

    def generate(mode, tts_text, spk_id, prompt_wav, prompt_text, instruct_text,
                 seed, stream, speed):
        model._model.generator.manual_seed(int(seed))
        wav16 = to_wav16(prompt_wav)
        warnings = validate_request(
            mode, wav16 is not None, prompt_text, instruct_text, spk_id or ""
        )
        for w in warnings:
            if w.startswith("error:"):
                raise gr.Error(w[len("error:"):].strip())
            gr.Info(w)

        if mode == MODES[0]:
            art = model._frontend.get_spk(spk_id)
            gen = model.stream(tts_text, art, mode="zero_shot", speed=speed)
        elif mode == MODES[1]:
            gen = model.stream(tts_text, wav16, prompt_text=prompt_text,
                               mode="zero_shot", speed=speed)
        elif mode == MODES[2]:
            gen = model.stream(tts_text, wav16, mode="cross_lingual", speed=speed)
        else:
            prompt = wav16 if wav16 is not None else model._frontend.get_spk(spk_id)
            gen = model.stream(tts_text, prompt, mode="instruct2",
                               instruct_text=instruct_text, speed=speed)
        if stream:
            for chunk in gen:
                yield sr, (np.clip(chunk[0], -1, 1) * 32767).astype(np.int16)
        else:
            audio = np.concatenate([c[0] for c in gen])
            yield sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16)

    def save_speaker(prompt_wav, prompt_text, new_spk_id):
        if not new_spk_id:
            raise gr.Error("enter a speaker name to save")
        wav16 = to_wav16(prompt_wav)
        if wav16 is None:
            raise gr.Error("provide a prompt recording to save as a speaker")
        model.add_zero_shot_spk(prompt_text, wav16, new_spk_id)
        choices = spk_choices()
        return gr.update(choices=choices, value=new_spk_id), \
            f"saved speaker '{new_spk_id}'"

    def roll_seed():
        return int(np.random.randint(1, 100000000))

    with gr.Blocks(title="CosyVoice2-EU") as demo:
        gr.Markdown("## CosyVoice2-EU — zero-shot voice cloning (FR/DE)")
        tts_text = gr.Textbox(label="text to synthesize",
                              value="Bonjour tout le monde !")
        with gr.Row():
            mode = gr.Radio(list(MODES), value=MODES[2], label="inference mode")
            instruction = gr.Text(label="steps", value=INSTRUCTIONS[MODES[2]])
            spk_id = gr.Dropdown(choices=spk_choices(), label="saved speaker",
                                 value=(spk_choices() or [None])[0])
            stream = gr.Checkbox(value=True, label="streaming playback")
            speed = gr.Slider(0.5, 2.0, value=1.0,
                              label="speed (non-streaming only)")
            with gr.Column():
                seed_btn = gr.Button(value="\U0001F3B2")
                seed = gr.Number(value=0, label="random seed", precision=0)
        prompt_wav = gr.Audio(sources=["upload", "microphone"], type="numpy",
                              label="prompt audio (>= 16 kHz, <= 30 s)")
        prompt_text = gr.Textbox(label="prompt transcription (3s-clone mode)")
        instruct_text = gr.Textbox(label="instruction (control mode)")
        with gr.Row():
            new_spk_id = gr.Textbox(label="save prompt as speaker (name)")
            save_btn = gr.Button("save speaker")
            save_status = gr.Text(label="", interactive=False)
        audio_out = gr.Audio(label="synthesized audio", streaming=True,
                             autoplay=True)
        btn = gr.Button("generate")

        mode.change(lambda m: INSTRUCTIONS[m], inputs=[mode], outputs=[instruction])
        seed_btn.click(roll_seed, inputs=[], outputs=[seed])
        save_btn.click(save_speaker, inputs=[prompt_wav, prompt_text, new_spk_id],
                       outputs=[spk_id, save_status])
        btn.click(
            generate,
            inputs=[mode, tts_text, spk_id, prompt_wav, prompt_text,
                    instruct_text, seed, stream, speed],
            outputs=[audio_out],
        )
    return demo


def main():
    import argparse

    from cosyvoice2_eu_torch.serving.engine import follows, serving_api
    from cosyvoice2_eu_torch.serving.http_server import load_for_serving

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--tp", type=int, default=0,
                        help="split the LM over N processes (torchrun); process 0 serves")
    args = parser.parse_args()
    model = serving_api(load_for_serving(args))
    if follows(model):
        return
    demo = build_demo(model)
    demo.queue(max_size=4, default_concurrency_limit=2)
    demo.launch(server_name="0.0.0.0", server_port=args.port)


if __name__ == "__main__":
    main()
