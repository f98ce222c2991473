"""Gradio web demo (port of ``vits_tpu/serve/app.py``): text box with
language tags, speaker dropdown, seed, scope-shift slider (pitch), duration
multiplier.

Gradio is optional; the CLI (`python -m vits_torch.serve.engine`) covers
headless serving.
"""

from __future__ import annotations

import argparse

from vits_torch.serve.engine import TTSEngine


def build_interface(engine: TTSEngine):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use `python -m vits_torch.serve.engine` "
            "for CLI synthesis"
        ) from e

    def infer(text, speaker_id, seed, scope_shift, duration):
        phones, (sr, audio) = engine.synthesize(
            text, int(speaker_id), int(seed), int(scope_shift), float(duration)
        )
        return phones, (sr, audio)

    speakers = list(engine.hps.data.speakers)
    return gr.Interface(
        fn=infer,
        inputs=[
            gr.Textbox(
                label="text",
                value="[EN]hello world[EN]",
                info="tag languages: [EN]..[EN] [ZH]..[ZH] [JA]..[JA] [P]..[P]",
            ),
            gr.Dropdown(
                choices=list(range(len(speakers))),
                value=0,
                label=f"speaker ({', '.join(speakers)})",
            ),
            gr.Number(value=0, label="seed"),
            gr.Slider(minimum=-15, maximum=15, step=1, value=0,
                      label="pitch scope shift"),
            gr.Slider(minimum=0.5, maximum=2.0, step=0.1, value=1.0,
                      label="duration multiplier"),
        ],
        outputs=[gr.Textbox(label="phonemes"), gr.Audio(label="audio")],
        title="vits_torch demo",
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-p", "--checkpoint", default=None,
                        help="eval_{step} checkpoint or generator state_dict")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default=None, help="default: cuda")
    return parser.parse_args(argv)


def main(argv=None):  # pragma: no cover - interactive
    args = parse_args(argv)
    engine = TTSEngine(args.config, args.checkpoint, device=args.device)
    build_interface(engine).launch(server_port=args.port)


if __name__ == "__main__":
    main()
