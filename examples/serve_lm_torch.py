"""Batched serving demo on the card: prefill + decode with the wave
scheduler (the twin of examples/serve_lm.py, through repro_torch).

    PYTHONPATH=src python examples/serve_lm_torch.py               # reduced tspm-mlho
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu  # the same on the CPU
    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-2b --reduced
    PYTHONPATH=src python examples/serve_lm_torch.py --arch deepseek-moe-16b  # full size, 33.8 GB
    PYTHONPATH=src python examples/serve_lm_torch.py --arch pixtral-12b --reduced --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-2.7b --reduced
    PYTHONPATH=src python examples/serve_lm_torch.py --arch xlstm-125m --reduced --device cpu

Wraps launch/serve.py.  ``--device`` (default ``cuda``) passes through and
counts as no argument.
"""
import sys

from repro_torch.launch import serve


def args_for(argv: list) -> list:
    """The launcher's arguments for the example's command line."""
    argv = list(argv)
    device = []
    if "--device" in argv:
        i = argv.index("--device")
        device, argv = argv[i:i + 2], argv[:i] + argv[i + 2:]
    return (argv or ["--arch", "tspm-mlho", "--reduced", "--requests", "8",
                     "--batch", "4"]) + device


if __name__ == "__main__":
    serve.main(args_for(sys.argv[1:]))
