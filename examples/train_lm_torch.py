"""End-to-end driver on the card: train an LM on tSPM+-mined clinical event
streams (the twin of examples/train_lm.py, through repro_torch).

    PYTHONPATH=src python examples/train_lm_torch.py                # quick run
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu   # the same on the CPU
    PYTHONPATH=src python examples/train_lm_torch.py --full         # ~100M params

Wraps launch/train.py: synthetic cohort -> dbmart -> token corpus -> train
with checkpointing + preemption handling.  ``--device`` (default ``cuda``)
passes through and counts as no argument.  Any ported arch:
    python examples/train_lm_torch.py --arch gemma2-2b --reduced
"""
import os
import sys
import tempfile

from repro_torch.launch import train


def args_for(argv: list) -> list:
    """The launcher's arguments for the example's command line."""
    argv = list(argv)
    device = []
    if "--device" in argv:
        i = argv.index("--device")
        device, argv = argv[i:i + 2], argv[:i] + argv[i + 2:]
    if "--full" in argv:
        argv.remove("--full")
        argv = ["--arch", "tspm-mlho", "--steps", "300", "--batch", "8",
                "--seq", "256", "--patients", "512"] + argv
    elif not argv:
        argv = ["--arch", "tspm-mlho", "--reduced", "--steps", "120",
                "--batch", "8", "--seq", "128", "--ckpt-dir",
                os.path.join(tempfile.gettempdir(), "tspm_lm_ckpt")]
    return argv + device


if __name__ == "__main__":
    train.main(args_for(sys.argv[1:]))
