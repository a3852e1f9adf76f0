"""The gradio demo with ``--variant cosxl`` (the reference's ``gradio_demo_cosxl.py``);
the flags of :mod:`anyv2v_torch.cli.gradio_demo` otherwise."""

from .gradio_demo import main as _main


def main(argv=None) -> None:
    _main(argv, variant="cosxl")


if __name__ == "__main__":
    main()
