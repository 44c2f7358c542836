"""Command-line tools of the PyTorch port (reference parity: src/t3dump.cpp,
src/t3proto_tool.cpp, src/main_bare.cpp, ...).  Each module runs as
``python -m ternary_image_codec_tpu_torch.cli.<tool>``, takes the JAX
package's tool's arguments plus ``--device`` (default: the current CUDA
device; without a card a tool raises unless given ``--device cpu``)."""
import argparse


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the current "
                         "CUDA device; 'cpu' runs on the CPU)")
