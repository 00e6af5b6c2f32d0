"""Batched serving with the PyTorch port: prefill + KV/SSM-cache decode
across architecture families (dense GQA, SWA ring-cache MoE, pure SSM),
each at its smoke size.

    PYTHONPATH=src python examples/torch_serve_decode.py               # card
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch import serve

ARCHS = ("granite_3_2b", "mixtral_8x22b", "falcon_mamba_7b")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    out = {}
    for arch in ARCHS:
        print(f"=== {arch} ===")
        out[arch] = serve.main(["--arch", arch, "--smoke", "--batch", "4",
                                "--prompt-len", "32", "--gen", "12"]
                               + device)
    return out


if __name__ == "__main__":
    main()
