"""python -m sln_tpu_torch.train: see sln_tpu_torch/train/cli.py."""

from sln_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
