"""Dataset split tool (the reference's ``create_nsynth_dataset_split.py``).

Merge the ``examples.json`` metadata of NSynth directories, split the keys
80/20 with the fixed seed 20200117 and write one ``examples.json`` per split
(``train/``, ``valid/``). The seed is part of the pipeline's contract: the
same directories give the same split as the JAX package's tool. Run as
``python -m interactive_spectrogram_inpainting_tpu_torch.data.split
--dataset_directories DIR [DIR ...] --output_directory OUT``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

SPLIT_SEED = 20200117


def train_test_split_keys(keys: Sequence[str], test_size: float = 0.2,
                          seed: int = SPLIT_SEED
                          ) -> Tuple[List[str], List[str]]:
    """Deterministic shuffled split (sklearn's ``train_test_split``: a
    numpy permutation from ``seed``, its first ceil(n test_size) indices go
    to test); each side keeps the keys' order."""
    keys = list(keys)
    n = len(keys)
    n_test = int(np.ceil(n * test_size))
    perm = np.random.RandomState(seed).permutation(n)
    test_idx = set(perm[:n_test].tolist())
    train = [keys[i] for i in range(n) if i not in test_idx]
    test = [keys[i] for i in range(n) if i in test_idx]
    return train, test


def create_split(dataset_directories, output_directory,
                 test_size: float = 0.2, seed: int = SPLIT_SEED
                 ) -> Dict[str, pathlib.Path]:
    """Write ``<output>/train/examples.json`` and
    ``<output>/valid/examples.json``; -> their paths by split."""
    merged: Dict[str, dict] = {}
    for directory in dataset_directories:
        with open(pathlib.Path(directory) / "examples.json") as f:
            merged.update(json.load(f))
    train_keys, valid_keys = train_test_split_keys(
        sorted(merged.keys()), test_size=test_size, seed=seed)
    output_directory = pathlib.Path(output_directory)
    out = {}
    for split, keys in (("train", train_keys), ("valid", valid_keys)):
        split_dir = output_directory / split
        split_dir.mkdir(parents=True, exist_ok=True)
        path = split_dir / "examples.json"
        with open(path, "w") as f:
            json.dump({k: merged[k] for k in keys}, f)
        out[split] = path
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge NSynth examples.json files and write a fixed-"
                    "seed train/valid split")
    parser.add_argument("--dataset_directories", type=str, nargs="+",
                        required=True)
    parser.add_argument("--output_directory", type=str, required=True)
    parser.add_argument("--test_size", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=SPLIT_SEED)
    args = parser.parse_args(argv)
    paths = create_split(args.dataset_directories, args.output_directory,
                         args.test_size, args.seed)
    for split, path in paths.items():
        print(f"{split}: {path}")
    return paths


if __name__ == "__main__":
    main()
