"""Codemap record store — the LMDB replacement (reference L4 layer).

The reference pickles ``CodeRow(top, bottom, attributes, filename)`` into
an LMDB ``codes`` sub-db (``extract_code.py:42-83``,
``utils/datasets/lmdb_dataset.py:18-89``). The payload is tiny and
fixed-shape (two small int arrays + a few labels per note), so a
memory-mapped fixed-stride binary file beats a B-tree KV store on every
axis that matters here: O(1) random access with zero deserialization,
trivially shardable, and batch reads become one contiguous memcpy.

Layout per store directory:
- ``store.json``    — header: shapes, dtype, attribute field names, count
- ``codes.bin``     — fixed-stride records: top int16 | bottom int16 |
                      attributes int32 (one per field)
- ``filenames.json``— record index -> source filename/key
- ``label_encoders.json`` — per-modality class lists (reference schema)

The port's own copy of the JAX package's module. ``read_batch`` reads
through numpy's memmap; ``use_native=True`` reads through the C++ mmap
reader of ``data/native.py`` instead (built with g++ at first use; a
failed build raises). The memmap is the default: on the H100's host a batch
of 32 from a store of NSynth train's size reads in ~0.03 ms through it and
~0.05 ms through the C++ reader (``chip_smoke.py``'s store-read phase),
either well under 0.1 % of a prior training step.
"""

from __future__ import annotations

import json
import pathlib
from collections import OrderedDict
from typing import (List, Mapping, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from .label_encoders import LabelEncoder, dump_label_encoders, load_label_encoders
from .native import NativeStoreReader


class CodeRow(NamedTuple):
    """Reference ``lmdb_dataset.py:15``."""
    top: np.ndarray
    bottom: np.ndarray
    attributes: "OrderedDict[str, int]"
    filename: str


class CodemapStoreWriter:
    def __init__(self, directory: Union[str, pathlib.Path],
                 top_shape: Tuple[int, int], bottom_shape: Tuple[int, int],
                 attribute_fields: Sequence[str],
                 label_encoders: Optional[Mapping[str, LabelEncoder]] = None,
                 n_class: Optional[int] = None,
                 n_class_top: Optional[int] = None,
                 n_class_bottom: Optional[int] = None):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.top_shape = tuple(int(x) for x in top_shape)
        self.bottom_shape = tuple(int(x) for x in bottom_shape)
        # codebook vocabulary sizes, recorded so prior training can size
        # its output layer from the data instead of assuming 512 (the
        # reference hardcodes n_class=512,
        # train_autoregressive_model.py:532 — a silent mismatch when the
        # VQ-VAE was trained with a different --num_embeddings).
        # ``n_class`` is the flat value when both levels agree;
        # per-level sizes cover unequal top/bottom codebooks.
        self.n_class = int(n_class) if n_class is not None else None
        self.n_class_top = (int(n_class_top) if n_class_top is not None
                            else self.n_class)
        self.n_class_bottom = (int(n_class_bottom)
                               if n_class_bottom is not None
                               else self.n_class)
        self.attribute_fields = list(attribute_fields)
        self._top_size = int(np.prod(self.top_shape))
        self._bottom_size = int(np.prod(self.bottom_shape))
        self._file = open(self.directory / "codes.bin", "wb")
        self._filenames: List[str] = []
        if label_encoders is not None:
            dump_label_encoders(label_encoders,
                                self.directory / "label_encoders.json")

    def append(self, top: np.ndarray, bottom: np.ndarray,
               attributes: Mapping[str, int], filename: str) -> None:
        top = np.asarray(top, dtype=np.int16).reshape(self.top_shape)
        bottom = np.asarray(bottom, dtype=np.int16).reshape(self.bottom_shape)
        attrs = np.asarray([int(attributes[f])
                            for f in self.attribute_fields], dtype=np.int32)
        self._file.write(top.tobytes())
        self._file.write(bottom.tobytes())
        self._file.write(attrs.tobytes())
        self._filenames.append(filename)

    def append_batch(self, tops: np.ndarray, bottoms: np.ndarray,
                     attributes: Mapping[str, np.ndarray],
                     filenames: Sequence[str]) -> None:
        """``append`` of every row, written as one block."""
        n = len(filenames)
        records = [
            np.asarray(tops, np.int16).reshape(n, self._top_size),
            np.asarray(bottoms, np.int16).reshape(n, self._bottom_size),
            np.stack([np.asarray(attributes[f], np.int32).reshape(n)
                      for f in self.attribute_fields], axis=1)
            if self.attribute_fields else np.zeros((n, 0), np.int32)]
        self._file.write(np.concatenate(
            [r.view(np.uint8).reshape(n, -1) for r in records],
            axis=1).tobytes())
        self._filenames.extend(filenames)

    def close(self) -> None:
        self._file.close()
        header = {
            "version": 1,
            "top_shape": list(self.top_shape),
            "bottom_shape": list(self.bottom_shape),
            "attribute_fields": self.attribute_fields,
            "codes_dtype": "int16",
            "attributes_dtype": "int32",
            "num_records": len(self._filenames),
        }
        if self.n_class is not None:
            header["n_class"] = self.n_class
        if self.n_class_top is not None:
            header["n_class_top"] = self.n_class_top
        if self.n_class_bottom is not None:
            header["n_class_bottom"] = self.n_class_bottom
        (self.directory / "store.json").write_text(
            json.dumps(header, indent=4))
        (self.directory / "filenames.json").write_text(
            json.dumps(self._filenames))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CodemapDataset:
    """Random-access reader (reference ``LMDBDataset`` equivalent):
    ``dataset[i] -> (top int64 [f, t], bottom int64 [f, t],
    OrderedDict attributes)`` filtered to ``classes_for_conditioning``
    (``lmdb_dataset.py:79-89``)."""

    def __init__(self, directory: Union[str, pathlib.Path],
                 classes_for_conditioning: Optional[Sequence[str]] = None,
                 use_native: bool = False):
        self.directory = pathlib.Path(directory)
        header = json.loads((self.directory / "store.json").read_text())
        self.top_shape = tuple(header["top_shape"])
        self.bottom_shape = tuple(header["bottom_shape"])
        self.attribute_fields: List[str] = header["attribute_fields"]
        self.num_records = int(header["num_records"])
        self.n_class: Optional[int] = header.get("n_class")
        self.n_class_top: Optional[int] = header.get("n_class_top",
                                                     self.n_class)
        self.n_class_bottom: Optional[int] = header.get("n_class_bottom",
                                                        self.n_class)
        top_bytes = int(np.prod(self.top_shape)) * 2
        bottom_bytes = int(np.prod(self.bottom_shape)) * 2
        attr_bytes = len(self.attribute_fields) * 4
        self._stride = top_bytes + bottom_bytes + attr_bytes
        self._top_bytes = top_bytes
        self._bottom_bytes = bottom_bytes
        self._mmap = np.memmap(self.directory / "codes.bin", dtype=np.uint8,
                               mode="r",
                               shape=(self.num_records, self._stride))
        self.filenames: List[str] = json.loads(
            (self.directory / "filenames.json").read_text())
        self.classes_for_conditioning = (
            list(classes_for_conditioning) if classes_for_conditioning
            else list(self.attribute_fields))
        enc_path = self.directory / "label_encoders.json"
        self.label_encoders = (load_label_encoders(enc_path)
                               if enc_path.exists() else {})
        self._native = (NativeStoreReader(
            self.directory / "codes.bin", self.num_records, self.top_shape,
            self.bottom_shape, len(self.attribute_fields))
            if use_native else None)

    def __len__(self) -> int:
        return self.num_records

    def __getitem__(self, index: int):
        rec = self._mmap[index]
        top = rec[: self._top_bytes].view(np.int16).reshape(
            self.top_shape).astype(np.int64)
        bottom = rec[self._top_bytes: self._top_bytes + self._bottom_bytes
                     ].view(np.int16).reshape(self.bottom_shape
                                              ).astype(np.int64)
        attrs_raw = rec[self._top_bytes + self._bottom_bytes:].view(np.int32)
        attributes = OrderedDict(
            (f, int(attrs_raw[i]))
            for i, f in enumerate(self.attribute_fields)
            if f in self.classes_for_conditioning)
        return top, bottom, attributes

    def read_batch(self, indices: Sequence[int]):
        """Vectorized batch read -> (tops [B,f,t] i32, bottoms [B,f,t] i32,
        {field: [B] i32}), through the C++ reader if ``use_native`` was
        True."""
        if self._native is not None:
            tops, bottoms, attrs_mat = self._native.read_batch(indices)
            attrs = {f: attrs_mat[:, i].copy()
                     for i, f in enumerate(self.attribute_fields)
                     if f in self.classes_for_conditioning}
            return tops, bottoms, attrs
        rows = self._mmap[np.asarray(indices)]
        tops = rows[:, : self._top_bytes].view(np.int16).reshape(
            (-1,) + self.top_shape).astype(np.int32)
        bottoms = rows[:, self._top_bytes: self._top_bytes
                       + self._bottom_bytes].view(np.int16).reshape(
            (-1,) + self.bottom_shape).astype(np.int32)
        attrs_raw = rows[:, self._top_bytes + self._bottom_bytes:].copy(
        ).view(np.int32).reshape(len(rows), -1)
        attrs = {f: attrs_raw[:, i].copy()
                 for i, f in enumerate(self.attribute_fields)
                 if f in self.classes_for_conditioning}
        return tops, bottoms, attrs
