"""Scene / field IO in the reference PhiFlow format.

The port's own copy of ``diffphycon_tpu/utils/fluidformat.py`` (numpy
only): npz-compressed field read/write (``read_zipped_array`` /
``write_zipped_array``) and Scene directory management, so files written by
the reference pipeline or the JAX package read directly, and the other way
round.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Sequence

import numpy as np


def read_zipped_array(filename: str) -> np.ndarray:
    """First entry of the npz archive,
    normalized to a leading singleton batch dim (files are stored stripped)."""
    file = np.load(filename)
    array = file[file.files[0]]
    file.close()
    if array.shape[0] != 1:
        array = array.reshape((1,) + array.shape)
    return array


def write_zipped_array(filename: str, array: np.ndarray) -> None:
    """A singleton leading dim is stripped
    on disk, mirroring the reference so files round-trip byte-compatibly."""
    if array.shape[0] == 1:
        array = array[0, ...]
    np.savez_compressed(filename, array)


def _frame_name(fieldname: str, index: int) -> str:
    return f"{fieldname}_{index:06d}.npz"


def read_sim_frame(simpath: str, fieldnames: Sequence[str], index: int,
                   set_missing_to_none: bool = True):
    """The fields ``fieldnames`` (one name or a list) of frame ``index``;
    a missing file gives None, or raises when set_missing_to_none is False."""
    single = isinstance(fieldnames, str)
    names = [fieldnames] if single else list(fieldnames)
    out = []
    for name in names:
        path = os.path.join(simpath, _frame_name(name, index))
        if os.path.isfile(path):
            out.append(read_zipped_array(path))
        elif set_missing_to_none:
            out.append(None)
        else:
            raise IOError(f"missing field {name} frame {index} in {simpath}")
    return out[0] if single else out


def write_sim_frame(simpath: str, arrays, fieldnames, index: int) -> None:
    """Write each array under its field name as frame ``index``."""
    single = isinstance(fieldnames, str)
    names = [fieldnames] if single else list(fieldnames)
    arrs = [arrays] if single else list(arrays)
    os.makedirs(simpath, exist_ok=True)
    for name, arr in zip(names, arrs):
        write_zipped_array(os.path.join(simpath, _frame_name(name, index)),
                           np.asarray(arr))


def get_fieldnames(simpath: str):
    """The sorted field names with frame files in ``simpath``."""
    names = set()
    for f in os.listdir(simpath):
        m = re.match(r"([A-Za-z]+)_(\d{6})\.npz", f)
        if m:
            names.add(m.group(1))
    return sorted(names)


def get_indices(simpath: str, fieldname: Optional[str] = None):
    """The frame indices present for ``fieldname`` (every field when None:
    the common ones)."""
    fields = [fieldname] if fieldname else get_fieldnames(simpath)
    common = None
    for name in fields:
        idx = set()
        for f in os.listdir(simpath):
            m = re.match(rf"{name}_(\d{{6}})\.npz", f)
            if m:
                idx.add(int(m.group(1)))
        common = idx if common is None else (common & idx)
    return sorted(common or [])


class Scene:
    """Simulation dump directory <dir>/<category>/sim_%06d."""

    def __init__(self, directory: str, category: str, index: int):
        self.dir = directory
        self.category = category
        self.index = index

    @property
    def path(self) -> str:
        return os.path.join(self.dir, self.category, f"sim_{self.index:06d}")

    def subpath(self, name: str, create: bool = False) -> str:
        p = os.path.join(self.path, name)
        if create:
            os.makedirs(p, exist_ok=True)
        return p

    @property
    def properties(self) -> dict:
        cfg = os.path.join(self.path, "description.json")
        if os.path.isfile(cfg):
            with open(cfg) as fh:
                return json.load(fh)
        return {}

    @properties.setter
    def properties(self, d: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, "description.json"), "w") as fh:
            json.dump(d, fh, indent=2)

    def read_array(self, fieldname: str, index: int) -> np.ndarray:
        return read_sim_frame(self.path, fieldname, index)

    def write_sim_frame(self, arrays, fieldnames, index: int) -> None:
        write_sim_frame(self.path, arrays, fieldnames, index)

    def exists(self) -> bool:
        return os.path.isdir(self.path)

    @classmethod
    def create(cls, directory: str, category: str) -> "Scene":
        base = os.path.join(directory, category)
        os.makedirs(base, exist_ok=True)
        existing = [
            int(m.group(1))
            for f in os.listdir(base)
            if (m := re.match(r"sim_(\d{6})", f))
        ]
        index = (max(existing) + 1) if existing else 0
        scene = cls(directory, category, index)
        os.makedirs(scene.path, exist_ok=True)
        return scene

    @classmethod
    def list(cls, directory: str, category: str):
        base = os.path.join(directory, category)
        if not os.path.isdir(base):
            return []
        out = []
        for f in sorted(os.listdir(base)):
            m = re.match(r"sim_(\d{6})$", f)
            if m:
                out.append(cls(directory, category, int(m.group(1))))
        return out
