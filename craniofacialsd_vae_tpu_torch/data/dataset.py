"""Dataset pipeline: discovery, split, normalization, caches and batching
(counterpart of ``data/dataset.py``).

The same files, caches and draws as the JAX package, so that a
precomputed dir written by either serves the other and the batch order
is the same:

  * the split, the normalization stats and each split's stacked meshes
    are cached in the precomputed dir (``data_split.json``, ``norm.npz``,
    ``training.npz`` / ``val.npz`` / ``test.npz``), invalidated by the
    dataset fingerprint, and a reference ``norm.pt`` is imported;
  * the stratified split reproduces ``sklearn.model_selection.
    train_test_split``'s draws with numpy alone (the card's machine has
    no sklearn): ``StratifiedShuffleSplit`` and ``ShuffleSplit`` on a
    ``RandomState(seed)``, with the same errors that send the JAX package
    to its random-split fallback;
  * the feature swap is not here: it runs on the device inside the step;
  * ``DeviceBatchIterator`` uploads a split to the device once and takes
    each batch there with ``index_select``; both iterators draw their
    epoch order from ``numpy.random.default_rng(seed)``.

Offline augmentation follows the JAX package: a non-empty
``<dataset>/augmented`` is read; otherwise the train split's same-class,
same-age-group pairs are drawn from ``numpy.random.default_rng(seed)``
and generated there (``data/augmentation.py``), the spectral modes on
the device over the Laplacian basis of ``ops/eigh.py`` (K9), which is
cached in the dataset directory.

Replicated reference quirks: the class label is the first character of
the file name, with 'b' (paediatric) merged into 'n' for labels but kept
as its own class in the weight dict; class weights are 1/count.
"""

from __future__ import annotations

import csv
import json
import math
import os
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.mesh_io import read_mesh, write_obj, write_ply
from ..ops.eigh import laplacian_eigendecomposition
from .augmentation import augment_pairs

__all__ = ["MeshArrays", "DatasetSummary", "build_datasets", "BatchIterator",
           "DeviceBatchIterator", "compute_class_weights", "find_filenames",
           "split_files", "train_test_split", "save_mean_mesh"]

AGE_SPLIT_MONTHS = 48  # the age groups of the augmentation pairs (months)
_AUG_CHUNK = 32        # augmentation pairs generated per batch


@dataclass
class DatasetSummary:
    """Dataset summary table: mesh id → age/gender/used. Read from a
    ``.csv`` with the ``csv`` module; an absent path gives an empty
    summary."""
    ages: dict = field(default_factory=dict)
    genders: dict = field(default_factory=dict)
    used: list | None = None

    @classmethod
    def load(cls, path: str | None, data_type: str = "heads"):
        if not path or path in ("none", "None") or not os.path.exists(path):
            return cls()
        if not path.endswith(".csv"):
            raise ValueError(
                f"dataset summary {path}: only .csv summaries are read here "
                "(an .xlsx needs pandas and an xlsx engine); save the sheet "
                "as .csv")
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        name_map = {"Paeds": "b", "Apert": "a", "Crouzon": "c",
                    "Muenke": "m", "LSFM": "n", "LYHM": "n"}
        id_col = "ID" if data_type == "heads" else "PID"

        def number(row, col):
            """A numeric cell as pandas reads it: None for a missing
            column, NaN for an empty cell."""
            if col not in row:
                return None
            v = row[col].strip()
            return float(v) if v else float("nan")

        ages, genders, used = {}, {}, []
        used_col = "Head Used" if data_type == "heads" else "Face Used"
        for row in rows:
            ident = number(row, id_col)
            ident = -1 if ident is None or ident != ident else int(ident)
            name = f"{name_map.get(row.get('Dataset', ''), 'nan')}_{ident}"
            age = number(row, "AgeMonths")
            if age is None or age != age:
                yrs = number(row, "AgeYears")
                age = yrs * 12 + 6 if yrs is not None and yrs == yrs else -1
            ages[name] = float(age)
            gender = row.get("Gender", "n/a")
            genders[name] = gender if gender != "" else float("nan")
            if row.get(used_col) == "y":
                used.append(name)
        has_used = bool(rows) and used_col in rows[0]
        return cls(ages=ages, genders=genders,
                   used=used if has_used else None)

    def age_and_gender(self, mesh_id: str):
        return (self.ages.get(mesh_id, -1.0),
                self.genders.get(mesh_id, "n/a"))


@dataclass
class MeshArrays:
    """One split as stacked arrays."""
    x: np.ndarray              # [M, N, 3] float32 (normalized if configured)
    y: list                    # class chars ('b' merged to 'n')
    age: np.ndarray            # [M]
    gender: list
    augmented: np.ndarray      # [M] bool
    names: list

    def __len__(self):
        return len(self.y)


def _label(name: str) -> str:
    y = name.split("/")[1][0] if "/" in name else name[0]
    return "n" if y == "b" else y


def _class_char(name: str) -> str:
    return name.split("/")[1][0] if "/" in name else name[0]


def compute_class_weights(names: list) -> dict:
    """{class_char: 1/count}."""
    counts = Counter(_class_char(n) for n in names)
    return {k: 1.0 / v for k, v in counts.items()}


def find_filenames(root: str, data_to_use: list | None,
                   find_augmented: bool = True) -> list:
    files = []
    for dirpath, _, fnames in os.walk(root):
        in_aug_dir = os.path.basename(dirpath) == "augmented"
        for f in sorted(fnames):
            if not (f.endswith(".ply") or f.endswith(".obj")):
                continue
            if not in_aug_dir:
                if data_to_use is None or f[:-4] in data_to_use:
                    files.append(f)
            elif find_augmented:
                files.append(os.path.join("augmented", f))
    return files


# ------------------------------------------------------------- the split
def _split_sizes(n_samples: int, test_size):
    """sklearn's ``_validate_shuffle_split`` for a float or int
    ``test_size`` and no ``train_size`` → (n_train, n_test)."""
    if isinstance(test_size, float):
        if test_size <= 0 or test_size >= 1:
            raise ValueError(f"test_size={test_size} should be in (0, 1)")
        n_test = math.ceil(test_size * n_samples)
    else:
        if test_size >= n_samples or test_size <= 0:
            raise ValueError(f"test_size={test_size} should be positive and "
                             f"smaller than the number of samples "
                             f"{n_samples}")
        n_test = test_size
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"with n_samples={n_samples} and test_size="
                         f"{test_size} the train set would be empty")
    return int(n_train), int(n_test)


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng):
    """sklearn's ``_approximate_mode``: the most likely per-class counts of
    ``n_draws`` draws without replacement, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_indices(y: list, n_train: int, n_test: int, seed: int):
    """``StratifiedShuffleSplit(n_splits=1)``'s first (train, test)."""
    classes, y_indices, class_counts = np.unique(
        np.asarray(y), return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("the least populated class in y has only 1 member")
    if n_train < n_classes:
        raise ValueError(f"train_size = {n_train} is smaller than the "
                         f"number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"test_size = {n_test} is smaller than the number "
                         f"of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        permutation = rng.permutation(class_counts[i])
        perm = class_indices[i].take(permutation, mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(items: list, y: list | None, test_size, seed: int):
    """``sklearn.model_selection.train_test_split(items, y, stratify=y,
    test_size=…, random_state=seed)`` (``y=None``: not stratified) →
    (train items, test items, train y, test y), the same draws and the
    same ``ValueError``s."""
    n_train, n_test = _split_sizes(len(items), test_size)
    if y is not None:
        train, test = _stratified_indices(y, n_train, n_test, seed)
    else:
        perm = np.random.RandomState(seed).permutation(len(items))
        test, train = perm[:n_test], perm[n_test:n_test + n_train]
    pick = (lambda seq, idx: [seq[i] for i in idx])
    return (pick(items, train), pick(items, test),
            pick(y, train) if y is not None else None,
            pick(y, test) if y is not None else None)


def split_files(all_files: list, stratified: bool, seed: int = 0):
    """80/10/10 split: stratified by the first letter (falling back to a
    random split where a class is too small), or the deterministic i%100
    rule."""
    all_files = sorted(all_files)
    if stratified:
        y = [name[0] for name in all_files]
        try:
            train, rest, _, rest_y = train_test_split(all_files, y, 0.2,
                                                      seed)
            test, val, _, _ = train_test_split(rest, rest_y, 0.5, seed)
        except ValueError:
            print("[dataset] dataset too small to stratify; using random "
                  "split")
            train, rest, _, _ = train_test_split(all_files, None, 0.2, seed)
            test, val, _, _ = train_test_split(rest, None, 0.5, seed)
        return train, test, val
    train, test, val = [], [], []
    for i, fname in enumerate(all_files):
        if i % 100 <= 5:
            test.append(fname)
        elif i % 100 <= 10:
            val.append(fname)
        else:
            train.append(fname)
    return train, test, val


def _augment_train_list(root, train_list, template, summary, mode,
                        aug_factor, balanced, rng, device=None):
    """Generate synthetic meshes into ``<root>/augmented`` (JAX
    ``_augment_train_list``) and return the extended train list; a
    non-empty ``augmented/`` already there is read instead. The spectral
    modes take the k = 1000 Laplacian basis from ``ops.eigh`` (cached in
    ``root``) and run their products on ``device`` (None: the card,
    resolved only where a basis is used). Pairs are drawn from ``rng``
    per class ('b' merged into 'n') within an age group, in JAX's order,
    and generated in chunks of 32 pairs."""
    augmented_dir = os.path.join(root, "augmented")
    if os.path.isdir(augmented_dir) and os.listdir(augmented_dir):
        found = [n for n in sorted(os.listdir(augmented_dir))
                 if n.endswith((".obj", ".ply"))]
        print(f"[dataset] found {len(found)} previously augmented meshes")
        return train_list + [os.path.join("augmented", n) for n in found]

    eigvecs = None
    if mode in ("spectral_comb", "spectral_interp"):
        print("[dataset] computing Laplacian eigenbasis (k=1000)…")
        dev = resolve_device(device)
        _, vecs = laplacian_eigendecomposition(template, k=1000,
                                               cache_dir=root, device=dev)
        eigvecs = torch.as_tensor(vecs).to(dev, torch.float32)

    classes: dict = {}
    for name in train_list:
        age, gender = summary.age_and_gender(name[:-4])
        classes.setdefault(name[0], []).append(
            {"name": name, "age": age, "gender": gender})
    # the balanced target divides by the class count before 'b' is merged
    n_classes_pre_merge = len(classes)
    if "b" in classes:
        classes.setdefault("n", []).extend(classes.pop("b"))

    os.makedirs(augmented_dir, exist_ok=True)
    new_names = []
    n_initial = len(train_list)
    for info in classes.values():
        if balanced:
            target = (aug_factor * n_initial) // max(n_classes_pre_merge, 1)
            n_aug = max(target - len(info), 0)
        else:
            n_aug = (aug_factor - 1) * len(info)
        less_3y = [i for i in info if i["age"] < AGE_SPLIT_MONTHS]
        more_3y = [i for i in info if i["age"] >= AGE_SPLIT_MONTHS]

        names1, names2 = [], []
        for _ in range(n_aug):
            group = less_3y if (rng.random() < 0.5 and len(less_3y) >= 2) \
                else (more_3y if len(more_3y) >= 2 else less_3y)
            if len(group) < 2:
                group = info
            if len(group) < 2:
                break
            sel = rng.choice(len(group), 2, replace=False)
            names1.append(group[sel[0]]["name"])
            names2.append(group[sel[1]]["name"])

        for s in range(0, len(names1), _AUG_CHUNK):
            n1 = names1[s:s + _AUG_CHUNK]
            n2 = names2[s:s + _AUG_CHUNK]
            x1 = np.stack([read_mesh(os.path.join(root, n)).vertices
                           for n in n1]).astype(np.float32)
            x2 = np.stack([read_mesh(os.path.join(root, n)).vertices
                           for n in n2]).astype(np.float32)
            out, tags = augment_pairs(mode, x1, x2, rng, eigvecs)
            for i, (a, b, tag) in enumerate(zip(n1, n2, tags)):
                aug_name = a[:-4] + "_" + b[2:-4] + tag + str(s + i) + a[-4:]
                write_obj(os.path.join(augmented_dir, aug_name), out[i],
                          template.face)
                new_names.append(os.path.join("augmented", aug_name))
    print(f"[dataset] generated {len(new_names)} augmented meshes")
    return train_list + new_names


def _load_split_arrays(root, names, summary, mean, std, normalize,
                       cache_path):
    """cache_path=None loads in memory only."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=True)
        return MeshArrays(x=z["x"], y=list(z["y"]), age=z["age"],
                          gender=list(z["gender"]),
                          augmented=z["augmented"], names=list(z["names"]))
    xs, ys, ages, genders, augs = [], [], [], [], []
    for name in names:
        verts = read_mesh(os.path.join(root, name)).vertices \
            .astype(np.float32)
        if normalize:
            verts = (verts - mean) / std
        xs.append(verts)
        ys.append(_label(name))
        age, gender = summary.age_and_gender(os.path.basename(name)[:-4])
        ages.append(age)
        genders.append(gender)
        augs.append(name.replace(os.sep, "/").startswith("augmented/"))
    arrays = MeshArrays(
        x=np.stack(xs) if xs else np.zeros((0, 0, 3), np.float32),
        y=ys, age=np.asarray(ages, np.float32), gender=genders,
        augmented=np.asarray(augs, bool), names=list(names))
    if cache_path:
        np.savez_compressed(cache_path, x=arrays.x, y=np.asarray(arrays.y),
                            age=arrays.age, gender=np.asarray(arrays.gender),
                            augmented=arrays.augmented,
                            names=np.asarray(arrays.names))
    return arrays


def _import_reference_norm(path):
    """Reference norm.pt: torch {'mean','std'} [N,3] tensors (std with
    Bessel's correction, as computed here)."""
    d = torch.load(path, map_location="cpu", weights_only=True)
    return (d["mean"].numpy().astype(np.float32),
            d["std"].numpy().astype(np.float32))


def _dataset_fingerprint(root: str, summary) -> str:
    """sha1 over the sorted (name, size, mtime_ns) of the non-augmented
    input meshes: regenerating a dataset invalidates its caches."""
    import hashlib

    h = hashlib.sha1()
    for name in sorted(find_filenames(root, summary.used,
                                      find_augmented=False)):
        p = os.path.join(root, name)
        try:
            st = os.stat(p)
            h.update(f"{name}:{st.st_size}:{st.st_mtime_ns}\n".encode())
        except OSError:
            h.update(f"{name}:missing\n".encode())
    return h.hexdigest()


def build_datasets(config: dict, template=None, seed: int = 0,
                   device=None):
    """→ (train, val, test: MeshArrays, normalization_dict, class_weights),
    reading and writing the precomputed dir's caches as the JAX package
    does. Where the config asks for augmentation and the split is not
    cached, ``<dataset>/augmented`` is read or generated from
    ``template``, the spectral modes on ``device`` (None: the card)."""
    data_cfg = config["data"]
    root = data_cfg["dataset_path"]
    precomp = data_cfg["precomputed_path"]
    os.makedirs(precomp, exist_ok=True)
    rng = np.random.default_rng(seed)

    summary = DatasetSummary.load(data_cfg.get("dataset_summary_path"),
                                  data_cfg.get("data_type", "heads"))

    split_path = os.path.join(precomp, "data_split.json")
    fingerprint = _dataset_fingerprint(root, summary)
    split = None
    if os.path.exists(split_path):
        with open(split_path) as f:
            split = json.load(f)
        # a split we wrote carries the fingerprint of its dataset; a
        # reference data_split.json carries none and is trusted as-is
        if "dataset_fingerprint" in split \
                and split["dataset_fingerprint"] != fingerprint:
            print(f"[dataset] {root} changed since the caches in "
                  f"{precomp} were built — rebuilding split/norm/npz "
                  "caches")
            for f_stale in ("data_split.json", "norm.npz",
                            "training.npz", "test.npz", "val.npz"):
                p = os.path.join(precomp, f_stale)
                if os.path.exists(p):
                    os.remove(p)
            split = None
    if split is not None:
        train_names = split["train"]
        test_names = split["test"]
        val_names = split["val"]
    else:
        all_files = find_filenames(root, summary.used, find_augmented=False)
        train_names, test_names, val_names = split_files(
            all_files, data_cfg.get("stratified_split", False), seed)
        if data_cfg.get("augmentation_factor", 0) > 0:
            train_names = _augment_train_list(
                root, train_names, template, summary,
                data_cfg.get("augmentation_mode", "interpolate"),
                data_cfg.get("augmentation_factor", 0),
                data_cfg.get("augmentation_balanced", True), rng, device)
        with open(split_path, "w") as f:
            json.dump({"train": train_names, "test": test_names,
                       "val": val_names,
                       "dataset_fingerprint": fingerprint}, f)

    # normalization stats over the train split (cached); a reference
    # precomputed dir carries norm.pt instead, which is imported, and then
    # nothing is written next to it
    norm_path = os.path.join(precomp, "norm.npz")
    ref_norm_path = os.path.join(precomp, "norm.pt")
    ref_install = False
    if os.path.exists(norm_path):
        z = np.load(norm_path)
        mean, std = z["mean"], z["std"]
    elif os.path.exists(ref_norm_path):
        mean, std = _import_reference_norm(ref_norm_path)
        ref_install = True
    else:
        acc = None
        for i, name in enumerate(train_names):
            v = read_mesh(os.path.join(root, name)).vertices
            if acc is None:
                acc = np.zeros((len(train_names),) + v.shape, np.float64)
            acc[i] = v
        mean = acc.mean(axis=0).astype(np.float32)
        std = acc.std(axis=0, ddof=1).astype(np.float32)
        std = np.where(std > 0, std, 1e-8)
        np.savez(norm_path, mean=mean, std=std)
    normalization = {"mean": mean, "std": std}

    normalize = data_cfg.get("normalize_data", True)

    def _cache(fname):
        return None if ref_install else os.path.join(precomp, fname)

    train = _load_split_arrays(root, train_names, summary, mean, std,
                               normalize, _cache("training.npz"))
    test = _load_split_arrays(root, test_names, summary, mean, std,
                              normalize, _cache("test.npz"))
    val = _load_split_arrays(root, val_names, summary, mean, std,
                             normalize, _cache("val.npz"))

    class_weights = compute_class_weights(train_names)
    return train, val, test, normalization, class_weights


def save_mean_mesh(normalization: dict, template, out_path: str):
    """Export the training-set mean shape as a PLY on the template's faces
    (reference data_loading.py:285-290)."""
    write_ply(out_path, np.asarray(normalization["mean"]), template.face)


# ---------------------------------------------------------------- batching
class _BatchIteratorBase:
    """Shared batching logic: epoch order, drop_last stop, label mapping.
    ``epoch_plan`` advances the shuffle RNG exactly like one ``__iter__``
    pass. Subclasses supply where the vertex tensor lives."""

    def __init__(self, arrays: MeshArrays, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, class2idx: dict | None = None):
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.class2idx = class2idx

    def __len__(self):
        n = len(self.arrays)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _epoch_order(self):
        """Consumes one RNG draw when shuffling: call once per epoch."""
        n = len(self.arrays)
        return self._rng.permutation(n) if self.shuffle else np.arange(n)

    def _stop(self):
        n = len(self.arrays)
        return n - n % self.batch_size if self.drop_last else n

    def _make_batch(self, idx):
        batch = {
            "x": self._take_x(idx),
            "y": [self.arrays.y[i] for i in idx],
            "age": self.arrays.age[idx],
            "gender": [self.arrays.gender[i] for i in idx],
            "augmented": self.arrays.augmented[idx],
        }
        if self.class2idx is not None:
            batch["labels"] = np.asarray(
                [self.class2idx[y] for y in batch["y"]], np.int32)
        return batch

    def _batches(self, order):
        for s in range(0, self._stop(), self.batch_size):
            yield self._make_batch(order[s:s + self.batch_size])

    def __iter__(self):
        return self._batches(self._epoch_order())

    def ordered_batches(self):
        """A dataset-order pass that does not consume the shuffle RNG."""
        return self._batches(np.arange(len(self.arrays)))

    def epoch_plan(self):
        """One epoch as (x [n, N, 3], idx [steps, B] int32,
        labels [steps, B] | None); advances the shuffle RNG exactly like
        one ``__iter__`` pass."""
        order = self._epoch_order()
        steps = self._stop() // self.batch_size
        idx = order[:steps * self.batch_size].reshape(steps,
                                                      self.batch_size)
        labels = None
        if self.class2idx is not None:
            lab_all = np.asarray(
                [self.class2idx[y] for y in self.arrays.y], np.int32)
            labels = lab_all[idx]
        return self._plan_x(), idx.astype(np.int32), labels


class DeviceBatchIterator(_BatchIteratorBase):
    """Device-resident batcher: uploads the split's vertex tensor to
    ``device`` (None: the card) once and takes each batch there with
    ``index_select``, so a step uploads only the batch's indices."""

    def __init__(self, arrays: MeshArrays, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, class2idx: dict | None = None, device=None):
        super().__init__(arrays, batch_size, shuffle, drop_last, seed,
                         class2idx)
        self.device = resolve_device(device)
        self._x_dev = torch.as_tensor(np.ascontiguousarray(arrays.x),
                                      dtype=torch.float32, device=self.device)

    def _take_x(self, idx):
        return self._x_dev.index_select(
            0, torch.as_tensor(np.asarray(idx, np.int64), device=self.device))

    def _plan_x(self):
        return self._x_dev


class BatchIterator(_BatchIteratorBase):
    """Host-side batcher: shuffled fixed-size numpy batches, drop_last by
    default."""

    def _take_x(self, idx):
        return self.arrays.x[idx]

    def _plan_x(self):
        return self.arrays.x
