"""Walker checkpoint / restart.

Counterpart of the reference's parallel-HDF5 walker restart
(``pauxy/walkers/handler.py:144-157, 432-500``: per-walker [weight, phase,
ot, phi] datasets, ``write_freq``/``read_file`` options). Here the whole
walker pytree is one dense dump — and, unlike the reference, the RNG key,
step counter and energy shift are included, so a restart continues the
*same* stochastic stream (the reference's restart silently reseeds).
"""

from __future__ import annotations

import dataclasses

import h5py
import numpy as np
import jax

from pauxy_jax.utils.transfer import to_host, to_device


def save_walkers(state, filename: str, *, key=None, step: int = 0,
                 eshift: float = 0.0, extra: dict | None = None):
    """Dump a walker-state pytree (zero-T or thermal) + driver scalars."""
    with h5py.File(filename, "w") as fh5:
        grp = fh5.create_group("walkers")
        for field in dataclasses.fields(state):
            val = getattr(state, field.name)
            if val is None:
                continue
            arr = to_host(val)
            if np.iscomplexobj(arr):
                grp[field.name + "__re"] = np.real(arr)
                grp[field.name + "__im"] = np.imag(arr)
            else:
                grp[field.name] = np.asarray(arr)
        fh5["state_class"] = type(state).__name__
        fh5["step"] = step
        fh5["eshift"] = complex(eshift).real
        if key is not None:
            fh5["rng_key"] = np.asarray(jax.random.key_data(key))
        if extra:
            for k, v in extra.items():
                fh5[f"extra/{k}"] = v


def load_walkers(template, filename: str):
    """Restore a walker state matching ``template``'s structure.

    Returns (state, info) with info = {'step', 'eshift', 'rng_key' or None}.
    """
    updates = {}
    with h5py.File(filename, "r") as fh5:
        grp = fh5["walkers"]
        for field in dataclasses.fields(template):
            name = field.name
            if name in grp:
                updates[name] = np.asarray(grp[name])
            elif name + "__re" in grp:
                updates[name] = (
                    np.asarray(grp[name + "__re"])
                    + 1j * np.asarray(grp[name + "__im"])
                )
        info = {
            "step": int(fh5["step"][()]),
            "eshift": float(fh5["eshift"][()]),
            "rng_key": None,
        }
        if "rng_key" in fh5:
            info["rng_key"] = jax.random.wrap_key_data(
                np.asarray(fh5["rng_key"])
            )
    # Cast to the template's dtypes and upload (split complex transfers).
    cast = {}
    for name, arr in updates.items():
        t = getattr(template, name)
        cast[name] = to_device(np.asarray(arr).astype(t.dtype))
    return template.replace(**cast), info


# ---------------------------------------------------------------------------
# Per-host sharded checkpoint (orbax-style directory): one HDF5 file per
# walker shard + a metadata file. Counterpart of the reference's collective
# parallel-HDF5 restart (``pauxy/walkers/handler.py:148-157, 444-500``) —
# there every MPI rank writes its slab into one file through mpio; here
# every host writes only the shards it addresses, and restart re-places each
# shard directly on its device (no host ever holds the global arrays).
# ---------------------------------------------------------------------------


def _walker_fields(state):
    """(name, value) of array fields, split into per-walker (ndim >= 1,
    sharded on the leading axis) and replicated scalars — the same
    predicate as ``parallel.mesh.shard_walkers``."""
    for field in dataclasses.fields(state):
        val = getattr(state, field.name)
        if val is not None:
            yield field.name, val


def save_walkers_sharded(state, dirname: str, *, key=None, step: int = 0,
                         eshift: float = 0.0):
    """Write one file per walker shard + meta.h5 into ``dirname``.

    Each process writes only its addressable shards, so on a multi-host
    mesh the IO is naturally parallel (the DCN story of SURVEY 2.11).
    Shard files are indexed by the global walker offset of the shard.
    """
    import os

    os.makedirs(dirname, exist_ok=True)
    shard_payload = {}   # start_index -> {field: host array}
    scalars = {}
    replicated = {}
    for name, val in _walker_fields(state):
        arr = jax.numpy.asarray(val)
        if arr.ndim == 0:
            scalars[name] = to_host(arr)
            continue
        if (len(getattr(arr.sharding, "device_set", ())) > 1
                and arr.is_fully_replicated):
            # A replicated array has every shard at start 0; writing it
            # into shard files would land it only in shard_00000000.h5
            # and the mesh restore would (rightly) flag the other files
            # as incomplete. Store it once in meta.h5 instead.
            replicated[name] = to_host(arr)
            continue
        for shard in arr.addressable_shards:
            start = shard.index[0].start or 0
            shard_payload.setdefault(start, {})[name] = to_host(shard.data)
    for start, fields in shard_payload.items():
        fname = os.path.join(dirname, f"shard_{start:08d}.h5")
        with h5py.File(fname, "w") as fh5:
            for name, arr in fields.items():
                arr = np.asarray(arr)
                if np.iscomplexobj(arr):
                    fh5[name + "__re"] = arr.real
                    fh5[name + "__im"] = arr.imag
                else:
                    fh5[name] = arr
    # Exactly one process writes the (replicated) metadata.
    if jax.process_index() == 0:
        with h5py.File(os.path.join(dirname, "meta.h5"), "w") as fh5:
            fh5["state_class"] = type(state).__name__
            fh5["step"] = step
            fh5["eshift"] = complex(eshift).real
            fh5["nwalkers"] = state.weight.shape[0]
            if key is not None:
                fh5["rng_key"] = np.asarray(jax.random.key_data(key))
            for name, val in scalars.items():
                fh5[f"scalars/{name}"] = np.asarray(val)
            for name, val in replicated.items():
                val = np.asarray(val)
                if np.iscomplexobj(val):
                    fh5[f"replicated/{name}__re"] = val.real
                    fh5[f"replicated/{name}__im"] = val.imag
                else:
                    fh5[f"replicated/{name}"] = val


def load_walkers_sharded(template, dirname: str, mesh=None):
    """Restore a sharded walker state from a checkpoint directory.

    With ``mesh`` given, every per-walker array is rebuilt shard-by-shard
    with ``jax.make_array_from_single_device_arrays`` — each host touches
    only the files of the shards it addresses. Without a mesh the shards
    are concatenated and the state is single-device (template layout).

    Returns (state, info) like :func:`load_walkers`.
    """
    import glob
    import os

    from jax.sharding import NamedSharding, PartitionSpec as P

    from pauxy_jax.parallel.mesh import WALKER_AXIS

    files = sorted(glob.glob(os.path.join(dirname, "shard_*.h5")))
    if not files:
        raise FileNotFoundError(f"no shard files in {dirname!r}")
    with h5py.File(os.path.join(dirname, "meta.h5"), "r") as fh5:
        info = {
            "step": int(fh5["step"][()]),
            "eshift": float(fh5["eshift"][()]),
            "rng_key": None,
        }
        if "rng_key" in fh5:
            info["rng_key"] = jax.random.wrap_key_data(
                np.asarray(fh5["rng_key"])
            )
        scalars = {}
        if "scalars" in fh5:
            for name in fh5["scalars"]:
                scalars[name] = np.asarray(fh5[f"scalars/{name}"])
        repl = {}
        if "replicated" in fh5:
            for name in fh5["replicated"]:
                if name.endswith("__im"):
                    continue
                base = name[:-4] if name.endswith("__re") else name
                arr = np.asarray(fh5[f"replicated/{name}"])
                if name.endswith("__re"):
                    arr = arr + 1j * np.asarray(
                        fh5[f"replicated/{base}__im"]
                    )
                repl[base] = arr

    def read_shard(fname, name):
        with h5py.File(fname, "r") as fh5:
            if name in fh5:
                return np.asarray(fh5[name])
            if name + "__re" in fh5:
                return (np.asarray(fh5[name + "__re"])
                        + 1j * np.asarray(fh5[name + "__im"]))
        return None

    updates = {}
    if mesh is not None:
        devices = list(mesh.devices.flat)
        assert len(devices) == len(files), (
            f"{len(files)} shard files vs {len(devices)} mesh devices — "
            "re-shard via the dense load_walkers path instead"
        )
        sharded = NamedSharding(mesh, P(WALKER_AXIS))
        replicated = NamedSharding(mesh, P())

        def place(name, t):
            raw = [read_shard(f, name) for f in files]
            nmiss = sum(p is None for p in raw)
            if nmiss == len(files):
                return None
            if nmiss:
                # Present in some shard files but not others: a
                # truncated/corrupt checkpoint. Restoring the template's
                # fresh values here would silently mix checkpointed and
                # re-initialized walkers.
                raise ValueError(
                    f"checkpoint {dirname!r} is incomplete: field "
                    f"{name!r} missing from {nmiss} of "
                    f"{len(files)} shard files"
                )
            shape = (sum(p.shape[0] for p in raw),) + raw[0].shape[1:]
            # Each process uploads ONLY the shards whose device it
            # addresses — on a multi-process (DCN) mesh device_put to
            # another host's device is impossible, and
            # make_array_from_single_device_arrays wants exactly the
            # addressable pieces.
            pidx = jax.process_index()
            parts_re, parts_im = [], []
            local_devices = []
            for arr, dev in zip(raw, devices):
                if dev.process_index != pidx:
                    continue
                arr = arr.astype(t.dtype)
                parts_re.append(np.ascontiguousarray(arr.real))
                parts_im.append(
                    np.ascontiguousarray(arr.imag)
                    if np.iscomplexobj(arr) else None
                )
                local_devices.append(dev)

            def assemble(parts):
                bufs = [jax.device_put(p, d)
                        for p, d in zip(parts, local_devices)]
                return jax.make_array_from_single_device_arrays(
                    shape, sharded, bufs
                )

            re = assemble(parts_re)
            if parts_im[0] is None:
                return re
            im = assemble(parts_im)
            return jax.jit(
                lambda a, b: (a + 1j * b).astype(t.dtype),
                out_shardings=sharded,
            )(re, im)

        for field in dataclasses.fields(template):
            t = getattr(template, field.name)
            if t is None or not hasattr(t, "ndim"):
                continue
            if t.ndim == 0:
                if field.name in scalars:
                    updates[field.name] = jax.device_put(
                        scalars[field.name].astype(t.dtype), replicated
                    )
                continue
            if field.name in repl:
                updates[field.name] = jax.device_put(
                    repl[field.name].astype(t.dtype), replicated
                )
                continue
            placed = place(field.name, t)
            if placed is not None:
                updates[field.name] = placed
    else:
        for field in dataclasses.fields(template):
            t = getattr(template, field.name)
            if t is None or not hasattr(t, "ndim"):
                continue
            if t.ndim == 0:
                if field.name in scalars:
                    updates[field.name] = to_device(
                        scalars[field.name].astype(t.dtype)
                    )
                continue
            if field.name in repl:
                updates[field.name] = to_device(
                    repl[field.name].astype(t.dtype)
                )
                continue
            parts = [read_shard(f, field.name) for f in files]
            nmiss = sum(p is None for p in parts)
            if nmiss == len(parts):
                continue
            if nmiss:
                raise ValueError(
                    f"checkpoint {dirname!r} is incomplete: field "
                    f"{field.name!r} missing from {nmiss} of "
                    f"{len(parts)} shard files"
                )
            updates[field.name] = to_device(
                np.concatenate(parts, axis=0).astype(t.dtype)
            )
    return template.replace(**updates), info
