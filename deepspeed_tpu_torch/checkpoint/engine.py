"""Crash-safe checkpoint save and load of the training engine (port of
``deepspeed_tpu/checkpoint/engine.py``; ref: ``runtime/engine.py:3274
save_checkpoint`` / ``:2928 load_checkpoint``).

Layout, as in JAX: ``<save_dir>/<tag>/state`` (here one ``torch.save``
file, ``train_state.pt``, see ``runtime/checkpoint_engine.py``) +
``<save_dir>/<tag>/meta.json`` + ``<save_dir>/<tag>/manifest.json`` (crc32 of
every file in the tag) + ``<save_dir>/latest`` (the tag file).

The state tree is the port engine's own: ``params`` (the module's state
dict in the compute dtype), ``master`` (the float32 master by parameter
name, or None in float32), ``opt_state`` (the optimizer's ``state_dict()``:
its moments and both step counts, the device step that overflow skips leave
behind included), ``step``, ``scaler`` (the loss scaler's device tensors),
``skipped_steps``, ``loco_error`` (LoCo's error buffers, or None), and the
parameters' names and JAX leaves (``param_names``, ``jax_leaves``: what
``ds_to_universal`` names and shapes its atoms by).  Under
a streamed offload tier (``runtime/swap_tensor``) the master and the
optimizer's state are the tier's: the host tier writes its groups into the
tag directory (``host_opt_group*.npz``, through ``extra_state_cb``), the
NVMe tier keeps its swap files, and the tree holds neither.
``meta.json`` has JAX's keys.

Durability contract — the save sequence is ordered so a crash at ANY point
leaves a loadable directory:

  1. state tree            → ``<tag>/state``       (maybe async) [site ckpt.state_save]
  2. meta.json             → atomic write           [site ckpt.meta_write]
  3. extra state into the tag dir (a caller's callback)
  4. FENCE: an async background write is committed durable
  5. manifest.json         → atomic write           [site ckpt.manifest_write]
  6. latest                → atomic publish         [site ckpt.latest_publish]
  7. retention: keep-last-K older tags pruned

``latest`` is published strictly post-fence: a crash before (6) leaves the
previous checkpoint published and the new tag either complete-but-unlinked
or detectably torn.  ``load_checkpoint`` validates the tag ``latest`` points
at (exists + meta parses + manifest verifies) and falls back to the newest
valid tag with a warning; an explicitly requested tag is never substituted.
Tensors load onto the engine's device (``map_location``), whatever device
saved them, and into the engine's own parameters, master and optimizer.

Whatever the ZeRO stage and the world, the files hold whole tensors, as
JAX saves each array as its global logical array (its
``checkpoint/engine.py:7-11``): every rank gathers its partitioned state
(parameters, master, moments; ``engine_state``), rank 0 writes, and every
rank waits at a barrier before the save returns.  A load cuts each whole
tensor to the loading engine's partition (``restore_engine_state``), so a
checkpoint saved at any stage and world loads at any other, and
``zero_to_fp32`` reads it as a stage-0 one.
"""

import json
import os
import shutil
from typing import Callable, List, Optional, Tuple

import torch

from ..comm import comm
from ..resilience import atomic_io, events
from ..resilience.retry import RetryPolicy, retry_call
from ..utils.logging import log_dist, logger

# checkpoint metadata writes are tiny and latency-insensitive: retry hard
_CKPT_RETRY = RetryPolicy(max_attempts=4, base_delay_s=0.02, max_delay_s=0.5,
                          budget_s=5.0)


def _tag_path(save_dir, tag):
    return os.path.join(os.path.abspath(save_dir), str(tag))


# ------------------------------------------------------------ tag validity

def read_meta(tag_dir: str) -> Optional[dict]:
    meta_path = os.path.join(tag_dir, "meta.json")
    try:
        with open(meta_path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def checkpoint_tag_valid(save_dir: str, tag: str,
                         crc_scope: str = "all") -> Tuple[bool, str]:
    """Is ``<save_dir>/<tag>`` a loadable checkpoint?  Requires the tag
    directory and its state directory to exist, ``meta.json`` to parse, and —
    when a manifest was written — checksums to verify per ``crc_scope``:

    * ``"all"``  — every file incl. the state (the load-path default).
    * ``"meta"`` — manifest files outside ``state/`` only: the
      ``verify_checksums_on_load=False`` opt-out for very large checkpoints.
    * ``"none"`` — structure only: used by retention, which must not
      re-read every byte of every retained checkpoint on each save."""
    path = _tag_path(save_dir, tag)
    if not os.path.isdir(path):
        return False, "tag directory missing"
    if not os.path.isdir(os.path.join(path, "state")):
        return False, "state tree missing"
    if read_meta(path) is None:
        return False, "meta.json missing or unparseable"
    if crc_scope != "none":
        match = None if crc_scope == "all" else \
            (lambda rel: not rel.replace(os.sep, "/").startswith("state/"))
        errors = atomic_io.verify_manifest(path, match=match)
        if errors:
            return False, f"manifest verification failed: {errors[0]}" + \
                (f" (+{len(errors) - 1} more)" if len(errors) > 1 else "")
    return True, "ok"


def list_tags(save_dir: str) -> List[str]:
    """Candidate tag directories, newest first (by recorded global_steps,
    falling back to directory mtime)."""
    save_dir = os.path.abspath(save_dir)
    if not os.path.isdir(save_dir):
        return []

    def order(tag):
        path = _tag_path(save_dir, tag)
        meta = read_meta(path)
        steps = meta.get("global_steps", -1) if meta else -1
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = 0.0
        return (steps, mtime)

    # sorted(): os.listdir order is filesystem-dependent, and the sort below
    # is stable — ties would otherwise resolve in disk order
    tags = [d for d in sorted(os.listdir(save_dir))
            if os.path.isdir(os.path.join(save_dir, d, "state"))
            or os.path.exists(os.path.join(save_dir, d, "meta.json"))]
    return sorted(tags, key=order, reverse=True)


def find_newest_valid_tag(save_dir: str, exclude=(),
                          crc_scope: str = "all") -> Optional[str]:
    for tag in list_tags(save_dir):
        if tag in exclude:
            continue
        ok, _why = checkpoint_tag_valid(save_dir, tag, crc_scope=crc_scope)
        if ok:
            return tag
    return None


def _read_latest_tag(save_dir: str) -> Optional[str]:
    try:
        with open(os.path.join(save_dir, "latest")) as f:
            return f.read().strip()
    except OSError:
        return None


def _apply_retention(save_dir: str, keep_last_n: Optional[int], current_tag: str):
    """Keep-last-K: prune the oldest tag directories beyond ``keep_last_n``.
    The just-written tag and the tag ``latest`` points at are always kept;
    only valid tags count toward the budget — a torn tag is deleted."""
    if not keep_last_n or keep_last_n <= 0:
        return
    protected = {str(current_tag), _read_latest_tag(save_dir)}
    tags = list_tags(save_dir)
    kept = 0
    for tag in tags:  # newest first
        if tag in protected:
            kept += 1
            continue
        ok, why = checkpoint_tag_valid(save_dir, tag, crc_scope="none")
        if ok and kept < keep_last_n:
            kept += 1
            continue
        path = _tag_path(save_dir, tag)
        try:
            shutil.rmtree(path)
        except OSError as e:
            logger.warning(f"checkpoint retention: could not delete {path}: {e}")
            continue
        events.emit("resilience/ckpt_retention_delete")
        log_dist(f"checkpoint retention (keep_last_n={keep_last_n}): deleted "
                 f"{'invalid ' if not ok else ''}tag {path}", ranks=[0])


# ------------------------------------------------------------ the state

def engine_state(engine) -> dict:
    """The engine's state tree, whole tensors (live ones where the state is
    not partitioned: a synchronous save writes them at once, the async
    engine copies them to host before it returns).  A collective over the
    ranks when the state is partitioned: every rank calls."""
    return {
        "params": engine.module_state_dict(),
        "master": engine.full_master(),
        "opt_state": engine.full_optimizer_state_dict(),
        "step": engine.global_steps,
        "scaler": engine.scaler_state._asdict(),
        "skipped_steps": engine.skipped,
        "loco_error": engine.loco_error,
        "param_names": list(engine.param_names),
        "jax_leaves": engine.jax_leaf_map,
    }


@torch.no_grad()
def restore_engine_state(engine, restored: dict, load_optimizer_states: bool = True,
                         load_module_only: bool = False) -> None:
    """Copy a restored state tree into the engine's own tensors: the
    parameters, the master (which the optimizer holds), the optimizer's
    state, the scaler and the skip count (JAX restores all but ``opt_state``
    under ``load_module_only`` or without ``load_optimizer_states``)."""
    from ..runtime.fp16.loss_scaler import LossScalerState
    engine.load_module_state_dict(restored["params"])
    streamed = engine._nvme_opt is not None   # the tier restores its own state (``load_checkpoint``)
    if engine.use_master and not streamed:
        if restored["master"] is None:
            raise ValueError("the checkpoint holds no float32 master (a float32 run, or a streamed offload tier's): "
                             "the engine trains with one")
        engine.load_full_master(restored["master"])
    if load_optimizer_states and not load_module_only and not streamed:
        engine.load_full_optimizer_state_dict(restored["opt_state"])
    engine.scaler_state = LossScalerState(**{k: v.to(engine.device) for k, v in restored["scaler"].items()})
    engine.skipped.copy_(restored["skipped_steps"])
    if engine.loco_error is not None and restored.get("loco_error") is not None:
        for e, r in zip(engine.loco_error, restored["loco_error"]):
            e.copy_(r)


# ------------------------------------------------------------------- save

def save_checkpoint(engine, save_dir, tag=None, client_state=None, save_latest=True,
                    extra_state_cb: Optional[Callable[[str], None]] = None):
    """Crash-safe save (ordering in the module docstring).  ``extra_state_cb``
    runs with the tag directory after the state save is issued and before
    the manifest/latest publication, inside the same durability fence."""
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    save_dir = os.path.abspath(save_dir)
    path = _tag_path(save_dir, tag)
    writer = comm.get_rank() == 0
    from ..runtime.checkpoint_engine import make_checkpoint_engine
    pd = engine._config._param_dict
    ckpt_cfg = engine._config.checkpoint_config
    kind = "async" if (pd.get("nebula") or {}).get("enabled", False) else \
        (ckpt_cfg.checkpoint_engine or "torch")
    ck = make_checkpoint_engine(kind)
    state = engine_state(engine)   # every rank: the gathers of a partitioned state
    if writer:
        os.makedirs(path, exist_ok=True)
        # [site ckpt.state_save] is polled inside the engine's retried save
        ck.save(state, os.path.join(path, "state"))
        meta = {
            "tag": str(tag),
            "global_steps": engine.global_steps,
            "global_samples": engine.global_samples,
            "zero_stage": engine.zero_stage,
            "lr_scheduler": engine.lr_scheduler.state_dict() if hasattr(engine.lr_scheduler, "state_dict") else None,
            "client_state": client_state or {},
        }
        retry_call(
            lambda: atomic_io.atomic_write_json(
                os.path.join(path, "meta.json"), meta, site="ckpt.meta_write",
                indent=2, default=str),
            _CKPT_RETRY, site="ckpt.meta_write")
        if extra_state_cb is not None:
            extra_state_cb(path)
        # FENCE: an async background write must be durable before the
        # checkpoint is checksummed and published
        ck.commit(tag)
        retry_call(lambda: atomic_io.write_manifest(path), _CKPT_RETRY,
                   site="ckpt.manifest_write")
        if save_latest:
            retry_call(
                lambda: atomic_io.atomic_write_text(
                    os.path.join(save_dir, "latest"), str(tag),
                    site="ckpt.latest_publish"),
                _CKPT_RETRY, site="ckpt.latest_publish")
            events.emit("resilience/ckpt_published")
        _apply_retention(save_dir, ckpt_cfg.keep_last_n, str(tag))
    if comm.get_world_size() > 1:
        comm.barrier()
    log_dist(f"saved checkpoint {path}", ranks=[0])
    return True


# ------------------------------------------------------------------- load

def _resolve_tag(load_dir: str, tag, from_latest: bool, crc_scope: str = "all"):
    """Validate the requested tag; when it came from ``latest`` and is
    invalid (torn save, corrupt file, deleted directory), fall back to the
    newest valid tag instead of surfacing an opaque load error."""
    ok, why = checkpoint_tag_valid(load_dir, tag, crc_scope=crc_scope)
    if ok:
        return tag
    events.emit("resilience/ckpt_invalid_tag")
    if not from_latest:
        # an EXPLICITLY requested tag is never silently substituted
        raise FileNotFoundError(
            f"checkpoint tag '{tag}' at {load_dir} is not loadable ({why})")
    fallback = find_newest_valid_tag(load_dir, exclude={str(tag)}, crc_scope=crc_scope)
    if fallback is None:
        raise FileNotFoundError(
            f"'latest' points at tag '{tag}' which is not loadable ({why}), "
            f"and no valid fallback tag exists under {load_dir}")
    logger.warning(f"'latest' points at tag '{tag}' which is not loadable "
                   f"({why}); falling back to newest valid tag '{fallback}'")
    events.emit("resilience/ckpt_fallback")
    return fallback


def load_checkpoint(engine, load_dir, tag=None, load_optimizer_states=True, load_module_only=False):
    from ..runtime.checkpoint_engine import make_checkpoint_engine, wait_for_pending_saves
    wait_for_pending_saves()  # fence any in-flight async save
    load_dir = os.path.abspath(load_dir)
    from_latest = tag is None
    if from_latest:
        latest = os.path.join(load_dir, "latest")
        if not os.path.exists(latest):
            logger.warning(f"no 'latest' file at {load_dir}; nothing restored")
            return None, {}
        with open(latest) as f:
            tag = f.read().strip()
    cc = engine._config.checkpoint_config
    crc_scope = "all" if cc.verify_checksums_on_load else "meta"
    tag = _resolve_tag(load_dir, tag, from_latest, crc_scope=crc_scope)
    path = _tag_path(load_dir, tag)
    # [site ckpt.state_restore] is polled inside the engine's retried load
    restored = make_checkpoint_engine("torch").load(os.path.join(path, "state"), map_location=engine.device)
    restore_engine_state(engine, restored, load_optimizer_states=load_optimizer_states,
                         load_module_only=load_module_only)

    client_state = {}
    meta = read_meta(path)
    if meta is not None:
        engine.global_steps = meta.get("global_steps", 0)
        engine.global_samples = meta.get("global_samples", 0)
        client_state = meta.get("client_state", {})
        if meta.get("lr_scheduler") and hasattr(engine.lr_scheduler, "load_state_dict"):
            engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    log_dist(f"loaded checkpoint {path}", ranks=[0])
    return path, client_state
