"""PyTorch port: the signatures of the public functions of the eleven
namespaces against the reference's.

For every public callable of a namespace of `tritd_tpu` and its counterpart
in `tritd_tpu_torch` (`tests/test_torch_namespace.py` holds the names):
every parameter of the reference's is one of the port's (`key` aside: the
port takes a generator or the drawn arrays), and the reference's positional
parameters sit at the same positions in the port, `generator` in `key`'s
slot. `DEPARTURES` lists what the port does otherwise on purpose, each with
its reason. Then the reference's calls of the four functions whose
signatures the port once lacked run here under the reference's names.
"""

import importlib
import inspect
import pkgutil

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

SUBPACKAGES = ("", "baselines", "cli", "data", "metrics", "ops", "oracle", "parallel", "runtime", "solvers", "utils")

_RNG = "the reference's `key` slot is left out (the port's draws come from `init` or a generator after its inputs)"

#: name -> (what differs, why)
DEPARTURES = {
    "tritd_admm": ("positions", _RNG),
    "solvers.tritd_admm": ("positions", _RNG),
    "tritd_admm_outlier": ("positions", _RNG),
    "solvers.tritd_admm_outlier": ("positions", _RNG),
    "tritd_als": ("positions", _RNG),
    "solvers.tritd_als": ("positions", _RNG),
    "tritd_mals": ("positions", _RNG),
    "solvers.tritd_mals": ("positions", _RNG),
    "solvers.tritd_admm_checkpointed": ("positions", _RNG),
    "baselines.sofia_init": ("epoch_chunk", "a size of a jitted dispatch, which an eager loop has not (ROADMAP 1)"),
}

P = inspect.Parameter
POSITIONAL = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)


def _public_names(pkg) -> set:
    if hasattr(pkg, "__all__"):
        return set(pkg.__all__)
    return {m.name for m in pkgutil.iter_modules(pkg.__path__) if not m.name.startswith("_")}


def _pairs():
    for sub in SUBPACKAGES:
        ref = importlib.import_module("tritd_tpu" + (f".{sub}" if sub else ""))
        port = importlib.import_module("tritd_tpu_torch" + (f".{sub}" if sub else ""))
        for name in sorted(_public_names(ref)):
            r, p = getattr(ref, name, None), getattr(port, name, None)
            if p is None or inspect.ismodule(r) or not callable(r) or not callable(p):
                continue
            try:
                yield (f"{sub}." if sub else "") + name, inspect.signature(r), inspect.signature(p)
            except (TypeError, ValueError):  # a builtin without a signature
                continue


def _departures(ref: inspect.Signature, port: inspect.Signature) -> set:
    """What of the reference's signature the port lacks: the names of
    missing parameters, and "positions" where a positional parameter of the
    reference's sits elsewhere."""
    pp = port.parameters
    takes_any = any(q.kind == P.VAR_KEYWORD for q in pp.values())
    found = {q.name for q in ref.parameters.values()
             if q.name != "key" and q.kind not in (P.VAR_POSITIONAL, P.VAR_KEYWORD) and q.name not in pp
             and not takes_any}
    port_pos = [q.name for q in pp.values() if q.kind in POSITIONAL]
    for i, q in enumerate(q for q in ref.parameters.values() if q.kind in POSITIONAL):
        name = "generator" if q.name == "key" else q.name
        if name not in pp:
            break  # a later positional call needs this slot filled: checked by name above
        if i >= len(port_pos) or port_pos[i] != name:
            found.add("positions")
            break
    return found


def test_every_public_signature_takes_the_references_parameters():
    seen = {}
    for name, ref, port in _pairs():
        got = _departures(ref, port)
        if got:
            seen[name] = got
    assert seen == {name: {what} for name, (what, _why) in DEPARTURES.items()}


@pytest.mark.parametrize("name, call", [
    ("tritd_admm_sharded", lambda s: s.bind("d", "cfg", mesh="m")),
    ("tritd_admm_sharded", lambda s: s.bind("d", "cfg", "m", None, "slab", 1, "mask", "origin")),
    ("tritd_admm_batch_sharded", lambda s: s.bind("d", "cfg", "m", None, "data", "slab", "mask", "origin")),
    ("make_global_slab_mesh", lambda s: s.bind("slab")),
    ("initialize_distributed", lambda s: s.bind("localhost:1234", 2, 0, None, "cpu")),
    ("make_mesh", lambda s: s.bind(2, 1, ["cpu", "cpu"])),
], ids=["sharded-mesh", "sharded-positional", "batch-positional", "global-mesh", "initialize", "make-mesh"])
def test_the_references_calls_bind(name, call):
    from tritd_tpu_torch import parallel

    sig = inspect.signature(getattr(parallel, name))
    bound = call(sig)
    if name.startswith("tritd_admm"):
        assert bound.arguments["mesh"] == "m"


def test_profiler_trace_takes_the_references_default():
    from tritd_tpu_torch.utils import profiler_trace

    assert inspect.signature(profiler_trace.__wrapped__).parameters["log_dir"].default == "/tmp/tritd_profile"


def test_the_references_names_start_a_group_and_its_meshes(tmp_path):
    """initialize_distributed under the reference's names (a file store for
    the coordinator, the CPU as the platform), then its global slab mesh
    and `make_mesh(devices=)`; `local_devices` other than 1 raises."""
    from tritd_tpu_torch.parallel import initialize_distributed, make_global_slab_mesh, make_mesh

    with pytest.raises(ValueError, match="one rank on one device"):
        initialize_distributed(f"file://{tmp_path}/never", 1, 0, local_devices=2, platform="cpu")
    with pytest.raises(ValueError, match="name one setting"):
        initialize_distributed(num_processes=2, world_size=1)
    assert initialize_distributed(f"file://{tmp_path}/store", num_processes=1, process_id=0, platform="cpu",
                                  timeout_s=60) == (0, 1)
    try:
        mesh = make_global_slab_mesh("tp", device_type="cpu")
        assert mesh.mesh_dim_names == ("tp",) and mesh.size() == 1
        two_d = make_mesh(devices=[torch.device("cpu")])
        assert two_d.mesh_dim_names == ("data", "slab") and two_d.device_type == "cpu"
        with pytest.raises(ValueError, match="one device of one type a rank"):
            make_mesh(devices=["cpu", "cpu"])
    finally:
        dist.destroy_process_group()
