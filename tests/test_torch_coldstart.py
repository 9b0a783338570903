"""PyTorch port, the cold start: ``serving/coldstart.py``'s store of the
built kernel library and ``ops/_build.py``'s loading without a compiler.

The store keeps the JAX ``ExecutableStore``'s rules (sha256 over the blob,
atomic writes with the manifest last, the ``O_EXCL`` manifest lock with
stale-lock breaking), held here as the JAX suite holds them
(``tests/test_autoscaler.py``, ``test_coldstart_*``). The boot tiers run
in fresh processes against a stub library (a shared object that exports
the kernels' C entry points, built here with the host compiler) in an
environment that reaches no ``nvcc``: the store's copy loads (tier 1), a
built library in the build directory loads (tier 2), and with neither the
build's "nvcc not found" is raised. The same checks with the real library
and a launch are card tests (``tests/test_torch_cuda.py``).
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest

from sparkflow_tpu_torch.ops import _build
from sparkflow_tpu_torch.serving import coldstart
from sparkflow_tpu_torch.serving.coldstart import ExecutableStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STUB_C = "\n".join(
    [f"int {name}(void) {{ return 0; }}" for name in _build._SIGNATURES]
    + ['const char *sf_cuda_error_string(int e) { return "stub library"; }',
       ""])

REPORTS = {"flash_fwd.cu": ["ptxas info    : Used 96 registers"]}


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    if shutil.which("cc") is None:
        pytest.skip("needs a host C compiler for the stub library")
    d = tmp_path_factory.mktemp("stub")
    src = d / "stub.c"
    src.write_text(_STUB_C)
    lib = d / "libstub.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    return str(lib)


@pytest.fixture()
def store(tmp_path, monkeypatch):
    s = ExecutableStore(str(tmp_path / "exe"))
    monkeypatch.setattr(s, "_fingerprint", lambda: "test-env")
    return s


# -- the store ----------------------------------------------------------------

def test_store_round_trip(store, stub_lib, tmp_path):
    key = coldstart.kernel_key()
    assert store.save(key, stub_lib, REPORTS)
    assert store.keys() == [key] and store.has(key)
    hit = store.load(key, str(tmp_path / "dest"))
    assert hit is not None
    path, reports = hit
    assert os.path.dirname(path) == str(tmp_path / "dest")
    with open(path, "rb") as f, open(stub_lib, "rb") as g:
        assert f.read() == g.read()
    assert reports == REPORTS
    entry = json.load(open(store.manifest_path))[key]
    with open(stub_lib, "rb") as g:
        assert entry["sha256"] == hashlib.sha256(g.read()).hexdigest()
    assert entry["env"] == "test-env"
    c = store.metrics.counters()
    assert c["coldstart/saves"] == 1 and c["coldstart/hits"] == 1


def test_store_corrupt_blob_is_a_miss(store, stub_lib, tmp_path):
    store.save("k", stub_lib)
    blob = os.path.join(store.directory, store._filename("k"))
    with open(blob, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    assert store.load("k", str(tmp_path / "dest")) is None
    assert store.metrics.counters()["coldstart/rejects"] == 1
    assert not os.path.exists(tmp_path / "dest")


def test_store_stale_fingerprint_is_a_miss(store, stub_lib, tmp_path,
                                           monkeypatch):
    store.save("k", stub_lib)
    monkeypatch.setattr(store, "_fingerprint", lambda: "other-card")
    assert not store.has("k")
    assert store.load("k", str(tmp_path / "dest")) is None
    assert store.metrics.counters()["coldstart/rejects"] == 1


def test_store_missing_key_is_a_miss(store, tmp_path):
    assert store.load("absent", str(tmp_path / "dest")) is None
    assert store.metrics.counters()["coldstart/misses"] == 1


def test_store_concurrent_saves_keep_every_entry(store, stub_lib):
    # threads of this process and a second process save at once; the lock
    # keeps every manifest entry (no last-writer-wins loss)
    code = ("import sys; from sparkflow_tpu_torch.serving.coldstart import "
            "ExecutableStore as S\n"
            "s = S(sys.argv[1]); s._fingerprint = lambda: 'test-env'\n"
            "for i in range(10):\n"
            "    assert s.save(f'proc/{i}', sys.argv[2])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", code, store.directory,
                             stub_lib], env=env)
    threads = [threading.Thread(target=lambda i=i: [
        store.save(f"thread{i}/{j}", stub_lib) for j in range(5)])
        for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert proc.wait(timeout=120) == 0
    assert not any(t.is_alive() for t in threads)
    keys = store.keys()
    assert len(keys) == 10 + 4 * 5
    assert not os.path.exists(store._lock_path)


def test_store_manifest_lock_lifecycle(tmp_path):
    store = ExecutableStore(str(tmp_path))
    with store._manifest_lock():
        assert os.path.exists(store._lock_path)
    assert not os.path.exists(store._lock_path)
    # a lock left by a crashed writer is broken, not waited out forever
    with open(store._lock_path, "w") as fh:
        fh.write("0")
    old = time.time() - 120.0
    os.utime(store._lock_path, (old, old))
    with store._manifest_lock():
        assert os.path.exists(store._lock_path)
    assert not os.path.exists(store._lock_path)
    assert coldstart.LOCK_TIMEOUT_S == 5.0 and coldstart.LOCK_STALE_S == 30.0


def test_store_save_runs_manifest_rmw_under_lock(store, stub_lib,
                                                 monkeypatch):
    locked_during_write = []
    real_write = store._write_manifest

    def spying_write(manifest):
        locked_during_write.append(os.path.exists(store._lock_path))
        real_write(manifest)

    monkeypatch.setattr(store, "_write_manifest", spying_write)
    assert store.save("a", stub_lib)
    assert store.save("b", stub_lib)
    assert locked_during_write == [True, True]
    assert store.keys() == ["a", "b"]


def test_fingerprint_names_torch_cuda_card_and_arch():
    import torch
    fp = coldstart.env_fingerprint()
    assert fp.startswith(f"torch-{torch.__version__}/cuda-"
                         f"{torch.version.cuda}/")
    assert fp.endswith(_build.ARCH)


def test_source_key_ignores_the_compiler(monkeypatch, tmp_path):
    key = _build.source_key()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert _build.source_key() == key
    assert _build.library_path(str(tmp_path)) == str(
        tmp_path / f"libsparkflow_kernels.{key}.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


# -- the boot tiers, in fresh processes that reach no nvcc ------------------

_BOOT = """
import json, sys
import torch
from sparkflow_tpu_torch.ops import _build
from sparkflow_tpu_torch.serving.coldstart import ExecutableStore, boot_kernels
store_dir, cache_dir = sys.argv[1], sys.argv[2]
store = None
if store_dir != "-":
    store = ExecutableStore(store_dir)
    store._fingerprint = lambda: "test-env"
cuda = torch.device("cuda")
first = boot_kernels(store, None if cache_dir == "-" else cache_dir, cuda)
second = boot_kernels(store, None, cuda)      # a second engine
fresh = ExecutableStore(store_dir + "-fresh") if store else None
if fresh:
    fresh._fingerprint = lambda: "test-env"
third = boot_kernels(fresh, None, cuda)       # fills an empty store
lib = _build.load()
print(json.dumps({
    "first": first, "second": second, "third": third,
    "fresh_keys": fresh.keys() if fresh else [], "origin": _build.loaded(),
    "error_string": lib.sf_cuda_error_string(0).decode(),
    "report": _build.ptxas_report(),
    "counters": store.metrics.counters() if store else {},
    "keys": store.keys() if store else []}))
"""


def _boot(tmp_path, store_dir="-", cache_dir="-"):
    kdir = tmp_path / "fresh-kernels"
    kdir.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH=os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))),
        CUDA_HOME=str(kdir), SPARKFLOW_TORCH_KERNEL_DIR=str(kdir),
        PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _BOOT, store_dir, cache_dir],
                       env=env, capture_output=True, text=True, timeout=300)
    return r, kdir


def test_boot_from_the_store_needs_no_nvcc(store, stub_lib, tmp_path):
    store.save(coldstart.kernel_key(), stub_lib, REPORTS)
    r, kdir = _boot(tmp_path, store.directory)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["first"]["tier"] == 1 and out["first"]["source"] == "store"
    assert not out["first"]["saved"]
    # the second engine of the process finds the library loaded; an
    # empty store is filled from it
    assert out["second"]["source"] == "already_loaded"
    assert out["second"]["tier"] is None and not out["second"]["saved"]
    assert out["third"]["source"] == "already_loaded"
    assert out["third"]["saved"]
    assert out["fresh_keys"] == [coldstart.kernel_key()]
    assert out["origin"]["how"] == "installed"
    assert os.path.dirname(out["origin"]["path"]) == str(kdir)
    assert out["error_string"] == "stub library"
    assert out["report"]["flash_fwd.cu"] == REPORTS["flash_fwd.cu"]
    assert out["report"]["paged_attention.cu"] == []
    assert out["counters"]["coldstart/hits"] == 1


def test_boot_from_the_build_directory_saves_back(store, stub_lib, tmp_path):
    cache = tmp_path / "cache"
    cache.mkdir()
    shutil.copy(stub_lib, _build.library_path(str(cache)))
    r, _ = _boot(tmp_path, store.directory, str(cache))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["first"]["tier"] == 2
    assert out["first"]["source"] == "compile_cache"
    assert out["first"]["saved"] and not out["second"]["saved"]
    assert out["origin"]["how"] == "found"
    assert out["counters"]["coldstart/misses"] == 1
    assert out["keys"] == [coldstart.kernel_key()]
    # the next boot takes the store
    r, _ = _boot(tmp_path / "next", store.directory)
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["first"]["tier"] == 1


def test_boot_past_a_stale_entry_builds_or_raises(store, stub_lib, tmp_path,
                                                  monkeypatch):
    # an entry of another environment is a counted miss; with no library
    # built and no nvcc the build tier raises — it never falls back
    monkeypatch.setattr(store, "_fingerprint", lambda: "other-card")
    store.save(coldstart.kernel_key(), stub_lib)
    r, _ = _boot(tmp_path, store.directory)
    assert r.returncode != 0
    assert "nvcc not found" in r.stderr
    r, _ = _boot(tmp_path / "no-store")
    assert r.returncode != 0 and "nvcc not found" in r.stderr


def test_boot_on_the_cpu_loads_nothing(store):
    import torch
    out = coldstart.boot_kernels(store, None, torch.device("cpu"))
    assert out == {"tier": None, "source": "cpu", "library": None,
                   "boot_s": 0.0, "saved": False}
    assert _build.loaded() is None or _build.loaded()["how"] != "installed"
