"""The JAX package's level-0 bank that several port parity modules share,
built once per test session.

``tests/test_torch_{aux,batch_stages,detect,fused,generic,segmented}.py``
hold the port to the JAX package on one bank: the bench joint
(``synthetic.joint_model(3000, 1800)``) rendered at level 0, 64 px, with
``BANK_KW``. The JAX build is most of each module's setup (its compiles,
about 20 s of one core). The first module of a session to ask builds it
and writes its arrays (``save_bank``) under the session's temporary root,
which every xdist worker of the session shares; every later one loads them
(``load_bank``: the same arrays, bit for bit, and the same
``params_hash``). A file lock makes a module that asks while another
builds wait for that build.
"""
import fcntl
import os

from tpu_joints.modelbank import build_bank, load_bank, save_bank
from tpu_joints_torch import synthetic as syn

BANK_KW = dict(descriptor="shot", descr_radius=0.06, rf_radius=0.06,
               rf_k_max=96, frames="board", sampling_radius=0.02, normal_k=16,
               k_max=96, level=0, resolution=64, surface_leaf=0.01,
               key_capacity=64, icp_capacity=1024)


def level0_jax_bank(tmp_path_factory):
    """The JAX package's ``build_bank(syn.joint_model(3000, 1800),
    **BANK_KW)``, built at most once per session."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent              # the session's, above each worker's
    path = root / "level0_jax_bank.npz"
    with open(root / "level0_jax_bank.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.is_file():
            tmp = root / f"level0_jax_bank.{os.getpid()}.npz"
            save_bank(str(tmp), build_bank(syn.joint_model(3000, 1800),
                                           **BANK_KW))
            os.replace(tmp, path)
        return load_bank(str(path))
