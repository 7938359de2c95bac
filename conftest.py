"""Repo-wide pytest set-up: build the JAX package's native library once,
before any test worker starts.

``srsran_project_tpu/support/native.get_lib`` runs ``make -C native`` in
every process that finds ``native/libsrsran_tpu_native.so`` missing, and
keeps ``None`` for good when it loads a file another process is still
linking; ``tests/test_native.py`` and ``tests/test_ru.py`` then skip.  Here
the xdist controller (or a run without workers) builds the library first,
so the workers find it built.  This file imports neither JAX nor either
package.
"""

import os
import subprocess

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built the library
    if os.path.exists(os.path.join(_NATIVE, "libsrsran_tpu_native.so")):
        return
    # A failed build leaves the library missing, as before: the tests that
    # need it skip, as get_lib's own build would have made them.
    subprocess.run(["make", "-C", _NATIVE], capture_output=True, check=False)
