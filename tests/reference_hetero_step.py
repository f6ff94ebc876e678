"""One step of the JAX reference's hetero step (clrs_tpu.parallel.hetero on
a one-device mesh), run in a process of its own that
tests/test_torch_parallel.py starts when it starts, so that the
reference's compile runs while the test process works.

    python tests/reference_hetero_step.py OUT.pkl

The problem is bench.build_problem(d=3, k=2) (Delsarte dim 8, 2d=6), omega
100.  The process imports tests/conftest.py first, so the reference runs
under the tests' JAX settings (the CPU, float64, their XLA flags).  It
pickles (y's limbs, the diagnostics as numpy scalars) to OUT.pkl and
writes its output to OUT.pkl.log.
"""

import os
import pickle
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_step():
    import bench
    import jax.numpy as jnp
    import numpy as np

    import clrs_tpu.core.solver as JS
    from clrs_tpu.parallel import hetero as jhetero

    problem, _ = bench.build_problem(d=3, dtype=np.float64, k=2)
    shapes, data, _ = jhetero.bundles_from_problem(problem, 1)
    bstates, y = jhetero.initial_bundle_state(shapes, 100.0, 100.0, 2, problem.b.dtype,
                                              problem.info.n_y)
    step = jhetero.make_hetero_step(shapes, jhetero.make_cluster_mesh(1), problem.b,
                                    JS.SolverConfig(omega_p=100.0, omega_d=100.0,
                                                    verbose=False), b0=problem.b0)
    (_, y), diag = step(tuple(data), (bstates, y), jnp.bool_(False))
    return np.asarray(y.limbs), {key: np.asarray(v) for key, v in diag.items()}


class Run:
    """The step in its own process; result() waits for it and returns what
    it pickled, raising if it failed."""

    def __init__(self, out, proc):
        self.out, self.proc = out, proc
        self._result = None

    def result(self, timeout=900):
        if self._result is None:
            rc = self.proc.wait(timeout=timeout)
            if rc != 0:
                with open(self.out + ".log") as f:
                    raise RuntimeError(f"the reference's hetero step failed ({rc}):\n"
                                       + f.read()[-4000:])
            with open(self.out, "rb") as f:
                self._result = pickle.load(f)
        return self._result

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def start(out_dir) -> Run:
    """Start the step's process, writing into out_dir."""
    out = os.path.join(str(out_dir), "hetero.pkl")
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(out + ".log", "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), out],
                                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    return Run(out, proc)


if __name__ == "__main__":
    import conftest  # noqa: F401  (the tests' JAX settings)

    result = reference_step()
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
