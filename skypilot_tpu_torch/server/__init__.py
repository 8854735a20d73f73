"""API server (parity: sky/server/ — FastAPI app at server.py:622,
LONG/SHORT request executor, persisted+resumable requests DB).

The port's counterpart of `skypilot_tpu/server/__init__.py` (this
docstring is the difference): `python -m skypilot_tpu_torch.server.app`
serves the port's control plane over the same REST API as the JAX
package's server; the modules here are copies of its server/ modules
(tests/test_torch_package.py pins them), over the port's launch path,
managed jobs and SkyServe.  None of
them imports torch: a LONG request's worker process starts without it.
"""
