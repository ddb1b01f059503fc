"""The port's command-line entry points, ``python -m zero_tig_torch.cli.<name>``:
``train``, ``predict``, ``evals`` and ``run_pipeline``, with the JAX
package's flags. They run on the CUDA card; from Python, each ``run_*``
takes ``device="cpu"`` for the plain PyTorch versions of the kernels."""
