"""The benchmark of the PyTorch and CUDA port: one command runs one cell
(a model configuration under a traffic mix) once. See README.md."""
