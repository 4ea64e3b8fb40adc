"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a in
``csrc/``), their plain PyTorch versions (``ref``) and their entry points
(``ops``)."""
