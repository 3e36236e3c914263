"""Stage A of the SpMV program: the window and dense-slice CUDA kernels."""
