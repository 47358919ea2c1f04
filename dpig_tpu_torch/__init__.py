"""dpig_tpu_torch: the PyTorch/CUDA port of `dpig_tpu`.

The layout mirrors `dpig_tpu` module for module. Public functions keep the
JAX package's NHWC layout; modules run NCHW inside. Every Pallas kernel of
the JAX package is a hand-written CUDA kernel here (`csrc/`, bound in
`kernels/`), with a plain PyTorch version beside it that CPU tensors take.
"""
