"""Ops of the port: each public function is the one dispatch point for
its op, sending CUDA tensors to a hand-written kernel
(`ops/kernels/`) and CPU tensors to the plain PyTorch version."""
