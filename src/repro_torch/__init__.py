"""PyTorch/CUDA port of the SpAMM system (twin package of `repro`).

Layout mirrors `repro`: configs/, kernels/ (hand-written Hopper kernels plus
their plain PyTorch versions), core/, plans/, models/, serving/, launch/.
The package imports torch, numpy and the standard library only — never JAX
and never the `repro` package. CUDA kernels are compiled at first use (see
`repro_torch.kernels.build`), so importing any module works on a CPU-only
machine.
"""
