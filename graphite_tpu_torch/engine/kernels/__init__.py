"""Hand-written CUDA kernels of the port and their plain PyTorch forms.

  * ``dispatch.py`` — the device-based choice between a kernel and its
    plain form (no mode knob, no fallback on the card).
  * ``build.py``    — builds ``csrc/*.cu`` with nvcc into ``build/kernels``
    at first use and loads each library with ctypes.
  * ``window.py``   — the block-window walk (``csrc/window_walk.cu``) and
    the analytic fast-forward walk (``csrc/fast_forward_walk.cu``).
  * ``chain.py``    — one chain-replay iteration: the chain-head and
    directory-row gathers and the classify step
    (``csrc/chain_classify.cu``, one launch).
  * ``operands.py`` — seeded operands of the kernels, for the tests and
    ``chip_smoke.py``.
"""
