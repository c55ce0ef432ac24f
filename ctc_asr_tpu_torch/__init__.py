"""ctc_asr_tpu_torch — the PyTorch/CUDA port of ``ctc_asr_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``ctc_asr_tpu`` is the reference; this package mirrors
its layout module for module and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy
and never ``jax``; from the reference it reuses only the JAX-free
modules (``config``, ``text``, ``audio``, ``metrics`` and
``data.{manifest,loader,synth}``).

Two slices are ported: serving (wav -> log-mel -> conv + (bi)LSTM
encoder -> greedy CTC decode, behind ``cli evaluate`` and ``cli
transcribe``) and training (CTC loss, LSTM BPTT, Adam, the train loop
and its checkpoints, behind ``cli train``).

Layout
------
- ``features``    framing / log-mel / MFCC / normalization / wire decode,
                  SpecAugment
- ``models``      init, SAME conv, dense, dropout, (bi)LSTM, encoder
                  (JAX layouts kept)
- ``ops``         device dispatch, greedy decode, the hand-written CUDA
                  kernels' wrappers (``stft_cuda``, ``lstm_cuda``,
                  ``ctc_cuda``)
- ``csrc``        CUDA C++ sources of those kernels, built at first use
- ``optim``       global-norm clipping, Adam / AdamW, LR schedules
- ``checkpoint``  the reference's flat-npz checkpoints, read and written
- ``train`` / ``evaluate`` / ``transcribe`` / ``cli``  the entry points
"""

__version__ = "0.1.0"
