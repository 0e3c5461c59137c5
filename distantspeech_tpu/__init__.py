"""distantspeech_tpu — a batched JAX multichannel speech-enhancement framework.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of
wangwei2009/DistantSpeech (the parity tests' reference), redesigned for
batched accelerator execution:

- Data layout: batched, channels-last tensors.  Time signals are
  ``[..., samples, channels]``; spectra are ``[..., frame, bin, channel]``
  (scan axis leading so per-frame recursions are ``lax.scan`` steps);
  per-bin spatial matrices are ``[..., bin, M, M]``.
- Every reference "class with mutable buffers" becomes a pure
  ``step(carry, x) -> (carry, y)`` function plus an ``init(...) -> carry``;
  offline processing scans the step over a whole batch, streaming jits the
  same step per chunk.
- Frame axis is recursive (IIR smoothing) and therefore scanned; frequency
  bins are embarrassingly parallel and are the unit of model-parallel
  sharding; utterances are the data-parallel axis (see
  ``distantspeech_tpu.parallel``).

Subpackages
-----------
array      geometry, TDOA/steering, diffuse-field coherence, fractional-delay alignment
transform  STFT/ISTFT, Nyquist(M) subband filterbank + design, multirate, Griffin-Lim
ops        framing/overlap-add, delay lines, grouped FIR, log-depth IIR, Pallas kernels
stats      recursive PSD/CSD/covariance, weight rules, metrics, fast batched inverse
noise      MCRA/MCRA2/MC-SPP/MC-CDR/MC-MCRA/OMLSA estimation
adaptive   NLMS/BlockLMS/RLS/FLMS/MDF/AEC/subband adaptive filters, emphasis
beamform   DS/SD, adaptive MVDR, MVDR+OM-LSA flagship, GSC/TDGSC/FDGSC/SubbandGSC, dios_ssp port
coherence  pairwise MSC tracking, coherent gain rules, dual-mic enhancement
postfilter McCowan/Zelinski coherence postfilter
derev      multichannel RLS-WPE dereverberation
doa        SRP-PHAT, IDOA spatial speech presence
kws        dual-mic deferred-weights hotword cleaner
sim        image-source shoebox room simulation (fixtures)
parallel   ('dp','fb') mesh construction, sharded pipelines
runtime    I/O, streaming driver, checkpoint/resume, profiling, CLI
"""

__version__ = "0.1.0"
