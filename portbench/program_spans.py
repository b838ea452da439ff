"""The program's own spans in a traced run.

``pymbar_tpu_torch`` names each span of its work
``pymbar_tpu_torch.<span>`` (``pymbar_tpu_torch/tracing.py``): a user
annotation that ``torch.profiler`` records on the host, where
``tracing.from_profiler`` keeps it among ``host_ops``.  A reader of such a
span sums its durations within each traced job (a span may repeat within a
job) and takes the mean over the jobs.  A parent commit whose program has
no such span reads nothing.  This module takes nothing of the program.

Readers of it (``source`` ``program_span``, under ``metrics/``):

=========================  ===================================================  ==========================
Metric                     Span                                                 Cells
=========================  ===================================================  ==========================
place_copy_s.numpy_in      place.host_copy: the numpy u_kn copied to float64    osc1024.numpy_in
place_upload_s.numpy_in    place.upload: that copy to the card                  osc1024.numpy_in
theta_gram_s               theta.gram: Theta's Gram pass and its check          the three free-energy cells
theta_cov_s                theta.cov: Theta from the Gram, to the host          the three free-energy cells
fe_errors_s                fe.errors: the K x K uncertainties on the host       the three free-energy cells
boot_draws_s               boot.draws: the resample indices                     osc1024.bootstrap64
boot_counts_s              boot.counts: their per-sample counts                 osc1024.bootstrap64
boot_sigma_s               boot.sigma: the host standard deviation              osc1024.bootstrap64
=========================  ===================================================  ==========================

The other spans (``dd.*``, the engine's ``boot.*``) name the idle gaps of
``breakdown`` (``tracing.gap_name``).
"""

PREFIX = "pymbar_tpu_torch."


def mean_s(trace, span):
    """The mean over ``trace.jobs`` of the seconds that the program's span
    ``span`` took in each (0 in a job that did not run it), or None when
    it ran in none of them."""
    name = PREFIX + span
    per_job = [0] * len(trace.jobs)
    found = False
    for op, start, end in trace.host_ops:
        if op != name:
            continue
        for i, (lo, hi) in enumerate(trace.jobs):
            if lo <= start < hi:
                per_job[i] += end - start
                found = True
                break
    return sum(per_job) * 1e-9 / len(per_job) if found else None
