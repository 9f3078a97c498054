"""repro_torch.certify — the batched certificate pipeline (PyTorch).

The counterpart of the JAX package's ``repro.certify``: analyses all
classes in one batched CAA pass, binary-searches the smallest certified
precision (optionally per layer and per scope format), persists the result
in the content-addressed store under the reference's address, and serves
it back with error bars.

  from repro_torch import certify
  cs = certify.certify(forward, params, class_los, class_his, p_star=0.6,
                       model_id="digits/h64x32",
                       store=certify.CertificateStore("certs/"))
  cs.serving_k, cs.error_bars()

CLI:  python -m repro_torch.certify --arch digits --p-star 0.6
"""
from .batch import (  # noqa: F401
    ProbeLadder,
    make_reverifier,
    margin_feasibility,
    required_k_batched,
    stack_class_ranges,
    tolerance_feasibility,
)
from .mixed import (  # noqa: F401
    MixedCaaOps,
    MixedPlan,
    MixedProbeLadder,
    flop_weighted_mean_k,
    greedy_mixed_assignment,
)
from .formats import (  # noqa: F401
    FormatCaaOps,
    FormatPlan,
    FormatProbeLadder,
    synthesize_formats,
)
from .lm import (  # noqa: F401
    certify_lm_stacked,
    lm_layer_flops,
)
from .pipeline import (  # noqa: F401
    certify,
    certify_lm,
    range_digest,
    serving_certificate,
)
from .spec import Certificate, CertificateSet, trace_summary  # noqa: F401
from .store import CertificateStore, params_digest, request_key  # noqa: F401
