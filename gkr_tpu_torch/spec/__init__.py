from .gkr_spec import (prove_spec, prove_sumcheck_generic,  # noqa: F401
                       verify_sumcheck_generic)
