from .compiler import compile_r1cs_to_gkr  # noqa: F401
from .r1cs import R1csFile  # noqa: F401
from .symfile import parse_sym  # noqa: F401
from .wtns import WtnsFile  # noqa: F401
