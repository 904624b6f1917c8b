"""tike-tpu: ptycho-tomographic reconstruction in JAX.

A from-scratch re-design of the capabilities of AdvancedPhotonSource/tike:
pure-functional operators compiled by XLA, and a single
`jax.sharding.Mesh` replacing the reference's ThreadPool/MPI communicator
stack.
"""

__version__ = "0.1.0"

from . import checkpoint
from . import cluster
from . import constants
from . import linalg
from . import opt
from . import parallel
from . import precision
from . import random
from . import scan
from . import trajectory
