"""The paper's own workload configs: dense-graph anomaly detection.

Port of :mod:`repro.configs.caddelag`, names and sizes only.  ``CLIMATE``
is section 4.2.1's climate data: 259,200 geolocations (the 0.5-degree
grid), fully connected.  ``ELECTION`` is section 5.2's donor graph.
``SYNTH_*`` are the sizes of the scalability study (Fig. 3).
"""

from dataclasses import dataclass

from repro_torch.core.embedding import CommuteConfig


@dataclass(frozen=True)
class GraphJob:
    name: str
    n_nodes: int
    commute: CommuteConfig
    top_k: int = 100


# paper defaults: eps 1e-2/1e-3, d=3, q=10 (section 4.2.2); the jobs run d=6
_DEFAULT = CommuteConfig(eps_rp=1e-3, d=6, q=10, schedule="cannon", fuse_l=True)

CLIMATE = GraphJob(name="climate-0.5deg", n_nodes=259200, commute=_DEFAULT)
ELECTION = GraphJob(name="election-donors", n_nodes=555924, commute=_DEFAULT)
SYNTH_100K = GraphJob(name="synth-100k", n_nodes=100000, commute=_DEFAULT)
SYNTH_200K = GraphJob(name="synth-200k", n_nodes=200000, commute=_DEFAULT)
SYNTH_500K = GraphJob(name="synth-500k", n_nodes=500000, commute=_DEFAULT)
