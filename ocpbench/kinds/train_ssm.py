"""Training steps of the SSM language model (`traffic.Train`) on Mamba-2's
published A and dt init.

The seed's draw gives every leaf N(0, 0.02) or ones (`weights.draw`), which
makes A = -e and dt ~ 1.3: each head's state then decays by e^-3.5 a
step, so none outlives a chunk and no check could see the state carried
from one chunk of the scan to the next.  Here ``blocks/ssm/A_log`` and
``blocks/ssm/dt_bias`` are set after the draw by Mamba-2's published init
(arXiv:2405.21060; the ``mamba_ssm`` package's `Mamba2`), from the run's
own stream ``ssm_init``: A uniform in [1, 16], dt log-uniform in [1e-3,
1e-1], dt_bias = softplus^-1(dt).  The program's weights and the
reference's get the same values; everything else is `traffic.Train`'s.
"""
from typing import Dict

import numpy as np
import torch

from ocpbench import weights
from ocpbench.traffic import Train


def published_init(m: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """A_log and dt_bias, (layers, heads) fp32 on the host."""
    rng = np.random.default_rng(weights.sub_seed(seed, "ssm_init"))
    shape = (m["n_layers"], m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"])
    A_log = np.log(rng.uniform(1, 16, size=shape))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=shape))
    dt_bias = dt + np.log(-np.expm1(-dt))
    return {"A_log": torch.from_numpy(A_log.astype(np.float32)),
            "dt_bias": torch.from_numpy(dt_bias.astype(np.float32))}


class Kind(Train):
    def published(self, tree: Dict) -> Dict:
        ssm = tree["blocks"]["ssm"]
        for k, v in published_init(self.m, self.seed).items():
            ssm[k] = v.to(device=ssm[k].device, dtype=ssm[k].dtype)
        return tree

    def draw_weights(self) -> Dict:
        return self.published(super().draw_weights())

    def reference_run(self, precision: str = "fp32", keep_rows=None, carry: bool = True) -> Dict:
        """`Train.reference_run` from the published init; ``carry=False``
        drops the state carried between chunks in the reference (a fault
        for the limits' readings)."""
        def fp32(t):
            return {k: fp32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

        params = fp32(self.published(weights.draw(self.m, self.seed, self.dev, self.reference)))
        init = {p: w.clone() for p, w in self.reference.tree_paths(params)}
        out = self.reference.train_steps(self.m, self.hyper(), params, self.reference_batches(),
                                         self.mix["microbatches"], precision,
                                         keep_rows=keep_rows, carry=carry)
        out["change_norms"] = {p: float(torch.linalg.vector_norm(w - init[p]))
                               for p, w in self.reference.tree_paths(params)}
        return out
