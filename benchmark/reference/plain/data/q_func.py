"""Continuous rate control: quality q -> loss weights lambda.

One (q_g, q_a) ~ U(0, 1)^2 pair is drawn per training step and broadcast
to the batch; the lambda map is 'quadratic' (q^2 (max - min) + min) or
'exponential' (2^(q a) + b).  ``corner_p`` snaps each q component to an
exact 0 or 1 with that probability (edge-emphasis sampling).  Draws come
from an explicit ``torch.Generator``.
"""

import math

import torch


class QFunc:
    def __init__(self, config):
        self.mode = config["mode"]
        self.corner_p = float(config.get("corner_p", 0.0))
        la_min, la_max = config["lambda_A_min"], config["lambda_A_max"]
        lg_min, lg_max = config["lambda_G_min"], config["lambda_G_max"]
        if self.mode == "exponential":
            self.a = torch.tensor([math.log2(float(lg_max + lg_min)),
                                   math.log2(float(la_max + la_min))])
            self.b = torch.tensor([lg_min - 1.0, la_min - 1.0])
        elif self.mode == "quadratic":
            self.a = torch.tensor([lg_max - lg_min, la_max - la_min],
                                  dtype=torch.float32)
            self.b = torch.tensor([lg_min, la_min], dtype=torch.float32)
        else:
            raise ValueError(f"unknown q_map mode {self.mode}")

    def scale_q_vals(self, q):
        """q [..., 2] -> lambda [..., 2]."""
        a, b = self.a.to(q.device), self.b.to(q.device)
        if self.mode == "exponential":
            return 2.0 ** (q * a) + b
        return q * q * a + b

    def sample(self, generator, batch_size):
        """One q pair for the step, broadcast over the batch: (q, lambda),
        each [batch_size, 2] on the CPU."""
        q = torch.rand((1, 2), generator=generator)
        if self.corner_p > 0.0:
            u = torch.rand((1, 2), generator=generator)
            corner = (torch.rand((1, 2), generator=generator) < 0.5).float()
            q = torch.where(u < self.corner_p, corner, q)
        q = q.expand(batch_size, 2).contiguous()
        return q, self.scale_q_vals(q)
