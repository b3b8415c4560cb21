"""Analysis (g_a) and synthesis (g_s) transforms on the family-conv engine.

g_a: 3x (5^3 stride-2 conv + GDN) + a final 5^3 conv, recording the
per-batch point count k of each level; the input conv runs in
grandparent-brick layout (``grand_input``).  g_s: a 5^3 conv + IGDN, then
three generative stride-2 transposes onto the 8-child expansion of the
previous level, each followed by an occupancy head and a per-batch top-k
prune to the transmitted k (the finest level in grandparent layout,
``grand_finest``), then the 1x1 color conv.

``region_candidates`` replaces the 8-child expansion by every child
position the kernel-5 transpose reaches: the covered children of the
27-dilated parent set (the candidate-set ablation); it runs every level
outside grandparent layout.  ``ext_keep``/``emit_last_logits`` are the
coded-occupancy hooks of ``codec/refine.py``.  Not ported yet: the oracle
diagnostics.
"""

import torch
from torch import nn

from ..ops import coords as C
from ..ops import family as F
from ..ops.sparse import (SparseTensor, compact, dilate_keys,
                          upsample_children_keys)
from ..ops.topk import topk_mask
from .gdn import GDN
from .layers import FamilyConv, FamilyDownConv, FamilyTransposeUp, PointwiseConv


class AnalysisTransform(nn.Module):
    """g_a: voxel occupancy+color features -> latents at tensor stride 8."""

    def __init__(self, C_in=4, N1=128, N2=128, N3=128, N4=128, max_batch=8,
                 cap_factors=(0.5, 0.25, 0.125), grand_input=True):
        super().__init__()
        self.C_in, self.N1 = C_in, N1
        self.max_batch = max_batch
        self.cap_factors = tuple(cap_factors)
        self.grand_input = grand_input
        self.conv1 = FamilyDownConv(C_in, N1, 5)
        self.conv1.grand = grand_input
        self.gdn1 = GDN(N1)
        self.conv2 = FamilyDownConv(N1, N2, 5)
        self.gdn2 = GDN(N2)
        self.conv3 = FamilyDownConv(N2, N3, 5)
        self.gdn3 = GDN(N3)
        self.conv4 = FamilyConv(N3, N4, 5)

    def forward(self, x: SparseTensor, root_nbr=None, level_caps=None,
                max_batch=None):
        """Returns (y at stride 8, k int32[3, max_batch] per-level counts).
        level_caps: static (s2, s4, s8, s16) capacities."""
        max_batch = max_batch or self.max_batch
        dev = x.keys.device
        if level_caps is not None:
            caps4 = list(level_caps)
        else:
            floor = min(x.capacity, 8192)
            caps = [max(int(f * x.capacity), floor) for f in self.cap_factors]
            caps4 = caps + [caps[2]]
        # levels: 0=input(stride1), 1=s2, 2=s4, 3=s8 (y), 4=s16 (root)
        levels = F.pyramid(x.keys, caps4, skip_finest_nbr=True,
                           root_nbr=root_nbr)
        k2 = x.counts_per_batch(max_batch)

        def fm(l):
            nbr = levels[l + 1]["nbr"]
            return F.FamilyMap(parent_keys=levels[l + 1]["keys"],
                               point_parent=levels[l]["pp"],
                               point_slot=levels[l]["sl"],
                               nbr_idx=nbr[0], nbr_ok=nbr[1])

        if self.grand_input:
            cap1 = levels[1]["keys"].shape[0]
            cap2 = levels[2]["keys"].shape[0]
            pp0, sl0 = levels[0]["pp"], levels[0]["sl"]  # point -> s2
            pp1, sl1 = levels[1]["pp"], levels[1]["sl"]  # s2 -> s4
            # grandparent index/slot per input point; invalid points
            # (pp0 == cap1) land on the dump row cap2
            pp1_ext = torch.cat([pp1, torch.full((1,), cap2, dtype=pp1.dtype,
                                                 device=dev)])
            sl1_ext = torch.cat([sl1, torch.zeros(1, dtype=sl1.dtype,
                                                  device=dev)])
            pp0l = pp0.to(torch.int64)
            gpar = pp1_ext[pp0l].to(torch.int64)
            gslot = ((sl1_ext[pp0l] << 3) | sl0).to(torch.int64)
            fdt = x.feats.dtype
            xb = torch.zeros(((cap2 + 1) * 64, self.C_in), dtype=fdt,
                             device=dev)
            xb[gpar * 64 + gslot] = x.feats * x.valid[:, None].to(fdt)
            xb = xb.reshape(cap2 + 1, 64, self.C_in)[:cap2]
            nbr2 = levels[2]["nbr"]
            fb = self.conv1(nbr2, xb, None, grand=True)  # [cap2, 8, N1]
            rows = pp1.clamp(max=cap2 - 1).to(torch.int64) * 8 + sl1
            v1 = C.key_is_valid(levels[1]["keys"])
            f1 = fb.reshape(cap2 * 8, self.N1)[rows] * v1[:, None].to(fb.dtype)
        else:
            f1 = self.conv1(fm(0), x.feats, x.valid)
        x = SparseTensor(keys=levels[1]["keys"], feats=f1, stride=x.stride * 2)
        x = x.replace(feats=self.gdn1(x.feats))
        k1 = x.counts_per_batch(max_batch)

        f2 = self.conv2(fm(1), x.feats, x.valid)
        x = SparseTensor(keys=levels[2]["keys"], feats=f2, stride=x.stride * 2)
        x = x.replace(feats=self.gdn2(x.feats))
        k0 = x.counts_per_batch(max_batch)

        f3 = self.conv3(fm(2), x.feats, x.valid)
        x = SparseTensor(keys=levels[3]["keys"], feats=f3, stride=x.stride * 2)
        x = x.replace(feats=self.gdn3(x.feats))

        f4 = self.conv4(fm(3), x.feats, x.valid, out_keys_valid=x.valid)
        x = x.replace(feats=f4)
        k = torch.stack([k0, k1, k2]).to(torch.int32)
        return x, k


class OccupancyHead(nn.Module):
    """3^3 conv -> ReLU -> 3^3 conv -> 1 logit per candidate voxel."""

    def __init__(self, cin, chid):
        super().__init__()
        self.c1 = FamilyConv(cin, chid, 3)
        self.c2 = FamilyConv(chid, 1, 3)

    def forward(self, fm, feats, valid, grand=False):
        ov = None if grand else valid
        h = self.c1(fm, feats, valid, out_keys_valid=ov, grand=grand)
        h = torch.relu(h)
        h = self.c2(fm, h, valid, out_keys_valid=ov, grand=grand)
        return h[..., 0]


class SparseSynthesisTransform(nn.Module):
    """g_s: latents at stride 8 -> colored point cloud at stride 1."""

    def __init__(self, C_out=3, N1=128, N2=128, N3=128, N4=128, max_batch=8,
                 prune_cap_factors=(2.0, 4.0, 8.0), region_candidates=False,
                 region_dilate_factor=3.0, prune_slack=(1.0, 1.0),
                 min_one_child=False, grand_finest=True):
        super().__init__()
        if min_one_child and region_candidates:
            # the floor assumes candidates arrive parent-major, 8 per real
            # parent; the dilated candidate set breaks that layout and would
            # boost children of empty dilated parents
            raise ValueError("min_one_child is incompatible with "
                             "region_candidates (the per-parent floor "
                             "assumes the 8-child parent-major layout)")
        self.prune_cap_factors = tuple(prune_cap_factors)
        self.prune_slack = tuple(float(s) for s in prune_slack)
        self.min_one_child = min_one_child
        self.region_candidates = region_candidates
        self.region_dilate_factor = float(region_dilate_factor)
        # region mode never runs the finest level in grandparent layout
        self.grand_finest = grand_finest and not region_candidates
        self.up1_conv = FamilyConv(N4, N3, 5)
        self.igdn1 = GDN(N3, inverse=True)
        self.specs = [
            (N3, N2, "up1_t", N2, N2 // 2, "pred1"),
            (N2, N1, "up2_t", N1, N1 // 2, "pred2"),
            (N1, N1 // 4, "up3_t", N1 // 4, N4 // 8, "pred3"),
        ]
        for cin, cout, tname, pcin, pchid, pname in self.specs:
            self.add_module(tname, FamilyTransposeUp(cin, cout, 5))
            self.add_module(pname, OccupancyHead(pcin, pchid))
        if self.grand_finest:
            # the finest level runs in grandparent layout
            self.up3_t.grand = self.pred3.c1.grand = self.pred3.c2.grand = True
        self.igdn2 = GDN(N2, inverse=True)
        self.igdn3 = GDN(N1, inverse=True)
        self.color_conv = PointwiseConv(N1 // 4, C_out)

    def _k_eff(self, k, lvl):
        s = self.prune_slack[lvl] if lvl < len(self.prune_slack) else 1.0
        if lvl >= 2 or s == 1.0:
            return k[lvl]
        return torch.ceil(k[lvl].float() * s).to(k.dtype)

    def _prune_logits(self, logits, cvalid):
        if not self.min_one_child:
            return logits
        # per-parent floor: candidates arrive parent-major, 8 per parent;
        # each valid parent's best child (first max) gets +1e4
        l2 = torch.where(cvalid, logits, -torch.inf).reshape(-1, 8)
        best = torch.argmax(l2, dim=1)
        has = cvalid.reshape(-1, 8).any(dim=1)
        bonus = (torch.nn.functional.one_hot(best, 8).to(logits.dtype)
                 * has[:, None].to(logits.dtype) * 1e4)
        return logits + bonus.reshape(-1)

    def forward(self, y: SparseTensor, k, prune_caps=None, y_struct=None,
                num_levels=3, ext_keep=(), emit_last_logits=False):
        """y: latents (stride 8); k: int32[3, max_batch] target counts;
        prune_caps: static pruned-level capacities; y_struct: the params
        graph's stride-16 structure (g_s then performs no search).
        ext_keep[lvl] (bool, candidate-aligned) replaces the top-k ranking
        of that level by an externally decoded selection;
        emit_last_logits stops at level num_levels-1 right after its
        occupancy logits (no prune, no color head).
        Returns (x_hat, candidates, logits_list)."""
        base_cap = y.capacity
        dev = y.keys.device
        caps = list(prune_caps) if prune_caps is not None else \
            [int(f * base_cap) for f in self.prune_cap_factors]
        if y_struct is not None:
            fm_y = F.FamilyMap(parent_keys=y_struct["parent_keys"],
                               point_parent=y_struct["pp"],
                               point_slot=y_struct["sl"],
                               nbr_idx=y_struct["nbr_idx"],
                               nbr_ok=y_struct["nbr_ok"])
            nbr = F.derive_self_neighbors(
                y.keys, y_struct["pp"], y_struct["sl"],
                (y_struct["nbr_idx"], y_struct["nbr_ok"]))
        else:
            ylv = F.pyramid(y.keys, [base_cap])
            nbr = ylv[0]["nbr"]
            fm_y = F.FamilyMap(parent_keys=ylv[1]["keys"],
                               point_parent=ylv[0]["pp"],
                               point_slot=ylv[0]["sl"],
                               nbr_idx=ylv[1]["nbr"][0],
                               nbr_ok=ylv[1]["nbr"][1])
        f = self.up1_conv(fm_y, y.feats, y.valid, out_keys_valid=y.valid)
        f = self.igdn1(f)
        x = y.replace(feats=f)

        cands, logits_list = [], []
        prev_link = None
        for lvl, (cin, cout, tname, pcin, pchid, pname) in \
                enumerate(self.specs):
            if lvl >= num_levels:
                break
            transpose = getattr(self, tname)
            head = getattr(self, pname)
            parent_keys = x.keys
            if lvl == 2 and self.grand_finest and prev_link is not None:
                gpar, gslot, g_nbr, gcap, xvalid = prev_link
                n_parents = parent_keys.shape[0]
                child_keys = upsample_children_keys(parent_keys)
                cvalid = C.key_is_valid(child_keys)
                # pack x (stride 2) into its grandparent brick [gcap, 8, cin]
                fdt = x.feats.dtype
                flat_pos = gpar.to(torch.int64) * 8 + gslot.to(torch.int64)
                xb = torch.zeros(((gcap + 1) * 8, cin), dtype=fdt, device=dev)
                xb[flat_pos] = x.feats * xvalid[:, None].to(fdt)
                xb = xb.reshape(gcap + 1, 8, cin)[:gcap]
                vb = torch.zeros((gcap + 1) * 8, dtype=torch.bool, device=dev)
                vb[flat_pos] = xvalid
                vb = vb.reshape(gcap + 1, 8)[:gcap]
                cvb = vb[:, :, None].expand(gcap, 8, 8).reshape(gcap, 64)
                cg = transpose(g_nbr, xb, cvb, grand=True)  # [G, 64, cout]
                lgrand = head(g_nbr, cg, cvb, grand=True)   # [G, 64]
                # flatten to candidate order (8 children per x row)
                rows = gpar.clamp(max=gcap - 1).to(torch.int64) * 8 \
                    + gslot.to(torch.int64)
                # bf16 candidate features: they only feed the color head
                cf8 = cg.to(torch.bfloat16).reshape(gcap * 8, 8, cout)[rows]
                cfeats = (cf8 * xvalid[:, None, None].to(cf8.dtype)
                          ).reshape(8 * n_parents, cout)
                logits = (lgrand.reshape(gcap * 8, 8)[rows]
                          * xvalid[:, None]).reshape(8 * n_parents)
                cand = SparseTensor(
                    keys=torch.where(cvalid, child_keys,
                                     C.sentinel_like(child_keys)),
                    feats=cfeats, stride=x.stride // 2)
                cands.append(cand)
                logits_list.append(logits)
                if emit_last_logits and lvl == num_levels - 1:
                    break
                if lvl < len(ext_keep):
                    keep = ext_keep[lvl] & cvalid
                else:
                    keep = topk_mask(cand,
                                     self._prune_logits(logits, cvalid),
                                     self._k_eff(k, lvl)) & cvalid
                pk, pf = compact(child_keys, keep, cand.feats,
                                 out_capacity=caps[lvl])
                x = SparseTensor(keys=pk, feats=pf, stride=x.stride // 2)
                continue
            if self.region_candidates:
                # candidates: every child position the kernel-5 transpose
                # reaches = the covered children of the 27-dilated parents
                dcap = int(self.region_dilate_factor * parent_keys.shape[0])
                d_keys = dilate_keys(parent_keys, dcap)
                d_nbr = F.root_neighbors(d_keys)
                cross = F.cross_neighbors(d_keys, parent_keys)
                child_keys = upsample_children_keys(d_keys)
                cf = F.child_family(d_keys, nbr=d_nbr)
                cfeats = transpose(cross, x.feats, x.valid)
                cover = cross[1].to(torch.float32) @ torch.as_tensor(
                    F.transpose_cover_table(), dtype=torch.float32,
                    device=dev)
                cvalid = C.key_is_valid(child_keys) \
                    & (cover > 0).reshape(-1)
                parent_nbr_next = d_nbr
                n_parents = d_keys.shape[0]
            else:
                child_keys = upsample_children_keys(parent_keys)
                cf = F.child_family(parent_keys, nbr=nbr)
                cfeats = transpose(nbr, x.feats, x.valid)
                cvalid = C.key_is_valid(child_keys)
                parent_nbr_next = nbr
                n_parents = parent_keys.shape[0]
            # finest level: candidate feats ride bf16 (they only feed the
            # color head), logits stay f32
            cand = SparseTensor(
                keys=torch.where(cvalid, child_keys,
                                 C.sentinel_like(child_keys)),
                feats=cfeats.to(torch.bfloat16) if lvl == 2 else cfeats,
                stride=x.stride // 2)
            logits = head(cf, cfeats, cvalid)
            cands.append(cand)
            logits_list.append(logits)
            if emit_last_logits and lvl == num_levels - 1:
                break
            if lvl < len(ext_keep):
                keep = ext_keep[lvl] & cvalid
            else:
                keep = topk_mask(cand, self._prune_logits(logits, cvalid),
                                 self._k_eff(k, lvl)) & cvalid
            # prune with parent links carried through the compaction
            pk, pf, ppar, pslot = compact(child_keys, keep, cand.feats,
                                          cf.point_parent, cf.point_slot,
                                          out_capacity=caps[lvl])
            pvalid = C.key_is_valid(pk)
            ppar = torch.where(pvalid, ppar, n_parents)
            x = SparseTensor(keys=pk, feats=pf, stride=x.stride // 2)
            if lvl < 2:
                if lvl == 1 and self.grand_finest:
                    # level 2 runs in grandparent layout: it needs the
                    # parent links and the stride-4 self map
                    prev_link = (ppar, pslot, parent_nbr_next, n_parents,
                                 pvalid)
                else:
                    nbr = F.derive_self_neighbors(pk, ppar, pslot,
                                                  parent_nbr_next)
                igdn = self.igdn2 if lvl == 0 else self.igdn3
                x = x.replace(feats=igdn(x.feats))

        if num_levels == 3 and not emit_last_logits:
            f = self.color_conv(x.feats, x.valid)
            x = x.replace(feats=f)
        return x, cands, logits_list
