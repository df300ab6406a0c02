"""nnet3 graph -> batched JAX forward function.

Replaces Kaldi's nnet3 computation VM (nnet-compile.cc / nnet-compute.cc /
decodable-simple-looped.cc:66-180, ~68k LoC of graph compiler + interpreter)
with a direct compilation: the node graph of a parsed ``Nnet3Spec`` is
planned once per (num_output_frames, subsampling) into static time ranges
per node, then evaluated as a chain of batched jnp ops over
``[streams, frames, dim]`` arrays. XLA sees one straight-line program of
matmuls + elementwise ops — no interpreter, no per-frame dispatch; every
matmul is a [B*T, D] product. f32 plans run their matmuls at
Precision.HIGHEST (no TF32 input rounding); bf16 plans (``cast``) run bf16
with f32 accumulation.

Time indexing: every node value is an array covering times
``[lo, hi)`` (frame indices relative to the *output* frame clock, before
subsampling). The input node's planned range defines the model's left/right
context, exactly like Kaldi's nnet3 context computation.

Descriptor semantics follow kaldi/src/nnet3/nnet-descriptor.h: Append, Sum,
Offset, Scale, Const, ReplaceIndex, Round, IfDefined, Failover, Switch.
Component semantics follow the corresponding Component::Propagate
implementations (nnet-simple-component.cc, nnet-normalize-component.cc,
nnet-tdnn-component.cc).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..io.nnet3_file import ComponentSpec, Descriptor, Nnet3Spec, NodeSpec

# ---------------------------------------------------------------------------
# Planning: per-node time ranges
# ---------------------------------------------------------------------------


def _accumulate(acc: Dict[str, Tuple[int, int]], name: str, lo: int, hi: int) -> None:
    if hi <= lo:
        return
    cur = acc.get(name)
    if cur is None:
        acc[name] = (lo, hi)
    else:
        acc[name] = (min(cur[0], lo), max(cur[1], hi))


def _desc_ranges(
    desc: Descriptor, lo: int, hi: int, acc: Dict[str, Tuple[int, int]]
) -> None:
    kind = desc[0]
    if kind == "node":
        _accumulate(acc, desc[1], lo, hi)
    elif kind == "offset":
        _desc_ranges(desc[1], lo + desc[2], hi + desc[2], acc)
    elif kind in ("append", "sum", "switch"):
        for sub in desc[1]:
            _desc_ranges(sub, lo, hi, acc)
    elif kind == "scale":
        _desc_ranges(desc[2], lo, hi, acc)
    elif kind == "const":
        pass
    elif kind == "replace_index":
        _desc_ranges(desc[1], desc[3], desc[3] + 1, acc)
    elif kind == "round":
        m = desc[2]
        new_lo = (lo // m) * m
        new_hi = ((hi - 1) // m) * m + 1
        _desc_ranges(desc[1], new_lo, new_hi, acc)
    elif kind == "ifdefined":
        # IfDefined doesn't *require* its argument; but for static shapes we
        # compute it over the clamped intersection at eval time. Request the
        # full range so recurrent paths (when in range) are available.
        _desc_ranges(desc[1], lo, hi, acc)
    elif kind == "failover":
        _desc_ranges(desc[1], lo, hi, acc)
        _desc_ranges(desc[2], lo, hi, acc)
    else:
        raise ValueError(f"unknown descriptor kind {kind}")


def _collect_back_refs(desc: Descriptor, out: set, cur_off: int) -> None:
    """Collect (node name, accumulated time offset) for every reference."""
    kind = desc[0]
    if kind == "node":
        out.add((desc[1], cur_off))
    elif kind in ("append", "sum", "switch"):
        for sub in desc[1]:
            _collect_back_refs(sub, out, cur_off)
    elif kind == "offset":
        _collect_back_refs(desc[1], out, cur_off + desc[2])
    elif kind == "ifdefined":
        _collect_back_refs(desc[1], out, cur_off)
    elif kind == "scale":
        _collect_back_refs(desc[2], out, cur_off)
    elif kind in ("replace_index", "round"):
        _collect_back_refs(desc[1], out, cur_off)
    elif kind == "failover":
        _collect_back_refs(desc[1], out, cur_off)
        _collect_back_refs(desc[2], out, cur_off)


def _prune_back_edges(desc: Descriptor, later_names: set):
    """Copy of a descriptor with references to later-defined nodes removed
    (for range planning; those reads come from the scan carry). Returns
    None when the whole descriptor is a back-edge."""
    kind = desc[0]
    if kind == "node":
        return None if desc[1] in later_names else desc
    if kind in ("append", "sum", "switch"):
        subs = [_prune_back_edges(s, later_names) for s in desc[1]]
        kept = [s for s in subs if s is not None]
        if not kept:
            return None
        return (kind, kept)
    if kind in ("offset",):
        sub = _prune_back_edges(desc[1], later_names)
        return None if sub is None else ("offset", sub, desc[2])
    if kind == "ifdefined":
        sub = _prune_back_edges(desc[1], later_names)
        return None if sub is None else ("ifdefined", sub)
    if kind == "scale":
        sub = _prune_back_edges(desc[2], later_names)
        return None if sub is None else ("scale", desc[1], sub)
    if kind in ("replace_index", "round"):
        sub = _prune_back_edges(desc[1], later_names)
        return None if sub is None else (kind, sub) + tuple(desc[2:])
    if kind == "failover":
        a = _prune_back_edges(desc[1], later_names)
        b = _prune_back_edges(desc[2], later_names)
        if a is None:
            return b
        if b is None:
            return a
        return ("failover", a, b)
    if kind == "const":
        return desc
    raise ValueError(kind)


def _collect_node_refs(desc: Descriptor, out: set) -> None:
    kind = desc[0]
    if kind == "node":
        out.add(desc[1])
    elif kind in ("append", "sum", "switch"):
        for sub in desc[1]:
            _collect_node_refs(sub, out)
    elif kind in ("offset", "ifdefined"):
        _collect_node_refs(desc[1], out)
    elif kind == "scale":
        _collect_node_refs(desc[2], out)
    elif kind in ("replace_index", "round"):
        _collect_node_refs(desc[1], out)
    elif kind == "failover":
        _collect_node_refs(desc[1], out)
        _collect_node_refs(desc[2], out)


def collapse_batchnorms(
    spec: Nnet3Spec, protected: Tuple[str, ...] = ()
) -> Nnet3Spec:
    """Kaldi CollapseModel equivalent for inference (nnet3/nnet-utils.h
    CollapseModel; the decode binaries run it at model load,
    online2-wav-nnet3-latgen-faster.cc:169-171).

    Each BatchNormComponent whose output feeds exactly one linear-family
    component through a plain node reference is folded into that
    component's weights (per-time-offset column blocks scaled, the
    offsets' contribution added to the bias) and deleted — one fewer
    [B, T, dim] elementwise pass per layer at decode time. BN nodes with
    multiple consumers, block-wise dims, non-trivial descriptors, shared
    components (one ComponentSpec used by several nodes), or names in
    ``protected`` (e.g. the requested output node) are left alone."""
    import dataclasses as _dc

    nodes = list(spec.nodes)
    comps = dict(spec.components)
    did_fold = False
    linear_types = {
        "LinearComponent",
        "TdnnComponent",
        "AffineComponent",
        "NaturalGradientAffineComponent",
        "FixedAffineComponent",
    }
    changed = True
    while changed:
        changed = False
        refs: Dict[str, List[int]] = {}
        for i, n in enumerate(nodes):
            out: set = set()
            if n.input is not None:
                _collect_node_refs(n.input, out)
            if n.kind == "dim-range":
                out.add(n.input_node)
            for name in out:
                refs.setdefault(name, []).append(i)
        comp_uses: Dict[str, int] = {}
        for n in nodes:
            if n.kind == "component":
                comp_uses[n.component] = comp_uses.get(n.component, 0) + 1
        for i, bn_node in enumerate(nodes):
            if bn_node.kind != "component" or bn_node.name in protected:
                continue
            comp = comps.get(bn_node.component)
            if comp is None or comp.type != "BatchNormComponent":
                continue
            # a component shared by several nodes can't be folded (the
            # rewrite would corrupt the other nodes' outputs)
            if comp_uses.get(bn_node.component, 0) != 1:
                continue
            dim = comp.attrs["Dim"]
            if comp.attrs.get("BlockDim", dim) != dim:
                continue
            users = refs.get(bn_node.name, [])
            if len(users) != 1:
                continue
            c_node = nodes[users[0]]
            if c_node.kind != "component" or c_node.input != ("node", bn_node.name):
                continue
            c_comp = comps[c_node.component]
            if c_comp.type not in linear_types:
                continue
            if comp_uses.get(c_node.component, 0) != 1:
                continue
            bn = _extract_params(comp)
            scale, offset = bn["scale"], bn["offset"]
            key = "Params" if c_comp.type == "LinearComponent" else "LinearParams"
            W = np.array(c_comp.attrs[key], dtype=np.float32)  # [out, in_tot]
            if W.shape[1] % dim != 0:
                continue
            extra_b = np.zeros(W.shape[0], np.float32)
            for blk in range(W.shape[1] // dim):
                sl = slice(blk * dim, (blk + 1) * dim)
                extra_b += W[:, sl] @ offset
                W[:, sl] = W[:, sl] * scale[None, :]
            attrs = dict(c_comp.attrs)
            attrs[key] = W
            old_b = attrs.get("BiasParams")
            if old_b is not None and getattr(old_b, "shape", (0,))[0]:
                attrs["BiasParams"] = old_b.astype(np.float32) + extra_b
            else:
                attrs["BiasParams"] = extra_b
            comps[c_node.component] = ComponentSpec(
                c_comp.name, c_comp.type, attrs
            )
            nodes[users[0]] = _dc.replace(c_node, input=bn_node.input)
            del nodes[i]
            comps.pop(bn_node.component, None)
            changed = True
            did_fold = True
            break
    if not did_fold:
        return spec
    return Nnet3Spec(
        nodes=nodes,
        components=comps,
        left_context=spec.left_context,
        right_context=spec.right_context,
        priors=spec.priors,
    )


def _component_time_offsets(comp: ComponentSpec) -> List[int]:
    if comp.type == "TdnnComponent":
        return [int(x) for x in comp.attrs["TimeOffsets"]]
    return [0]


# ---------------------------------------------------------------------------
# Dim inference for descriptors
# ---------------------------------------------------------------------------


def _desc_dim(desc: Descriptor, node_dims: Dict[str, int]) -> int:
    kind = desc[0]
    if kind == "node":
        return node_dims[desc[1]]
    if kind == "offset":
        return _desc_dim(desc[1], node_dims)
    if kind == "append":
        return sum(_desc_dim(s, node_dims) for s in desc[1])
    if kind in ("sum", "switch"):
        return _desc_dim(desc[1][0], node_dims)
    if kind == "scale":
        return _desc_dim(desc[2], node_dims)
    if kind == "const":
        return desc[2]
    if kind == "replace_index":
        return _desc_dim(desc[1], node_dims)
    if kind == "round":
        return _desc_dim(desc[1], node_dims)
    if kind in ("ifdefined",):
        return _desc_dim(desc[1], node_dims)
    if kind == "failover":
        return _desc_dim(desc[1], node_dims)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Component forward
# ---------------------------------------------------------------------------


def _extract_params(comp: ComponentSpec) -> Dict[str, np.ndarray]:
    """Inference-relevant parameters of a component, as numpy arrays."""
    t, a = comp.type, comp.attrs
    if t in ("AffineComponent", "NaturalGradientAffineComponent",
             "FixedAffineComponent"):
        return {"w": a["LinearParams"].T.copy(), "b": a["BiasParams"]}
    if t == "LinearComponent":
        out = {"w": a["Params"].T.copy()}
        if a.get("BiasParams") is not None and np.asarray(a["BiasParams"]).shape[0]:
            out["b"] = a["BiasParams"]
        return out
    if t == "TdnnComponent":
        out = {"w": a["LinearParams"].T.copy()}
        if a.get("BiasParams") is not None and a["BiasParams"].shape[0]:
            out["b"] = a["BiasParams"]
        return out
    if t == "BatchNormComponent":
        eps = a.get("Epsilon", 1.0e-3)
        target_rms = a.get("TargetRms", 1.0)
        mean = a["StatsMean"]
        var = a["StatsVar"]
        scale = target_rms / np.sqrt(var + eps)
        return {"scale": scale.astype(np.float32),
                "offset": (-mean * scale).astype(np.float32)}
    if t in ("PerElementScaleComponent",
             "NaturalGradientPerElementScaleComponent"):
        return {"scale": a["Params"]}
    if t == "PerElementOffsetComponent":
        return {"offset": a["Offsets"]}
    if t == "LstmNonlinearityComponent":
        return {"lstm_params": a["Params"]}  # [3, C]: w_ic, w_fc, w_oc
    if t == "FixedScaleComponent":
        return {"scale": a["Scales"]}
    if t == "FixedBiasComponent":
        return {"offset": a["Bias"]}
    if t in ("ConstantComponent", "ConstantFunctionComponent"):
        return {"const": a["Output"]}
    if t in ("RepeatedAffineComponent",
             "NaturalGradientRepeatedAffineComponent",
             "BlockAffineComponent"):
        return {"w": a["LinearParams"], "b": a["BiasParams"]}
    if t == "ScaleAndOffsetComponent":
        # cu::EnsureNonzero with the component's epsilon, applied once at
        # load (nnet-simple-component.cc ScaleAndOffsetComponent::
        # PropagateInternal; Epsilon() = 1e-4, nnet-simple-component.h:1921)
        eps = 1.0e-4
        s = np.asarray(a["Scales"], dtype=np.float32)
        s = np.where(np.abs(s) >= eps, s, np.where(s >= 0.0, eps, -eps))
        return {"scale": s.astype(np.float32), "offset": a["Offsets"]}
    if t == "CompositeComponent":
        out: Dict[str, np.ndarray] = {}
        for i, sub in enumerate(a["Components"]):
            for k, v in _extract_params(sub).items():
                out[f"sub{i}:{k}"] = v
        return out
    return {}


def _component_forward(
    comp: ComponentSpec, params: Dict[str, jnp.ndarray], x: jnp.ndarray,
    time_offsets: List[int],
) -> jnp.ndarray:
    """Forward one component. For TdnnComponent, ``x`` must cover
    [lo + min_off, hi + max_off) and the result covers [lo, hi)."""
    t = comp.type
    a = comp.attrs
    if t in ("AffineComponent", "NaturalGradientAffineComponent",
             "FixedAffineComponent"):
        return x @ params["w"] + params["b"]
    if t == "LinearComponent":
        y = x @ params["w"]
        return y + params["b"] if "b" in params else y
    if t == "TdnnComponent":
        offs = time_offsets
        span = offs[-1] - offs[0]
        T_out = x.shape[1] - span
        D = x.shape[-1]
        w = params["w"]
        # one matmul per time offset, summed — same result as the
        # concat-then-matmul formulation but the [B, T, len(offs)*D]
        # concat never materializes (slices fuse into the matmuls; the
        # concat was the TDNN-F forward's largest HBM stream)
        y = None
        for i, o in enumerate(offs):
            xi = x[:, (o - offs[0]) : (o - offs[0]) + T_out]
            yi = xi @ w[i * D : (i + 1) * D]
            y = yi if y is None else y + yi
        if "b" in params:
            y = y + params["b"]
        return y
    if t == "RectifiedLinearComponent":
        return jnp.maximum(x, 0.0)
    if t == "SigmoidComponent":
        return jax.nn.sigmoid(x)
    if t == "TanhComponent":
        return jnp.tanh(x)
    if t == "LogSoftmaxComponent":
        return jax.nn.log_softmax(x, axis=-1)
    if t == "SoftmaxComponent":
        return jax.nn.softmax(x, axis=-1)
    if t == "BatchNormComponent":
        dim = a["Dim"]
        block = a.get("BlockDim", dim)
        if block != dim:
            shape = x.shape
            xb = x.reshape(shape[:-1] + (dim // block, block))
            y = xb * params["scale"] + params["offset"]
            return y.reshape(shape)
        return x * params["scale"] + params["offset"]
    if t == "NormalizeComponent":
        block = a.get("BlockDim", a["InputDim"])
        target_rms = a.get("TargetRms", 1.0)
        add_log_stddev = a.get("AddLogStddev", False)
        shape = x.shape
        nblocks = shape[-1] // block
        xb = x.reshape(shape[:-1] + (nblocks, block))
        # scale so that each block has RMS target_rms
        sumsq = jnp.sum(xb * xb, axis=-1, keepdims=True)
        scale = target_rms * jnp.sqrt(block) * jax.lax.rsqrt(
            jnp.maximum(sumsq, 1.0e-20)
        )
        y = xb * scale
        if add_log_stddev:
            # Kaldi's NormalizePerRow appends exactly 0.5*log(sumsq/D);
            # target_rms cancels out of the appended column.
            log_stddev = 0.5 * jnp.log(
                jnp.maximum(sumsq, 1.0e-20) / block
            )
            y = jnp.concatenate([y, log_stddev], axis=-1)
            return y.reshape(shape[:-1] + (nblocks * (block + 1),))
        return y.reshape(shape)
    if t == "SumBlockComponent":
        in_dim, out_dim = a["InputDim"], a["OutputDim"]
        scale = a.get("Scale", 1.0)
        shape = x.shape
        xb = x.reshape(shape[:-1] + (in_dim // out_dim, out_dim))
        return scale * jnp.sum(xb, axis=-2)
    if t in ("PerElementScaleComponent",
             "NaturalGradientPerElementScaleComponent"):
        return x * params["scale"]
    if t == "PerElementOffsetComponent":
        return x + params["offset"]
    if t == "PnormComponent":
        # PnormComponent::Propagate = GroupPnorm(in, p=2.0) over
        # consecutive groups (nnet-simple-component.cc:54-60)
        in_dim, out_dim = a["InputDim"], a["OutputDim"]
        xb = x.reshape(x.shape[:-1] + (out_dim, in_dim // out_dim))
        return jnp.sqrt(jnp.maximum(jnp.sum(xb * xb, axis=-1), 0.0))
    if t == "ElementwiseProductComponent":
        # product over input_dim/output_dim consecutive blocks
        # (nnet-simple-component.cc:257-272)
        in_dim, out_dim = a["InputDim"], a["OutputDim"]
        xb = x.reshape(x.shape[:-1] + (in_dim // out_dim, out_dim))
        return jnp.prod(xb, axis=-2)
    if t == "SumGroupComponent":
        # sum over consecutive column ranges of the given sizes
        # (nnet-simple-component.cc:3544 SumColumnRanges)
        sizes = list(a["Sizes"])
        if len(set(sizes)) == 1:
            xb = x.reshape(x.shape[:-1] + (len(sizes), sizes[0]))
            return jnp.sum(xb, axis=-1)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        return jnp.stack(
            [
                jnp.sum(x[..., bounds[i] : bounds[i + 1]], axis=-1)
                for i in range(len(sizes))
            ],
            axis=-1,
        )
    if t == "PermuteComponent":
        # out column i = in column column_map[i]
        # (nnet-simple-component.cc:3990 CopyCols)
        return x[..., np.asarray(a["ColumnMap"], dtype=np.int32)]
    if t == "FixedScaleComponent":
        return x * params["scale"]
    if t == "FixedBiasComponent":
        return x + params["offset"]
    if t in ("ConstantComponent", "ConstantFunctionComponent"):
        # output is a learned constant row; input VALUES are ignored
        # (nnet-general-component.h:628, nnet-simple-component.h:1679)
        c = params["const"]
        return jnp.broadcast_to(c, x.shape[:-1] + (c.shape[0],))
    if t in ("RepeatedAffineComponent",
             "NaturalGradientRepeatedAffineComponent"):
        # shared per-block affine repeated num_repeats times
        w, b = params["w"], params["b"]  # w [od_r, id_r], b [R*od_r]
        reps = a["NumRepeats"]
        xb = x.reshape(x.shape[:-1] + (reps, w.shape[1]))
        y = jnp.einsum("...ri,oi->...ro", xb, w)
        y = y.reshape(x.shape[:-1] + (reps * w.shape[0],))
        return y + b
    if t == "BlockAffineComponent":
        # block-diagonal affine: block i uses rows [i*od_r, (i+1)*od_r)
        # of linear_params (nnet-simple-component.h:505)
        w, b = params["w"], params["b"]  # w [od, id_b], b [od]
        blocks = a["NumBlocks"]
        od_b = w.shape[0] // blocks
        wb = w.reshape(blocks, od_b, w.shape[1])
        xb = x.reshape(x.shape[:-1] + (blocks, w.shape[1]))
        y = jnp.einsum("...ri,roi->...ro", xb, wb)
        return y.reshape(x.shape[:-1] + (w.shape[0],)) + b
    if t == "ScaleAndOffsetComponent":
        # scales pre-bounded away from zero at load; block-repeated when
        # Dim is a multiple of the stored scale dim
        scale, offset = params["scale"], params["offset"]
        dim = a["Dim"]
        if dim != scale.shape[0]:
            xb = x.reshape(x.shape[:-1] + (dim // scale.shape[0],
                                           scale.shape[0]))
            return (xb * scale + offset).reshape(x.shape)
        return x * scale + offset
    if t == "DropoutComponent":
        # test-mode Propagate scales by (1 - proportion), NOT identity
        # (nnet-simple-component.cc:139-151)
        p = float(a.get("DropoutProportion", 0.0))
        return x if p == 0.0 else x * (1.0 - p)
    if t == "DropoutMaskComponent":
        # test mode: constant mask — 1.0 in continuous mode, else (1-p)
        # (nnet-general-component.cc:1435-1450)
        p = float(a.get("DropoutProportion", 0.0))
        fill = 1.0 if a.get("Continuous") else 1.0 - p
        return jnp.full(x.shape[:-1] + (a["OutputDim"],), fill, x.dtype)
    if t == "CompositeComponent":
        # sequential application of simple sub-components
        # (nnet-simple-component.h:1971; MaxRowsProcess is a memory knob,
        # not a semantic one)
        for i, sub in enumerate(a["Components"]):
            prefix = f"sub{i}:"
            sub_params = {
                k[len(prefix):]: v
                for k, v in params.items()
                if k.startswith(prefix)
            }
            x = _component_forward(sub, sub_params, x, [])
        return x
    if t == "LstmNonlinearityComponent":
        # cu-math.h ComputeLstmNonlinearity: input [.., 5C] =
        # (i_part, f_part, c_part, o_part, c_prev); params [3, C] =
        # (w_ic, w_fc, w_oc); output [.., 2C] = (c_t, m_t)
        w = params["lstm_params"]
        cell = w.shape[1]
        i_part = x[..., 0:cell]
        f_part = x[..., cell : 2 * cell]
        c_part = x[..., 2 * cell : 3 * cell]
        o_part = x[..., 3 * cell : 4 * cell]
        c_prev = x[..., 4 * cell : 5 * cell]
        i_t = jax.nn.sigmoid(i_part + w[0] * c_prev)
        f_t = jax.nn.sigmoid(f_part + w[1] * c_prev)
        c_t = f_t * c_prev + i_t * jnp.tanh(c_part)
        o_t = jax.nn.sigmoid(o_part + w[2] * c_t)
        m_t = o_t * jnp.tanh(c_t)
        return jnp.concatenate([c_t, m_t], axis=-1)
    if t in ("NoOpComponent", "GeneralDropoutComponent",
             "SpecAugmentTimeMaskComponent", "BackpropTruncationComponent",
             "ClipGradientComponent"):
        # identity at test time (GeneralDropout test-mode Propagate is a
        # plain copy, nnet-general-component.cc:1562-1574)
        return x
    raise NotImplementedError(f"component type {t} forward not implemented")


# ---------------------------------------------------------------------------
# Compiled model
# ---------------------------------------------------------------------------


@dataclass
class CompiledNnet3:
    """A planned nnet3 forward over fixed frame counts.

    Attributes:
      spec: the parsed model.
      num_out_frames: output frames per invocation (at the subsampled rate).
      subsampling: frame_subsampling_factor (3 for chain models).
      left_context / right_context: input frames needed beyond the output
        window (derived from the graph plan, like Kaldi's ComputeSimpleNnetContext).
      ranges: per-node planned [lo, hi) time ranges.
      params: name -> dict of jnp arrays.
    """

    spec: Nnet3Spec
    num_out_frames: int
    subsampling: int
    output_name: str
    ranges: Dict[str, Tuple[int, int]]
    order: List[NodeSpec]
    params: Dict[str, Dict[str, jnp.ndarray]]
    node_dims: Dict[str, int]
    ivector_period: int = 0  # 0 = single ivector at t=0
    # Recurrent mode (LSTM-style back-edges): evaluate one step per
    # `recurrence` frames via lax.scan, carrying the back-referenced nodes.
    recurrent: bool = False
    recurrence: int = 0  # max back-edge delay (frames)
    carried: Tuple[str, ...] = ()
    # Per carried node: how many scan steps of history the carry holds
    # (delay // rec_stride); aligned with `carried`.
    carry_depths: Tuple[int, ...] = ()
    step_input_range: Tuple[int, int] = (0, 0)
    # Scan stride of the stepwise evaluator: gcd(subsampling, |delays|).
    # Equal to the subsampling for every standard topology (chain LSTM:
    # delay -3 at sub 3; plain LSTM: -1 at sub 1); smaller when a delay
    # is not a multiple of the subsampling — then the scan runs
    # subsampling/rec_stride steps per output frame and emits every
    # (subsampling/rec_stride)-th step (Kaldi's looped compiler handles
    # any delay the same way by computing at the input frame rate,
    # decodable-simple-looped.cc). 0 = legacy alias for `subsampling`.
    rec_stride: int = 0

    @property
    def left_context(self) -> int:
        if self.recurrent:
            return -self.step_input_range[0]
        return -self.ranges["input"][0]

    @property
    def right_context(self) -> int:
        last_out_t = (self.num_out_frames - 1) * self.subsampling
        return self.ranges["input"][1] - 1 - last_out_t

    def cast(self, dtype) -> "CompiledNnet3":
        """Copy of this plan with floating-point parameters cast to
        ``dtype`` (e.g. jnp.bfloat16; matmuls then run bf16 with f32
        accumulation). Cast the input features to
        the same dtype and the output back to f32 at the call site."""
        import dataclasses

        cast_params = {
            name: {
                k: (v.astype(dtype) if jnp.issubdtype(v.dtype, jnp.floating)
                    else v)
                for k, v in comp.items()
            }
            for name, comp in self.params.items()
        }
        return dataclasses.replace(self, params=cast_params)

    @property
    def num_input_frames(self) -> int:
        lo, hi = self.ranges["input"]
        return hi - lo

    @property
    def output_dim(self) -> int:
        return self.node_dims[self.output_name]

    def forward(
        self,
        feats: jnp.ndarray,
        ivector: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """Run the planned forward.

        Args:
          feats: [B, num_input_frames, feat_dim]; feats[:, 0] is input time
            ranges['input'][0] (i.e. -left_context on the output clock).
          ivector: [B, ivec_dim] single ivector (used for every frame via
            ReplaceIndex/Round descriptors), or [B, n, ivec_dim] with
            ivector_period spacing starting at t=0.

        Returns:
          [B, num_out_frames, output_dim]
        """
        if feats.dtype == jnp.float32:
            # a default-precision f32 matmul may round its inputs to TF32
            with jax.default_matmul_precision("highest"):
                return self._forward(feats, ivector)
        return self._forward(feats, ivector)

    def _forward(
        self, feats: jnp.ndarray, ivector: Optional[jnp.ndarray]
    ) -> jnp.ndarray:
        if self.recurrent:
            return self._forward_recurrent(feats, ivector)

        values: Dict[str, jnp.ndarray] = {}
        origins: Dict[str, int] = {}

        def eval_desc(desc: Descriptor, lo: int, hi: int) -> jnp.ndarray:
            kind = desc[0]
            if kind == "node":
                name = desc[1]
                arr = values[name]
                org = origins[name]
                return arr[:, lo - org : hi - org]
            if kind == "offset":
                return eval_desc(desc[1], lo + desc[2], hi + desc[2])
            if kind == "append":
                return jnp.concatenate(
                    [eval_desc(s, lo, hi) for s in desc[1]], axis=-1
                )
            if kind == "sum":
                parts = [eval_desc(s, lo, hi) for s in desc[1]]
                out = parts[0]
                for p in parts[1:]:
                    out = out + p
                return out
            if kind == "switch":
                # Switch(d0..d_{n-1}): value at time t comes from d_{t mod n}
                # (nnet-descriptor.h SwitchingForwardingDescriptor; the mod
                # is normalized to [0, n) for negative t). All branches are
                # evaluated over the block and selected per frame — the
                # static-shape interleave XLA fuses into a select.
                subs = desc[1]
                n = len(subs)
                parts = [eval_desc(s, lo, hi) for s in subs]
                sel = jnp.asarray(np.arange(lo, hi) % n)
                out = parts[0]
                for i in range(1, n):
                    out = jnp.where((sel == i)[None, :, None], parts[i], out)
                return out
            if kind == "scale":
                return desc[1] * eval_desc(desc[2], lo, hi)
            if kind == "const":
                b = feats.shape[0]
                return jnp.full((b, hi - lo, desc[2]), desc[1], dtype=feats.dtype)
            if kind == "replace_index":
                one = eval_desc(desc[1], desc[3], desc[3] + 1)
                return jnp.broadcast_to(
                    one, (one.shape[0], hi - lo, one.shape[2])
                )
            if kind == "round":
                m = desc[2]
                ts = np.arange(lo, hi)
                src = (ts // m) * m
                sub_lo = int(src.min())
                sub_hi = int(src.max()) + 1
                arr = eval_desc(desc[1], sub_lo, sub_hi)
                return arr[:, src - sub_lo]
            if kind == "ifdefined":
                # Clamped evaluation: frames outside the computable range of
                # the sub-descriptor read as zeros.
                sub = desc[1]
                sub_lo, sub_hi = _computable_range(sub)
                ov_lo, ov_hi = max(lo, sub_lo), min(hi, sub_hi)
                dim = _desc_dim(sub, self.node_dims)
                b = feats.shape[0]
                if ov_hi <= ov_lo:
                    return jnp.zeros((b, hi - lo, dim), dtype=feats.dtype)
                mid = eval_desc(sub, ov_lo, ov_hi)
                pads = ((0, 0), (ov_lo - lo, hi - ov_hi), (0, 0))
                return jnp.pad(mid, pads)
            if kind == "failover":
                sub_lo, sub_hi = _computable_range(desc[1])
                if sub_lo <= lo and hi <= sub_hi:
                    return eval_desc(desc[1], lo, hi)
                return eval_desc(desc[2], lo, hi)
            raise ValueError(kind)

        def _computable_range(desc: Descriptor) -> Tuple[int, int]:
            kind = desc[0]
            if kind == "node":
                return self.ranges[desc[1]]
            if kind == "offset":
                lo, hi = _computable_range(desc[1])
                return lo - desc[2], hi - desc[2]
            if kind in ("append", "sum", "switch"):
                los, his = zip(*(_computable_range(s) for s in desc[1]))
                return max(los), min(his)
            if kind == "scale":
                return _computable_range(desc[2])
            if kind in ("const",):
                return (-(10**9), 10**9)
            if kind == "replace_index":
                return (-(10**9), 10**9)
            if kind == "round":
                lo, hi = _computable_range(desc[1])
                m = desc[2]
                return lo, hi  # conservative
            if kind in ("ifdefined",):
                return (-(10**9), 10**9)
            if kind == "failover":
                lo2, hi2 = _computable_range(desc[2])
                return lo2, hi2
            raise ValueError(kind)

        # Inputs
        in_lo, in_hi = self.ranges["input"]
        if feats.shape[1] != in_hi - in_lo:
            raise ValueError(
                f"feats must have {in_hi - in_lo} frames "
                f"(got {feats.shape[1]}): left_context={self.left_context}, "
                f"chunk={self.num_out_frames}x{self.subsampling}, "
                f"right_context={self.right_context}"
            )
        values["input"] = feats
        origins["input"] = in_lo

        if "ivector" in self.ranges:
            if ivector is None:
                raise ValueError("model requires an ivector input")
            iv_lo, iv_hi = self.ranges["ivector"]
            if ivector.ndim == 2:
                ivector = ivector[:, None, :]
            period = self.ivector_period if self.ivector_period > 0 else max(
                iv_hi - iv_lo, 1
            )
            # Materialize ivector per needed frame by repeating each stored
            # ivector over its period window.
            n_have = ivector.shape[1]
            ts = np.arange(iv_lo, iv_hi)
            idx = np.clip(np.floor_divide(np.maximum(ts, 0), period), 0, n_have - 1)
            values["ivector"] = ivector[:, idx]
            origins["ivector"] = iv_lo

        # Evaluate nodes in topological (config) order
        for node in self.order:
            if node.kind == "input":
                continue
            lo, hi = self.ranges[node.name]
            if node.kind == "component":
                comp = self.spec.components[node.component]
                offs = _component_time_offsets(comp)
                x = eval_desc(node.input, lo + offs[0], hi + offs[-1])
                y = _component_forward(
                    comp, self.params.get(node.component, {}), x, offs
                )
            elif node.kind == "output":
                y = eval_desc(node.input, lo, hi)
            elif node.kind == "dim-range":
                src = values[node.input_node]
                src_lo = origins[node.input_node]
                y = src[:, lo - src_lo : hi - src_lo,
                        node.dim_offset : node.dim_offset + node.dim]
            else:  # pragma: no cover
                raise ValueError(node.kind)
            values[node.name] = y
            origins[node.name] = lo

        out = values[self.output_name]
        # Subsample: output frames at t = 0, sub, 2*sub, ...
        out_lo = origins[self.output_name]
        idx = np.arange(self.num_out_frames) * self.subsampling - out_lo
        return out[:, idx]


    def init_state(self, batch: int, dtype=jnp.float32) -> Dict[str, jnp.ndarray]:
        """Zero recurrence state (Kaldi zero-initializes recurrences).

        Each entry is [batch, depth, dim]: a ring of the node's last
        `depth` step values (depth = delay // subsampling, usually 1)."""
        return {
            name: jnp.zeros((batch, depth, self.node_dims[name]), dtype=dtype)
            for name, depth in zip(self.carried, self.carry_depths)
        }

    def forward_with_state(
        self,
        feats: jnp.ndarray,
        state: Dict[str, jnp.ndarray],
        ivector: Optional[jnp.ndarray] = None,
    ):
        """Recurrent forward continuing from ``state`` (e.g. the previous
        streaming chunk); returns (output, new_state)."""
        return self._forward_recurrent(feats, ivector, carry0=state,
                                       return_state=True)

    def _forward_recurrent(
        self,
        feats: jnp.ndarray,
        ivector: Optional[jnp.ndarray] = None,
        carry0: Optional[Dict[str, jnp.ndarray]] = None,
        return_state: bool = False,
    ):
        """Stepwise evaluation for recurrent graphs: one lax.scan step
        per rec_stride frames (= the subsampling for standard
        topologies), carrying a ring of each back-referenced node's last
        `depth` step values. Delays that are not a multiple of the
        subsampling drop the stride to gcd(subsampling, delays): the
        scan then runs subsampling/stride steps per output frame and
        only every (subsampling/stride)-th step's output is emitted —
        Kaldi's looped compiler computes at the input frame rate the
        same way (decodable-simple-looped.cc). Kaldi zero-initializes
        recurrences; so does init_state."""
        s = self.subsampling
        g = self.rec_stride or s
        spo = s // g  # scan steps per output frame
        lo, hi = self.step_input_range
        win = hi - lo
        B = feats.shape[0]
        carried = set(self.carried)
        depths = dict(zip(self.carried, self.carry_depths))

        extra = s - g if spo > 1 else 0
        expected = (self.num_out_frames - 1) * s + win + extra
        if feats.shape[1] != expected:
            raise ValueError(
                f"feats must have {expected} frames (got {feats.shape[1]})"
            )

        ivec_row = None
        if "ivector" in self.ranges:
            if ivector is None:
                raise ValueError("model requires an ivector input")
            if ivector.ndim == 3:
                ivector = ivector[:, 0]
            ivec_row = ivector  # [B, D]: whole-utterance mode

        def step(carry, i):
            start = i * g
            window = jax.lax.dynamic_slice_in_dim(feats, start, win, axis=1)
            values: Dict[str, jnp.ndarray] = {"input": window}
            origins: Dict[str, int] = {"input": lo}
            if ivec_row is not None and "ivector" in self.ranges:
                iv_lo, iv_hi = self.ranges["ivector"]
                values["ivector"] = jnp.broadcast_to(
                    ivec_row[:, None, :],
                    (B, iv_hi - iv_lo, ivec_row.shape[-1]),
                )
                origins["ivector"] = iv_lo

            def eval_desc(desc: Descriptor, lo_t: int, hi_t: int) -> jnp.ndarray:
                kind = desc[0]
                if kind == "node":
                    name = desc[1]
                    if name not in values and name in carried:
                        depth = depths[name]
                        j = -lo_t // g  # steps back
                        if (
                            hi_t != lo_t + 1
                            or lo_t >= 0
                            or (-lo_t) % g != 0
                            or j > depth
                        ):
                            raise NotImplementedError(
                                f"back-reference to {name!r} at times "
                                f"[{lo_t},{hi_t}) (carry holds the last "
                                f"{depth} step(s) at stride {g})"
                            )
                        return carry[name][:, depth - j][:, None, :]
                    arr = values[name]
                    org = origins[name]
                    return arr[:, lo_t - org : hi_t - org]
                if kind == "offset":
                    return eval_desc(desc[1], lo_t + desc[2], hi_t + desc[2])
                if kind == "append":
                    return jnp.concatenate(
                        [eval_desc(s, lo_t, hi_t) for s in desc[1]], axis=-1
                    )
                if kind == "sum":
                    parts = [eval_desc(s, lo_t, hi_t) for s in desc[1]]
                    out = parts[0]
                    for p in parts[1:]:
                        out = out + p
                    return out
                if kind == "switch":
                    # absolute input-clock time of this step is i * stride
                    subs = desc[1]
                    n = len(subs)
                    parts = [eval_desc(s2, lo_t, hi_t) for s2 in subs]
                    sel = (i * g + jnp.arange(lo_t, hi_t)) % n
                    out = parts[0]
                    for k2 in range(1, n):
                        out = jnp.where(
                            (sel == k2)[None, :, None], parts[k2], out
                        )
                    return out
                if kind == "scale":
                    return desc[1] * eval_desc(desc[2], lo_t, hi_t)
                if kind == "const":
                    return jnp.full(
                        (B, hi_t - lo_t, desc[2]), desc[1], dtype=feats.dtype
                    )
                if kind == "replace_index":
                    one = eval_desc(desc[1], desc[3], desc[3] + 1)
                    return jnp.broadcast_to(
                        one, (one.shape[0], hi_t - lo_t, one.shape[2])
                    )
                if kind == "ifdefined":
                    refs: set = set()
                    _collect_node_refs(desc[1], refs)
                    if refs & carried:
                        # carried recurrences are always "defined" (zeros at
                        # step 0 reproduce the undefined-frame semantics)
                        return eval_desc(desc[1], lo_t, hi_t)
                    return eval_desc(desc[1], lo_t, hi_t)
                raise NotImplementedError(
                    f"descriptor {kind!r} inside a recurrent graph"
                )

            for node in self.order:
                if node.kind == "input":
                    continue
                n_lo, n_hi = self.ranges[node.name]
                if node.kind == "component":
                    comp = self.spec.components[node.component]
                    offs = _component_time_offsets(comp)
                    x = eval_desc(node.input, n_lo + offs[0], n_hi + offs[-1])
                    y = _component_forward(
                        comp, self.params.get(node.component, {}), x, offs
                    )
                elif node.kind == "output":
                    y = eval_desc(node.input, n_lo, n_hi)
                elif node.kind == "dim-range":
                    src = values[node.input_node]
                    src_lo = origins[node.input_node]
                    y = src[:, n_lo - src_lo : n_hi - src_lo,
                            node.dim_offset : node.dim_offset + node.dim]
                else:  # pragma: no cover
                    raise ValueError(node.kind)
                values[node.name] = y
                origins[node.name] = n_lo

            new_carry = {
                name: jnp.concatenate(
                    [carry[name][:, 1:],
                     values[name][:, 0 - origins[name]][:, None]],
                    axis=1,
                )
                for name in carried
            }
            out_org = origins[self.output_name]
            return new_carry, values[self.output_name][:, 0 - out_org]

        if carry0 is None:
            carry0 = self.init_state(B, feats.dtype)
        # chunked mode (return_state) runs the trailing sub-steps past
        # the last output frame so the carried state lands on the next
        # chunk's step grid; whole-utterance mode stops at the last
        # output
        num_steps = (
            self.num_out_frames * spo
            if (return_state and spo > 1)
            else (self.num_out_frames - 1) * spo + 1
        )
        final_carry, outs = jax.lax.scan(
            step, carry0, jnp.arange(num_steps, dtype=jnp.int32)
        )
        if spo > 1:
            outs = outs[::spo]  # emit output-grid steps only
        out = jnp.swapaxes(outs, 0, 1)  # [B, N, out_dim]
        if return_state:
            return out, final_carry
        return out


def compile_nnet3(
    spec: Nnet3Spec,
    num_out_frames: int,
    subsampling: int = 3,
    output_name: str = "output",
    ivector_period: int = 0,
    collapse: bool = True,
) -> CompiledNnet3:
    """Plan per-node time ranges for a fixed output window.

    The plan requests output times {0, sub, ..., sub*(N-1)} and propagates
    required ranges backwards through descriptors and TdnnComponent time
    offsets (Kaldi: nnet-compile.cc ComputeComputationGraph equivalent for
    the simple-looped case). collapse=True folds batchnorms into adjacent
    linear components first (CollapseModel semantics)."""
    if collapse:
        spec = collapse_batchnorms(spec, protected=(output_name,))
    node_by_name = {n.name: n for n in spec.nodes}
    if output_name not in node_by_name:
        raise KeyError(f"no output node {output_name!r}")

    # Back-edges (descriptor references to nodes defined LATER in config
    # order) mark LSTM-style recurrences: collect them with their time
    # offsets and switch to the stepwise evaluator.
    seen_names = set()
    back_refs: Dict[str, set] = {}  # carried node -> set of offsets
    for node in spec.nodes:
        if node.kind in ("component", "output") and node.input is not None:
            refs: set = set()
            _collect_back_refs(node.input, refs, 0)
            for name, off in refs:
                if name not in seen_names and name != node.name:
                    back_refs.setdefault(name, set()).add(off)
        seen_names.add(node.name)

    recurrent = bool(back_refs)
    recurrence = 0
    carry_depths: Dict[str, int] = {}
    rec_stride = subsampling
    if recurrent:
        import math

        offsets = {off for offs in back_refs.values() for off in offs}
        bad = [o for o in offsets if o >= 0]
        if bad:
            raise NotImplementedError(
                f"recurrent offsets {sorted(offsets)} — each delay must "
                f"be negative (a non-negative back-edge references the "
                f"future); got {sorted(bad)}"
            )
        # delays that are not a multiple of the subsampling drop the
        # scan stride to the gcd: the evaluator then runs
        # subsampling/rec_stride steps per output frame (see
        # CompiledNnet3.rec_stride)
        for o in offsets:
            rec_stride = math.gcd(rec_stride, -o)
        recurrence = max(-o for o in offsets)
        for name, offs in back_refs.items():
            carry_depths[name] = max(-o for o in offs) // rec_stride

    # Node dims (forward pass over config order)
    node_dims: Dict[str, int] = {}
    for node in spec.nodes:
        if node.kind == "input":
            node_dims[node.name] = node.dim
        elif node.kind == "component":
            node_dims[node.name] = spec.components[node.component].output_dim
        elif node.kind == "dim-range":
            node_dims[node.name] = node.dim
        elif node.kind == "output":
            node_dims[node.name] = _desc_dim(node.input, node_dims)

    # Backward range planning (reverse config order = reverse topological).
    # Recurrent graphs plan a SINGLE step (output time 0); back-references
    # into carried nodes are excluded (they read the previous step's carry).
    ranges: Dict[str, Tuple[int, int]] = {}
    if recurrent:
        last_t = 0
        for name in back_refs:
            ranges[name] = (0, 1)  # carried nodes computed at the step time
    else:
        last_t = (num_out_frames - 1) * subsampling
    _accumulate(ranges, output_name, 0, last_t + 1)

    def _plan_desc(desc, lo, hi, later_names):
        if not recurrent or not later_names:
            _desc_ranges(desc, lo, hi, ranges)
            return
        # strip contributions through back-edges
        pruned = _prune_back_edges(desc, later_names)
        if pruned is not None:
            _desc_ranges(pruned, lo, hi, ranges)

    names_after: Dict[str, set] = {}
    if recurrent:
        suffix: set = set()
        for node in reversed(spec.nodes):
            names_after[node.name] = set(suffix)
            suffix.add(node.name)

    for node in reversed(spec.nodes):
        if node.name not in ranges or node.kind == "input":
            continue
        lo, hi = ranges[node.name]
        later = names_after.get(node.name, set()) if recurrent else set()
        if node.kind == "component":
            comp = spec.components[node.component]
            offs = _component_time_offsets(comp)
            _plan_desc(node.input, lo + offs[0], hi + offs[-1], later)
        elif node.kind == "output":
            _plan_desc(node.input, lo, hi, later)
        elif node.kind == "dim-range":
            _accumulate(ranges, node.input_node, lo, hi)

    if recurrent:
        for name in back_refs:
            if ranges.get(name) != (0, 1):
                raise NotImplementedError(
                    f"carried node {name!r} needed over {ranges.get(name)} "
                    "within one step (only the step time is supported)"
                )

    # Parameters
    params = {
        name: {
            k: jnp.asarray(v) for k, v in _extract_params(comp).items()
        }
        for name, comp in spec.components.items()
    }

    order = [n for n in spec.nodes if n.name in ranges or n.kind == "input"]
    # Drop nodes never requested (e.g. unused xent branch heads)
    order = [n for n in order if n.name in ranges or n.kind == "input"]

    step_input_range = (0, 0)
    if recurrent:
        step_input_range = ranges["input"]
        lo, hi = step_input_range
        # AcousticModel gathers the GLOBAL window from this range. With
        # rec_stride < subsampling the chunked evaluator also runs the
        # trailing sub-steps between the last output frame and the next
        # chunk's step grid (subsampling - rec_stride extra frames of
        # lookahead) so carried state lands exactly where the next chunk
        # resumes.
        extra = subsampling - rec_stride if rec_stride < subsampling else 0
        ranges = dict(ranges)
        ranges["input"] = (
            lo, (num_out_frames - 1) * subsampling + hi + extra
        )

    return CompiledNnet3(
        spec=spec,
        num_out_frames=num_out_frames,
        subsampling=subsampling,
        output_name=output_name,
        ranges=ranges,
        order=order,
        params=params,
        node_dims=node_dims,
        ivector_period=ivector_period,
        recurrent=recurrent,
        recurrence=recurrence,
        carried=tuple(sorted(back_refs)),
        carry_depths=tuple(carry_depths[n] for n in sorted(back_refs)),
        step_input_range=step_input_range,
        rec_stride=rec_stride,
    )
