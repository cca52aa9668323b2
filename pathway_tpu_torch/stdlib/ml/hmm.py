"""Hidden Markov model decoding (the port of ``pathway_tpu/stdlib/ml/hmm.py``;
reference: stdlib/ml/hmm.py, 214 LoC).

`create_hmm_reducer(graph)` builds a stateful reducer that runs log-space
Viterbi incrementally over a stream of observations: per observation it
advances the log-probability vector along the transition graph, records
backpointers, optionally trims the frontier to `beam_size`, and emits the
decoded most-likely state PATH (a tuple, windowed to `num_results_kept`) —
the same surface as the reference (nx.DiGraph with `calc_emission_log_ppb`
node attributes, `log_transition_ppb` edge attributes and
`graph.graph["start_nodes"]`).

A dependency-free dict spec is also accepted:
    {"states": {name: emission_log_prob_fn}, "transitions":
     {(src, dst): log_ppb}, "start": [names]}
and the round-2 probability-space form
    (graph={state: {next: ppb}}, emission_probabilities=..., ...)
keeps working.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np

from ...internals import reducers as R


class _Spec:
    """Normalized HMM description (from nx.DiGraph or plain dicts)."""

    def __init__(self, states, emission_fns, transitions, start):
        self.states = list(states)
        self.idx = {s: i for i, s in enumerate(self.states)}
        self.emission_fns = emission_fns  # state -> fn(obs) -> log ppb
        # successor adjacency: src idx -> [(dst idx, log ppb)]
        self.succ: dict[int, list[tuple[int, float]]] = {
            self.idx[s]: [] for s in self.states
        }
        for (src, dst), lp in transitions.items():
            self.succ[self.idx[src]].append((self.idx[dst], lp))
        self.start = [self.idx[s] for s in start]


def _normalize_graph(graph) -> _Spec:
    if isinstance(graph, dict):
        return _Spec(
            graph["states"].keys(), dict(graph["states"]),
            dict(graph["transitions"]), list(graph["start"]),
        )
    # networkx DiGraph with the reference's attribute conventions
    states = list(graph.nodes())
    emission = {s: graph.nodes[s]["calc_emission_log_ppb"] for s in states}
    transitions = {
        (u, v): d["log_transition_ppb"] for u, v, d in graph.edges(data=True)
    }
    start = list(graph.graph.get("start_nodes", states))
    return _Spec(states, emission, transitions, start)


def _legacy_spec(graph, emission_probabilities, initial_distribution) -> _Spec:
    states = list(graph.keys())

    def _emis_fn(state):
        def fn(obs, _s=state):
            if emission_probabilities is None:
                p = 1.0 if obs == _s else 1e-9
            elif callable(emission_probabilities):
                p = emission_probabilities(obs, _s)
            else:
                p = emission_probabilities.get(_s, {}).get(obs, 1e-9)
            return float(np.log(max(p, 1e-300)))

        return fn

    return _Spec(
        states, {s: _emis_fn(s) for s in states},
        {
            (src, dst): float(np.log(max(p, 1e-300)))
            for src, row in graph.items() for dst, p in row.items()
        },
        [
            s for s in states
            if initial_distribution is None
            or initial_distribution.get(s, 0) > 0
        ] or states,
    )


def create_hmm_reducer(
    graph, beam_size: int | None = None, num_results_kept: int | None = None,
    emission_probabilities=None, initial_distribution=None,
):
    """Returns a reducer decoding the most-likely state path (a tuple)."""
    if isinstance(graph, dict) and "states" not in graph:
        spec = _legacy_spec(graph, emission_probabilities,
                            initial_distribution)
    else:
        spec = _normalize_graph(graph)

    n = len(spec.states)
    beam = beam_size if beam_size is not None else n + 1

    def init(obs):
        ppb = np.full(n, -np.inf)
        for i in spec.start:
            ppb[i] = spec.emission_fns[spec.states[i]](obs)
        return {
            "ppb": ppb,
            "frontier": list(spec.start),
            "back": deque(),
            "path": (spec.states[int(ppb.argmax())],),
        }

    def advance(state, obs):
        reachable: dict[int, tuple[float, int]] = {}
        for src in state["frontier"]:
            base = state["ppb"][src]
            for dst, lp in spec.succ[src]:
                cand = (base + lp, src)
                if dst not in reachable or cand > reachable[dst]:
                    reachable[dst] = cand
        if not reachable:
            # dead end: the frontier has no outgoing transitions (the
            # reference asserts here too) — decoding cannot continue
            raise RuntimeError(
                "HMM dead end: no transitions leave the current states "
                f"({[spec.states[i] for i in state['frontier']]})"
            )
        new_ppb = np.full(n, -np.inf)
        backptr = np.zeros(n, dtype=int)
        frontier = []
        for dst, (cost, src) in reachable.items():
            new_ppb[dst] = cost + spec.emission_fns[spec.states[dst]](obs)
            backptr[dst] = src
            frontier.append(dst)
        # beam trim: only the beam_size best frontier states survive
        if len(frontier) > beam:
            costs = new_ppb[frontier]
            keep = np.argpartition(costs, len(frontier) - beam)[-beam:]
            frontier = [frontier[i] for i in keep]
        back = state["back"]
        back.append(backptr)
        if num_results_kept is not None and len(back) >= num_results_kept:
            back.popleft()
        path_idx = [int(new_ppb.argmax())]
        for bp in reversed(back):
            path_idx.append(int(bp[path_idx[-1]]))
        return {
            "ppb": new_ppb,
            "frontier": frontier,
            "back": back,
            "path": tuple(spec.states[i] for i in reversed(path_idx)),
        }

    def combine(state, obs):
        return init(obs) if state is None else advance(state, obs)

    def finish(state):
        return state["path"] if state is not None else ()

    def reducer(expr):
        return R.stateful_single(combine, expr, finish=finish)

    return reducer


def most_likely_state(result) -> Any:
    """Last element of the decoded path (current most-likely state)."""
    if not result:
        return None
    if isinstance(result, tuple):
        return result[-1]
    if isinstance(result, dict):  # legacy round-2 distribution form
        return max(result.items(), key=lambda kv: kv[1])[0]
    return result
