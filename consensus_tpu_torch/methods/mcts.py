"""Monte-Carlo tree search decoder (UCB1 + rollouts) over a trunk session
(PyTorch port of ``consensus_tpu/methods/mcts.py``).

Reference: ``src/methods/mcts.py``.  Search semantics preserved:

* per emitted token, run ``num_simulations`` of select -> expand/evaluate ->
  backpropagate, then advance the root to its most-visited child and detach
  the parent;
* selection walks UCB1 ``value + C*sqrt(ln(N_parent)/N)`` with unvisited
  children preferred;
* expansion samples up to ``expansion_sample_width`` distinct next tokens
  and pops one untried token per simulation; a child's immediate reward is
  the egalitarian ``min`` over agents of the new token's logprob under the
  agent-conditioned policy;
* non-terminal children also get a rollout -- ``rollout_depth`` tokens
  continued from the reference policy -- valued as the ``min`` over agents
  of the rolled-out statement's total logprob, combined as ``reward =
  immediate + gamma * rollout``;
* failures score ``-100.0``.

As in the JAX package, the reference's rollout evaluation (which raises a
``NameError`` on a stale f-string variable and aborts every run) is
evaluated correctly here.

The whole statement drives ONE trunk session (``backends/session.py``):
each expansion is one ``propose_suffixes`` call (the k proposals AND their
per-agent scores come out of one forward over the shared trunk) and each
rollout with its evaluation is one scored-rollout call.  The rolled-out
statement's total agent logprob telescopes as trunk-sum + node-path-sum +
rollout-sum by the chain rule.

Wave search (``mcts_wave_size``): simulations run in WAVES of K leaf
selections under UCB1 with *virtual loss* -- each selection transiently
counts an extra visit whose reward sits ``virtual_loss`` below the node's
current mean, so later selections in the same wave diverge -- then ALL
expansion proposals ride ONE ``propose_suffixes`` call and ALL fresh
rollouts ONE ``rollout_many`` call, the virtual losses are reverted
exactly, and every reward backpropagates in selection order.
``mcts_wave_size=1`` is the sequential search (same session calls, same
salt sequence).

``search_stats`` reports per statement the session's device dispatches,
waves, selections, virtual-loss collisions and the per-step root visit
log.  Obs families, as the reference's: ``mcts_device_dispatches_total`` /
``mcts_statements_total``, ``mcts_wave_selections_total``, the
``mcts_wave_width`` histogram and ``mcts_virtual_loss_collisions_total``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from consensus_tpu_torch.backends.session import (
    ScoredCandidate,
    SearchSpec,
    open_token_search,
)
from consensus_tpu_torch.methods.base import BaseGenerator
from consensus_tpu_torch.methods.beam_search import BIAS_AGAINST_TOKENS, EOS_TOKENS
from consensus_tpu_torch.methods.brushup import brushup_statement_ending
from consensus_tpu_torch.methods.prompts import agent_prompt, reference_prompt
from consensus_tpu_torch.obs import DEFAULT_COUNT_BUCKETS, get_registry

FAILURE_REWARD = -100.0


class Node:
    __slots__ = (
        "cand",
        "parent",
        "children",
        "visits",
        "total_reward",
        "immediate_reward",
        "untried",
        "is_terminal",
    )

    def __init__(
        self,
        cand: Optional[ScoredCandidate],
        parent: Optional["Node"],
        eos_tokens: frozenset = EOS_TOKENS,
    ):
        self.cand = cand
        self.parent = parent
        self.children: Dict[str, Node] = {}
        self.visits = 0
        self.total_reward = 0.0
        self.immediate_reward = 0.0
        self.untried: Optional[List[ScoredCandidate]] = None
        self.is_terminal = cand.token in eos_tokens if cand is not None else False

    @property
    def value(self) -> float:
        return self.total_reward / self.visits if self.visits else 0.0

    def suffix(self) -> List[ScoredCandidate]:
        """Token path from the session trunk (the current root) to here."""
        path: List[ScoredCandidate] = []
        node = self
        while node.parent is not None:
            path.append(node.cand)
            node = node.parent
        return path[::-1]

    def path_agent_sums(self, n_agents: int) -> List[float]:
        path = self.suffix()
        return [
            sum(c.agent_logprobs[a] for c in path) for a in range(n_agents)
        ]


class MCTSGenerator(BaseGenerator):
    method_name = "mcts"

    def generate_statement(self, issue: str, agent_opinions: Dict[str, str]) -> str:
        cfg = self.config
        clock = self.budget_clock
        self._num_simulations_full = int(cfg.get("num_simulations", 50))
        # Brownout shrinks the per-token simulation budget; fewer sims =
        # noisier visit counts, same estimator.
        self._num_simulations = clock.scale_int(self._num_simulations_full)
        self._c = float(cfg.get("exploration_constant", 1.414))
        max_tokens = int(cfg.get("max_tokens", 100))
        self._width = int(cfg.get("expansion_sample_width", 5))
        # Timing mode (experiment timing_pin_budget): no node is terminal.
        self._eos_tokens = (
            frozenset() if cfg.get("pin_budget") else EOS_TOKENS
        )
        self._rollout_depth = int(cfg.get("rollout_depth", 10))
        self._gamma = float(cfg.get("gamma", 0.99))
        self._wave_size = max(1, int(cfg.get("mcts_wave_size", 1)))
        self._virtual_loss = float(cfg.get("virtual_loss", 1.0))
        temperature = float(cfg.get("temperature", 1.0))

        agents = list(agent_opinions.items())
        if not agents:
            return ""
        if clock.expired():
            return self._degrade()
        self._n_agents = len(agents)

        system, user = reference_prompt(issue, agent_opinions, variant="mcts")
        self._session = open_token_search(
            self.backend,
            SearchSpec(
                ref_system=system,
                ref_user=user,
                agent_prompts=tuple(
                    agent_prompt(issue, opinion, variant="mcts")
                    for _, opinion in agents
                ),
                n_slots=1,  # trunk session: root state lives on device
                k=self._width,
                temperature=temperature,
                seed=self.seed,
                sample=True,
                bias_against_tokens=BIAS_AGAINST_TOKENS,
                max_steps=max_tokens,
                failure_logprob=FAILURE_REWARD,
                # Speculative rollout verification: n-gram drafts verified
                # in one parallel forward per round; the token streams of
                # the sequential rollouts by rejection (fused sessions
                # only; the fallback session accepts and ignores it).
                speculative=bool(cfg.get("speculative_rollouts", False)),
                spec_draft_len=int(
                    cfg.get("spec_draft_len", self._rollout_depth)
                ),
                matrix_scoring=bool(cfg.get("matrix_scoring", True)),
            ),
        )
        self._salt = 0

        registry = get_registry()
        label = getattr(self.backend, "name", "unknown")
        self._obs_wave_width = registry.histogram(
            "mcts_wave_width",
            "Realized MCTS wave widths (leaf selections per wave)",
            ("backend",),
            DEFAULT_COUNT_BUCKETS,
        ).labels(label)
        self._obs_selections = registry.counter(
            "mcts_wave_selections_total",
            "MCTS leaf selections across all waves",
            ("backend",),
        ).labels(label)
        self._obs_collisions = registry.counter(
            "mcts_virtual_loss_collisions_total",
            "Duplicate-leaf wave selections that yielded no fresh child",
            ("backend",),
        ).labels(label)
        obs_dispatches = registry.counter(
            "mcts_device_dispatches_total",
            "Session device dispatches issued by MCTS statements",
            ("backend",),
        ).labels(label)
        obs_statements = registry.counter(
            "mcts_statements_total",
            "MCTS statements generated",
            ("backend",),
        ).labels(label)
        #: Per-statement stats surfaced for tests and chip_smoke.py.
        self.search_stats: Dict[str, object] = {
            "device_dispatches": 0,
            "waves": 0,
            "selections": 0,
            "collisions": 0,
            "wave_size": self._wave_size,
            "visit_log": [],
        }

        dispatches_before = getattr(self._session, "dispatch_count", 0)
        self._expired_exit = False
        try:
            statement = self._search(max_tokens)
        finally:
            dispatches = (
                getattr(self._session, "dispatch_count", 0) - dispatches_before
            )
            self._session.close()
        self.search_stats["device_dispatches"] = dispatches
        obs_dispatches.inc(dispatches)
        obs_statements.inc()
        if self._expired_exit:
            # The search committed what it could; skip brushup and return
            # the latest checkpoint tagged degraded.
            return self._degrade()
        if self._num_simulations < self._num_simulations_full:
            self._mark_scaled(
                num_simulations=self._num_simulations,
                num_simulations_planned=self._num_simulations_full,
            )
        self.pre_brushup_statement = statement
        if cfg.get("brushup", False):
            if clock.expired():
                spent = dict(self.anytime.budget_spent) if self.anytime else {}
                spent["brushup_skipped"] = True
                self._checkpoint(statement, checkpoint="pre-brushup", **spent)
                return self._degrade()
            statement = brushup_statement_ending(
                self.backend, statement, seed=self.seed
            )
        return statement

    def _search(self, max_tokens: int) -> str:
        statement = ""
        #: Per-agent total logprob of the trunk tokens emitted so far — the
        #: telescoped prefix of every rollout evaluation.
        trunk_sums = [0.0] * self._n_agents
        root = Node(None, None)
        root.untried = list(self._session.propose()[0])

        clock = self.budget_clock
        for step in range(max_tokens):
            sims_done = 0
            while sims_done < self._num_simulations:
                width = min(self._wave_size, self._num_simulations - sims_done)
                self._run_wave(root, width, trunk_sums)
                sims_done += width
                if not clock.bounded:
                    continue
                # Anytime checkpoint (bounded clocks only — skips the
                # per-wave argmax on the hot unbounded path): the search's
                # commit-if-stopped-now statement is the trunk plus the
                # currently most-visited child.  On expiry the partial
                # visit counts still pick a token — commit it, then exit
                # degraded after this step.
                tentative = max(
                    root.children.values(), key=lambda n: n.visits,
                ) if root.children else None
                if tentative is not None:
                    self._checkpoint(
                        (statement + tentative.cand.token).strip(),
                        welfare=float(tentative.value),
                        checkpoint=f"token {step + 1}, {sims_done} sims",
                        tokens_committed=step,
                        sims_done=sims_done,
                        sims_planned=self._num_simulations,
                        sims_planned_full=self._num_simulations_full,
                    )
                if clock.expired():
                    self._expired_exit = True
                    break

            self.search_stats["visit_log"].append(
                sorted(
                    (ch.cand.token, ch.visits)
                    for ch in root.children.values()
                )
            )
            best = self._most_visited_child(root)
            if best is None:
                break
            statement += best.cand.token
            # Advance the trunk: the chosen child becomes the root; its
            # subtree survives with suffixes implicitly rebased (suffix()
            # walks only to the new root).
            trunk_sums = [
                s + lp for s, lp in zip(trunk_sums, best.cand.agent_logprobs)
            ]
            chosen = best.cand
            best.parent = None  # detach (reference :1005-1006)
            root = best
            if self._expired_exit:
                break
            if root.is_terminal or step == max_tokens - 1:
                break
            new_proposals = self._session.advance_and_propose([0], [chosen])[0]
            if root.untried is None:
                root.untried = list(new_proposals)

        return statement.strip()

    # -- phases --------------------------------------------------------------

    def _run_wave(
        self, root: Node, width: int, trunk_sums: List[float]
    ) -> None:
        """One wave = ``width`` simulations sharing two batched device calls.

        Select ``width`` leaves under UCB1, applying a virtual loss along
        each selected path so later selections diverge; batch every
        never-expanded leaf into ONE ``propose_suffixes`` call and every
        fresh non-terminal child into ONE ``rollout_many`` call; revert the
        virtual losses exactly; backpropagate all rewards in selection
        order.  ``width == 1`` degenerates to the pre-wave sequential
        search: one selection, at most one singleton proposal call and one
        singleton rollout (same salt sequence), zero net virtual loss.
        """
        selections: List[Node] = []
        #: (node, pre-application total_reward) in application order — the
        #: revert restores saved totals in REVERSE, so it is exact even
        #: where float add/subtract would not round-trip.
        vl_records: List[Tuple[Node, float]] = []
        for _ in range(width):
            leaf = self._select(root)
            selections.append(leaf)
            if width == 1:
                continue  # nothing to diverge from — keep stats untouched
            # Virtual loss: count one transient visit at (mean - penalty)
            # along the whole path.  Mean-relative, so it biases selection
            # away regardless of the (unbounded) reward scale.
            node: Optional[Node] = leaf
            while node is not None:
                vl_records.append((node, node.total_reward))
                node.total_reward += node.value - self._virtual_loss
                node.visits += 1
                node = node.parent
        self._obs_wave_width.observe(width)
        self._obs_selections.inc(width)

        # ONE batched proposal call for all never-expanded selected leaves.
        need: List[Node] = []
        need_ids = set()
        for leaf in selections:
            if (
                not leaf.is_terminal
                and leaf.untried is None
                and id(leaf) not in need_ids
            ):
                need_ids.add(id(leaf))
                need.append(leaf)
        if need:
            self._salt += 1
            proposals = self._session.propose_suffixes(
                [leaf.suffix() for leaf in need], self._salt
            )
            for leaf, props in zip(need, proposals):
                leaf.untried = list(props)

        # Resolve each selection to its backprop target.  Fresh
        # non-terminal children queue for the batched rollout; a duplicate
        # selection that finds its leaf terminal/exhausted is a virtual-loss
        # collision (the wave spent a simulation re-proving a dead end).
        resolved: List[Tuple[Node, Optional[float]]] = []
        pending: List[Tuple[Node, float]] = []
        leaf_seen = set()
        collisions = 0
        for leaf in selections:
            duplicate = id(leaf) in leaf_seen
            leaf_seen.add(id(leaf))
            if leaf.is_terminal or not leaf.untried:
                if duplicate:
                    collisions += 1
                resolved.append((leaf, leaf.immediate_reward))
                continue
            candidate = leaf.untried.pop(0)
            child = Node(candidate, leaf, self._eos_tokens)
            leaf.children[candidate.token] = child
            # Egalitarian immediate reward: min over agents of the new
            # token's logprob — delivered by the proposal itself
            # (reference :249-329).
            immediate = min(candidate.agent_logprobs)
            if child.is_terminal:
                child.immediate_reward = immediate
                resolved.append((child, immediate))
            else:
                pending.append((child, immediate))
                resolved.append((child, None))

        # ONE batched rollout call for all fresh non-terminal children.
        # Min over agents of the rolled-out statement's TOTAL logprob
        # (reference :470-651): trunk + node path + rollout sums telescope.
        if pending:
            salts = []
            for _ in pending:
                self._salt += 1
                salts.append(self._salt)
            rollouts = self._session.rollout_many(
                [child.suffix() for child, _ in pending],
                self._rollout_depth,
                salts,
            )
            for (child, immediate), (_ids, _text, rollout_sums, ok) in zip(
                pending, rollouts
            ):
                if not ok:
                    rollout_value = FAILURE_REWARD
                else:
                    path_sums = child.path_agent_sums(self._n_agents)
                    totals = [
                        t + p + r
                        for t, p, r in zip(
                            trunk_sums, path_sums, rollout_sums
                        )
                    ]
                    rollout_value = min(totals) if totals else FAILURE_REWARD
                child.immediate_reward = immediate + self._gamma * rollout_value

        for node, saved_total in reversed(vl_records):
            node.visits -= 1
            node.total_reward = saved_total
        for target, reward in resolved:
            if reward is None:
                reward = target.immediate_reward
            self._backpropagate(target, reward)
        if collisions:
            self._obs_collisions.inc(collisions)
        self.search_stats["waves"] += 1
        self.search_stats["selections"] += width
        self.search_stats["collisions"] += collisions

    def _select(self, node: Node) -> Node:
        """UCB1 walk until a node with unexpanded candidates or a terminal."""
        while not node.is_terminal:
            if node.untried is None or node.untried:
                return node
            if not node.children:
                return node
            log_n = math.log(max(node.visits, 1))
            node = max(
                node.children.values(),
                key=lambda ch: (
                    math.inf
                    if ch.visits == 0
                    else ch.value + self._c * math.sqrt(log_n / ch.visits)
                ),
            )
        return node

    @staticmethod
    def _backpropagate(node: Optional[Node], reward: float) -> None:
        while node is not None:
            node.visits += 1
            node.total_reward += reward
            node = node.parent

    @staticmethod
    def _most_visited_child(root: Node) -> Optional[Node]:
        if not root.children:
            return None
        return max(root.children.values(), key=lambda ch: ch.visits)
