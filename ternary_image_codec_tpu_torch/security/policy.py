"""Metadata-only security/approval policy engine.

The port's copy of the JAX package's ``security/policy.py``;
tests/test_torch_security.py holds it to the reference's golden decisions.

Python port of the reference's T3Security (include/security_policy.hpp),
behavior-matched including its quirks (naive JSON-lite scanning, the
visual-whitelist `break` that skips later coexist entries, uint32/uint64
wraparound in hashes/seeds, prep-cache window semantics).  This layer never
touches payload bytes; containers call `approve_*` with metadata only.

Decision pipeline (include/security_policy.hpp:415-607):
  0) allowed_roots / max_depth guards -> SANDBOX
  1) memberships (+ legacy self)      -> INTERNAL
  2) internal_allow                   -> INTERNAL
  3) coexist_allow (+ visual wl)      -> COEXIST_ACCEPTED
  4) AODV-light neighbor query        -> COEXIST_ACCEPTED
  5) TTL/hops-bounded redirect with the two-round overlap protocol
     (round 1 PREP via ternary rotor, round 2 ACCEPT or SANDBOX)
  6) SANDBOX
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Tuple

MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# JSON-lite helpers (naive substring scanning, security_policy.hpp:27-99)
# ---------------------------------------------------------------------------


def meta_find_key(js: str, key: str) -> int:
    """Position of '"key"' or -1."""
    return js.find('"' + key + '"')


def meta_find_str(js: str, key: str) -> Optional[str]:
    p = meta_find_key(js, key)
    if p < 0:
        return None
    p = js.find(":", p)
    if p < 0:
        return None
    p = js.find('"', p)
    if p < 0:
        return None
    e = js.find('"', p + 1)
    if e < 0:
        return None
    return js[p + 1:e]


def meta_find_uint(js: str, key: str) -> Optional[int]:
    p = meta_find_key(js, key)
    if p < 0:
        return None
    p = js.find(":", p)
    if p < 0:
        return None
    p += 1
    while p < len(js) and js[p] in " \t":
        p += 1
    v, any_ = 0, False
    while p < len(js) and js[p].isdigit():
        any_ = True
        v = v * 10 + int(js[p])
        p += 1
    return v if any_ else None


def fnv1a64(data) -> int:
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & MASK64
    return h


def domain_depth(d: str) -> int:
    if not d:
        return 0
    return 1 + d.count("/")


def domain_root_of(d: str) -> str:
    p = d.find("/")
    return d if p < 0 else d[:p + 1]


class ProxClass(enum.IntEnum):
    Local = 0
    Near = 1
    Far = 2
    Unknown = 255


def prox_from_str(s: str) -> ProxClass:
    return {"local": ProxClass.Local, "near": ProxClass.Near,
            "far": ProxClass.Far}.get(s, ProxClass.Unknown)


# ---------------------------------------------------------------------------
# BuildTag
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BuildTag:
    domain: str = ""
    build_hash: str = ""
    version: int = 0
    type_hash: int = 0
    pclass: ProxClass = ProxClass.Unknown
    radius_m: int = 0
    route_ttl: int = 0
    route_hops: int = 0
    route_phase: int = 0
    route_origin: str = ""


def extract_build_from_meta(meta: str) -> BuildTag:
    """security_policy.hpp:112-172 (incl. nested route{} overriding flats)."""
    b = BuildTag()
    s = meta_find_str(meta, "domain")
    if s is not None:
        b.domain = s
    s = meta_find_str(meta, "build_hash")
    if s is not None:
        b.build_hash = s
    s = meta_find_str(meta, "type_hash")
    if s is not None:
        if s.startswith("fnv64:"):
            val = 0
            for c in s[6:]:
                val = (val << 4) & MASK64
                if "0" <= c <= "9":
                    val |= ord(c) - ord("0")
                elif "a" <= c <= "f":
                    val |= 10 + ord(c) - ord("a")
                elif "A" <= c <= "F":
                    val |= 10 + ord(c) - ord("A")
            b.type_hash = val
        else:
            b.type_hash = fnv1a64(s)
    v = meta_find_uint(meta, "version")
    if v is not None:
        b.version = v
    s = meta_find_str(meta, "class")
    if s is not None:
        b.pclass = prox_from_str(s)
    v = meta_find_uint(meta, "radius_m")
    if v is not None:
        b.radius_m = v & 0xFFFFFFFF
    v = meta_find_uint(meta, "route_ttl")
    if v is not None:
        b.route_ttl = min(v, 255)
    v = meta_find_uint(meta, "route_hops")
    if v is not None:
        b.route_hops = min(v, 255)
    v = meta_find_uint(meta, "route_phase")
    if v is not None:
        b.route_phase = min(v, 2)
    s = meta_find_str(meta, "origin")
    if s is not None:
        b.route_origin = s
    pos = meta_find_key(meta, "route")
    if pos >= 0:
        sub = meta[pos:]
        v = meta_find_uint(sub, "ttl")
        if v is not None:
            b.route_ttl = min(v, 255)
        v = meta_find_uint(sub, "hops")
        if v is not None:
            b.route_hops = min(v, 255)
        v = meta_find_uint(sub, "phase")
        if v is not None:
            b.route_phase = min(v, 2)
        s = meta_find_str(sub, "origin")
        if s is not None:
            b.route_origin = s
    if b.type_hash == 0:
        b.type_hash = (fnv1a64(b.domain)
                       ^ ((b.version * 0x9E3779B185EBCA87) & MASK64)) & MASK64
    return b


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


class Decision(enum.IntEnum):
    INTERNAL = 0
    COEXIST_ACCEPTED = 1
    UNKNOWN_SANDBOX = 2
    REJECT = 3


@dataclasses.dataclass
class Membership:
    domain_prefix: str = ""
    hash_prefix_hex: str = ""
    local_radius_m: int = 0

    def __post_init__(self):
        # reference field is uint32_t (security_policy.hpp:186) -- values
        # past 2^32 TRUNCATE there, which changes overlap-candidate
        # filtering; match the wrap (found by the fuzz differential)
        self.local_radius_m &= 0xFFFFFFFF


@dataclasses.dataclass
class Allow:
    domain_prefix: str = ""
    hash_prefix_hex: str = ""


@dataclasses.dataclass
class Coexist:
    domain_prefix: str = ""
    hash_prefix_hex: str = ""
    radius_max_m: int = 0
    max_class: ProxClass = ProxClass.Near

    def __post_init__(self):
        self.radius_max_m &= 0xFFFFFFFF   # uint32_t, hpp:204


@dataclasses.dataclass
class Redirect:
    from_domain_prefix: str = ""
    to_domain_prefix: str = ""
    ttl_min: int = 1
    ttl_max: int = 3

    def __post_init__(self):
        self.ttl_min &= 0xFF              # uint8_t, hpp:220
        self.ttl_max &= 0xFF


@dataclasses.dataclass
class Prep:
    requester_domain: str
    prepared_target: str
    window: int = 1


@dataclasses.dataclass
class Policy:
    memberships: List[Membership] = dataclasses.field(default_factory=list)
    self_: Membership = dataclasses.field(default_factory=Membership)
    internal_allow: List[Allow] = dataclasses.field(default_factory=list)
    coexist_allow: List[Coexist] = dataclasses.field(default_factory=list)
    allowed_roots: List[str] = dataclasses.field(default_factory=list)
    max_depth: int = 3
    visual_whitelist_domains: List[str] = dataclasses.field(default_factory=list)
    redirects: List[Redirect] = dataclasses.field(default_factory=list)
    ttl_global_max: int = 3
    hops_global_max: int = 6
    enable_overlap_redirect: bool = True
    rotor_tick: int = 0
    prepared_cache: List[Prep] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # uint8_t fields in the reference struct (hpp:211, 225-226)
        self.max_depth &= 0xFF
        self.ttl_global_max &= 0xFF
        self.hops_global_max &= 0xFF
        self.rotor_tick &= MASK64         # uint64_t rotor.tick
    # callbacks
    overlap_prepare_suggest: Optional[Callable[[str, str, BuildTag], Optional[str]]] = None
    overlap_second_accept: Optional[Callable[[str, str, BuildTag], bool]] = None
    on_unknown_sandbox: Optional[Callable[[BuildTag, str], None]] = None
    query_neighbor_accept: Optional[Callable[[BuildTag], bool]] = None

    @staticmethod
    def make_default() -> "Policy":
        return Policy()


@dataclasses.dataclass
class NextHop:
    should_redirect: bool = False
    target_domain: str = ""
    ttl_after: int = 0


@dataclasses.dataclass
class DecisionEx:
    decision: Decision = Decision.UNKNOWN_SANDBOX
    tag: BuildTag = dataclasses.field(default_factory=BuildTag)
    next: NextHop = dataclasses.field(default_factory=NextHop)


# ---------------------------------------------------------------------------
# matching helpers (security_policy.hpp:280-331)
# ---------------------------------------------------------------------------


def match_prefix_hex(hexs: str, prefix: str) -> bool:
    if not prefix:
        return True
    return len(hexs) >= len(prefix) and hexs.startswith(prefix)


def _match_membership(m: Membership, t: BuildTag) -> bool:
    return t.domain.startswith(m.domain_prefix) and match_prefix_hex(t.build_hash, m.hash_prefix_hex)


def _match_allow(a: Allow, t: BuildTag) -> bool:
    return t.domain.startswith(a.domain_prefix) and match_prefix_hex(t.build_hash, a.hash_prefix_hex)


def _match_coexist(c: Coexist, t: BuildTag) -> bool:
    if not t.domain.startswith(c.domain_prefix):
        return False
    if not match_prefix_hex(t.build_hash, c.hash_prefix_hex):
        return False
    if t.radius_m > c.radius_max_m:
        return False
    if t.pclass != ProxClass.Unknown and t.pclass > c.max_class:
        return False
    return True


def tri_wave(tick: int) -> int:
    return (-1, 0, 1)[tick % 3]


def bal_from_prox(pc: ProxClass) -> int:
    return {ProxClass.Local: -1, ProxClass.Near: 0, ProxClass.Far: 1}.get(pc, 0)


def unb_from_bal_sum(a: int, b: int) -> int:
    return max(-1, min(1, a + b)) + 1


def seed_from(t: BuildTag) -> int:
    return (fnv1a64(t.domain)
            ^ ((t.version * 0x9E3779B185EBCA87) & MASK64)
            ^ t.radius_m) & 0xFFFFFFFF


@dataclasses.dataclass
class Cand:
    domain_prefix: str
    is_member: bool = False
    radius_max: int = 0
    depth: int = 0


def _collect_known_domains(pol: Policy) -> List[Cand]:
    out = [Cand(m.domain_prefix, True, m.local_radius_m, domain_depth(m.domain_prefix))
           for m in pol.memberships]
    if pol.self_.domain_prefix:
        out.append(Cand(pol.self_.domain_prefix, True, pol.self_.local_radius_m,
                        domain_depth(pol.self_.domain_prefix)))
    out += [Cand(c.domain_prefix, False, c.radius_max_m, domain_depth(c.domain_prefix))
            for c in pol.coexist_allow]
    return out


def overlap_bottom_candidates(pol: Policy, tag: BuildTag) -> List[Cand]:
    """Deepest known domains sharing the tag's root (security_policy
    .hpp:357-391)."""
    known = _collect_known_domains(pol)
    overlap = [c for c in known
               if domain_root_of(c.domain_prefix) == domain_root_of(tag.domain)]
    if not overlap:
        return []
    maxd = max(c.depth for c in overlap)
    return [c for c in overlap
            if c.depth == maxd and (c.is_member or tag.radius_m <= c.radius_max)]


def _find_prep(pol: Policy, requester: str) -> Optional[Prep]:
    for p in pol.prepared_cache:
        if p.requester_domain == requester:
            return p
    return None


def _tick_and_drop_preps(pol: Policy) -> None:
    for p in pol.prepared_cache:
        if p.window > 0:
            p.window -= 1
    pol.prepared_cache = [p for p in pol.prepared_cache
                          if not (p.window == 0 and not p.prepared_target)]


# ---------------------------------------------------------------------------
# decision core (security_policy.hpp:415-607)
# ---------------------------------------------------------------------------


def decide_ex(pol: Policy, meta: str) -> DecisionEx:
    _tick_and_drop_preps(pol)
    R = DecisionEx()
    R.tag = extract_build_from_meta(meta)
    t = R.tag

    def sandbox():
        if pol.on_unknown_sandbox:
            pol.on_unknown_sandbox(t, meta)
        return R

    # 0) root/depth guards
    if pol.allowed_roots and not any(t.domain.startswith(r) for r in pol.allowed_roots):
        return sandbox()
    if pol.max_depth > 0 and domain_depth(t.domain) > pol.max_depth:
        return sandbox()

    # 1) INTERNAL: memberships + legacy self
    internal = any(_match_membership(m, t) for m in pol.memberships)
    if not internal and pol.self_.domain_prefix and \
            t.domain.startswith(pol.self_.domain_prefix) and \
            match_prefix_hex(t.build_hash, pol.self_.hash_prefix_hex):
        internal = True
    if internal:
        R.decision = Decision.INTERNAL
        return R

    # 2) INTERNAL via explicit allow
    if any(_match_allow(a, t) for a in pol.internal_allow):
        R.decision = Decision.INTERNAL
        return R

    # 3) COEXIST (+visual whitelist); NB reference quirk: a whitelist miss on
    # the FIRST matching coexist entry breaks out of the whole loop
    # (security_policy.hpp:478-497), so later entries are never considered.
    for c in pol.coexist_allow:
        if _match_coexist(c, t):
            if pol.visual_whitelist_domains:
                if not any(t.domain.startswith(v)
                           for v in pol.visual_whitelist_domains):
                    break
            R.decision = Decision.COEXIST_ACCEPTED
            return R

    # 4) AODV-light neighbor query
    if pol.query_neighbor_accept and pol.query_neighbor_accept(t):
        R.decision = Decision.COEXIST_ACCEPTED
        return R

    # 5) bounded redirect + two-round overlap protocol
    ttl_cap = min(t.route_ttl, pol.ttl_global_max)
    if ttl_cap > 0 and t.route_hops < pol.hops_global_max:
        cands = overlap_bottom_candidates(pol, t) if pol.enable_overlap_redirect else []
        if cands:
            if t.route_phase < 1:
                # ROUND 1: PREP -- rotor picks the neighbor
                seed = seed_from(t)
                w = tri_wave(pol.rotor_tick)
                r = bal_from_prox(t.pclass)
                idx = (seed + unb_from_bal_sum(w, r)) % len(cands)
                neighbor = cands[idx]
                if pol.overlap_prepare_suggest:
                    target = pol.overlap_prepare_suggest(
                        t.domain, neighbor.domain_prefix, t)
                    if target:
                        p = _find_prep(pol, t.domain)
                        if p:
                            p.prepared_target = target
                            p.window = 1
                        else:
                            pol.prepared_cache.append(Prep(t.domain, target, 1))
                pol.rotor_tick += 1
                return R  # phase advance handled by route helper
            # ROUND 2: ACCEPT if a preparation exists
            p = _find_prep(pol, t.domain)
            if p is not None:
                ok = True
                if pol.overlap_second_accept:
                    ok = pol.overlap_second_accept(t.domain, p.prepared_target, t)
                if ok and p.prepared_target:
                    R.next = NextHop(True, p.prepared_target, ttl_cap - 1)
                    p.prepared_target = ""
                    p.window = 0
                    pol.rotor_tick += 1
                    return R
                p.prepared_target = ""
                p.window = 0
                return sandbox()
            return sandbox()

        # no overlap -> fallback redirects
        for r in pol.redirects:
            if t.domain.startswith(r.from_domain_prefix) and \
                    r.ttl_min <= ttl_cap <= r.ttl_max:
                R.next = NextHop(True, r.to_domain_prefix, ttl_cap - 1)
                return R
        for m in pol.memberships:
            if not m.domain_prefix.startswith(t.domain):
                R.next = NextHop(True, m.domain_prefix, ttl_cap - 1)
                return R
        for c in pol.coexist_allow:
            R.next = NextHop(True, c.domain_prefix, ttl_cap - 1)
            return R

    # 6) sandbox
    return sandbox()


def decide(pol: Policy, meta: str) -> Decision:
    return decide_ex(pol, meta).decision


# approve adapters (security_policy.hpp:616-629) -----------------------------


def t3p_approve_with_policy(pol: Policy) -> Callable[[str], bool]:
    def approve(meta_json: str) -> bool:
        d = decide(pol, meta_json)
        return d in (Decision.INTERNAL, Decision.COEXIST_ACCEPTED)
    return approve


def t3v_approve_with_policy(pol: Policy) -> Callable[[str], bool]:
    return t3p_approve_with_policy(pol)
