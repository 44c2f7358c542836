"""AODV-light route overlay: metadata JSON rewriting without payload access.

The port's copy of the JAX package's ``security/route.py``;
tests/test_torch_security.py holds it to the reference's golden strings.

Python port of T3Route (include/security_route_helper.hpp), string-surgery
compatible with the reference (naive set-or-insert before the last '}',
same comma/spacing rules) so that metas round-tripped between the two
implementations stay mutually parseable.
"""
from __future__ import annotations

from . import policy as P


def get_uint_best_effort(js: str, flat_key: str, nested_key: str) -> int:
    v = P.meta_find_uint(js, flat_key)
    if v is not None:
        return v
    pos = P.meta_find_key(js, "route")
    if pos >= 0:
        v = P.meta_find_uint(js[pos:], nested_key)
        if v is not None:
            return v
    return 0


def get_str_best_effort(js: str, flat_key: str, nested_key: str) -> str:
    s = P.meta_find_str(js, flat_key)
    if s is not None:
        return s
    pos = P.meta_find_key(js, "route")
    if pos >= 0:
        s = P.meta_find_str(js[pos:], nested_key)
        if s is not None:
            return s
    return ""


def get_phase_best_effort(js: str) -> int:
    return min(get_uint_best_effort(js, "route_phase", "phase"), 2)


# --- naive set/insert (security_route_helper.hpp:41-88) ---------------------


def _insert(js: str, ins: str) -> str:
    last = js.rfind("}")
    if last < 0:
        if js and not js.endswith("\n"):
            js += "\n"
        return js + "{ " + ins + " }"
    k = last
    while k > 0 and js[k - 1] in " \t\r\n":
        k -= 1
    need_comma = k > 0 and js[k - 1] != "{"
    return js[:last] + (", " if need_comma else "") + ins + " " + js[last:]


def set_or_insert_uint(js: str, key: str, val: int) -> str:
    p = P.meta_find_key(js, key)
    if p >= 0:
        p = js.find(":", p)
        if p >= 0:
            p += 1
            while p < len(js) and js[p] in " \t":
                p += 1
            a = p
            while p < len(js) and js[p].isdigit():
                p += 1
            return js[:a] + str(val) + js[p:]
    return _insert(js, f'"{key}": {val}')


def set_or_insert_str(js: str, key: str, val: str) -> str:
    p = P.meta_find_key(js, key)
    if p >= 0:
        p = js.find(":", p)
        if p >= 0:
            q1 = js.find('"', p)
            if q1 >= 0:
                q2 = js.find('"', q1 + 1)
                if q2 >= 0:
                    return js[:q1 + 1] + val + js[q2:]
    return _insert(js, f'"{key}": "{val}"')


def set_or_insert_bool(js: str, key: str, val: bool) -> str:
    p = P.meta_find_key(js, key)
    if p >= 0:
        p = js.find(":", p)
        if p >= 0:
            p += 1
            while p < len(js) and js[p] in " \t":
                p += 1
            a = p
            while p < len(js) and (js[p].isalpha() or js[p] == "_"):
                p += 1
            return js[:a] + ("true" if val else "false") + js[p:]
    return _insert(js, f'"{key}": {"true" if val else "false"}')


# --- route overlay API (security_route_helper.hpp:103-163) ------------------


def prepare_redirect_meta_phase(meta_in: str, via: str, next_domain: str,
                                ttl_after: int, hops_inc: int,
                                phase: int) -> tuple[bool, str]:
    """Returns (applied, meta_out)."""
    if ttl_after == 0:
        return False, meta_in
    phase = min(phase, 2)
    out = meta_in
    hops0 = get_uint_best_effort(meta_in, "route_hops", "hops")
    out = set_or_insert_uint(out, "route_hops", hops0 + hops_inc)
    out = set_or_insert_uint(out, "route_ttl", ttl_after)
    if via:
        out = set_or_insert_str(out, "route_via", via)
    if next_domain:
        out = set_or_insert_str(out, "route_next", next_domain)
    out = set_or_insert_uint(out, "route_phase", phase)
    return True, out


def prepare_redirect_meta_prep(meta_in: str, via: str,
                               ttl_after: int) -> tuple[bool, str]:
    """Round 1: PREP (phase=1, no route_next)."""
    return prepare_redirect_meta_phase(meta_in, via, "", ttl_after, 1, 1)


def prepare_redirect_meta_accept(meta_in: str, via: str, next_domain: str,
                                 ttl_after: int) -> tuple[bool, str]:
    """Round 2: ACCEPT (phase=2 + next)."""
    return prepare_redirect_meta_phase(meta_in, via, next_domain, ttl_after, 1, 2)


def mark_accepted(js: str) -> str:
    return set_or_insert_bool(js, "route_accepted", True)


def mark_sandbox(js: str, reason: str = "overlap_no_accept") -> str:
    js = set_or_insert_bool(js, "route_sandbox", True)
    return set_or_insert_str(js, "route_reason", reason)
