"""The port's copy of security/policy.py and security/route.py against the
compiled C++ reference's golden decisions (tests/golden/golden_security.txt
and the randomized sweep of tests/golden/golden_security_fuzz.txt, driven
by tests/security_fuzz.py's checked-in scenarios), and the approval gate
in front of the port's containers."""
import os

import numpy as np
import pytest

import ternary_image_codec_tpu.security as jsecurity
from ternary_image_codec_tpu.security import policy as JP
from ternary_image_codec_tpu_torch.config import SubwordMode
from ternary_image_codec_tpu_torch.io import containers as C
from ternary_image_codec_tpu_torch.security import policy as P
from ternary_image_codec_tpu_torch.security import route as R

HERE = os.path.dirname(__file__)
GOLD = os.path.join(HERE, "golden")
ROUTE_KEYS = ("prep", "accept", "marked", "sandbox", "empty_prep",
              "phase_get", "nested_get")
DNAMES = {P.Decision.INTERNAL: "INTERNAL",
          P.Decision.COEXIST_ACCEPTED: "COEXIST",
          P.Decision.UNKNOWN_SANDBOX: "SANDBOX", P.Decision.REJECT: "REJECT"}


def golden_lines():
    with open(os.path.join(GOLD, "golden_security.txt")) as f:
        return f.read().splitlines()


def make_pol():
    pol = P.Policy()
    pol.memberships = [P.Membership("acme/video/", "ab"), P.Membership("acme/")]
    pol.internal_allow = [P.Allow("partner/tools/", "ff")]
    pol.coexist_allow = [P.Coexist("ext/cam/", "", 500, P.ProxClass.Near),
                         P.Coexist("ext/depot/", "", 100, P.ProxClass.Local)]
    pol.allowed_roots = ["acme/", "ext/", "partner/", "other/"]
    pol.max_depth = 3
    pol.overlap_prepare_suggest = lambda req, nb, tag: nb + "prepared"
    return pol


def fmt(label, pol, meta):
    rx = P.decide_ex(pol, meta)
    return (f"{label}|{DNAMES[rx.decision]}|redir={int(rx.next.should_redirect)}"
            f"|target={rx.next.target_domain}|ttl_after={rx.next.ttl_after}"
            f"|tick={pol.rotor_tick}")


def test_decisions_match_cpp_reference():
    """The golden file's hand-picked cases, in order: one policy carries
    its rotor and prep cache from case to case, as in the C++ probe."""
    got = []
    pol = make_pol()
    for label, meta in (
            ("member", '{"domain":"acme/video/enc","build_hash":"abcd"}'),
            ("member2", '{"domain":"acme/video/enc","build_hash":"zz"}'),
            ("allow", '{"domain":"partner/tools/x","build_hash":"ff12"}'),
            ("coexist", '{"domain":"ext/cam/7","radius_m":400,"class":"near"}'),
            ("coexist_far",
             '{"domain":"ext/cam/7","radius_m":600,"class":"near"}'),
            ("badroot", '{"domain":"evil/x"}'),
            ("toodeep", '{"domain":"acme/a/b/c","build_hash":"zz"}'),
            ("overlap_prep", '{"domain":"ext/other/z","radius_m":50,'
             '"route_ttl":3,"route_phase":0}'),
            ("overlap_accept", '{"domain":"ext/other/z","radius_m":50,'
             '"route_ttl":3,"route_phase":1}'),
            ("overlap_reaccept", '{"domain":"ext/other/z","radius_m":50,'
             '"route_ttl":3,"route_phase":1}'),
            ("overlap_noprep", '{"domain":"ext/other/q","radius_m":40,'
             '"route_ttl":2,"route_phase":1}'),
            ("overlap_radius_fallback", '{"domain":"ext/depot/z",'
             '"radius_m":900,"route_ttl":3,"route_phase":0}')):
        got.append(fmt(label, pol, meta))
    pol2 = P.Policy()
    pol2.memberships = [P.Membership("acme/")]
    pol2.coexist_allow = [P.Coexist("ext/cam/", "", 500, P.ProxClass.Near)]
    pol2.redirects = [P.Redirect("other/", "acme/hub/", 1, 3)]
    got.append(fmt("fallback_redirect", pol2,
                   '{"domain":"other/x","route_ttl":2}'))
    pol3 = P.Policy()
    pol3.memberships = [P.Membership("acme/")]
    got.append(fmt("fallback_member", pol3,
                   '{"domain":"other/x","route_ttl":2}'))
    pol4 = P.Policy()
    pol4.coexist_allow = [P.Coexist("ext/", "", 500, P.ProxClass.Near),
                          P.Coexist("ext/cam/", "", 500, P.ProxClass.Near)]
    pol4.visual_whitelist_domains = ["ext/screen/"]
    got.append(fmt("visual_break", pol4, '{"domain":"ext/cam/1","radius_m":1}'))
    pol5 = P.Policy()
    pol5.memberships = [P.Membership("acme/")]
    pol5.ttl_global_max = 2
    got.append(fmt("ttl_clamp", pol5, '{"domain":"other/x","route_ttl":9}'))
    want = [ln for ln in golden_lines()
            if "|" in ln and ln.split("|")[0] not in ROUTE_KEYS]
    assert got == want


def test_route_helper_matches_cpp():
    golden = {ln.split("|", 1)[0]: ln.split("|", 1)[1]
              for ln in golden_lines() if ln.split("|")[0] in ROUTE_KEYS}
    m = '{"domain":"ext/depot/z", "route_ttl": 3, "route_hops": 1}'
    ok, o = R.prepare_redirect_meta_prep(m, "acme/hub", 2)
    assert ok and o == golden["prep"]
    ok, o2 = R.prepare_redirect_meta_accept(o, "acme/hub", "ext/depot/", 1)
    assert ok and o2 == golden["accept"]
    o2m = R.mark_accepted(o2)
    assert o2m == golden["marked"]
    assert R.mark_sandbox("{}") == golden["sandbox"]
    _ok, o5 = R.prepare_redirect_meta_prep("", "", 1)
    assert o5 == golden["empty_prep"]
    assert str(R.get_phase_best_effort(o2m)) == golden["phase_get"]
    nested = '{"route": {"ttl": 2, "hops": 4, "phase": 1}}'
    got = (f"{R.get_uint_best_effort(nested, 'route_ttl', 'ttl')}"
           f"|{R.get_uint_best_effort(nested, 'route_hops', 'hops')}"
           f"|{R.get_phase_best_effort(nested)}")
    assert got == golden["nested_get"]
    ok, out = R.prepare_redirect_meta_phase("{}", "v", "n", 0, 1, 1)
    assert not ok and out == "{}"


def test_fuzz_matches_cpp_reference(monkeypatch):
    """Every line of the randomized sweep (>= 1000 metas): the reference
    test's own driver runs the port's policy module in place of the JAX
    package's (it imports ``policy`` from the package at call time)."""
    import security_fuzz as F
    monkeypatch.setattr(jsecurity, "policy", P)
    from ternary_image_codec_tpu.security import policy as driven
    assert driven is P and P is not JP
    scs = F.parse_scenarios(os.path.join(GOLD, "security_fuzz_scenarios.txt"))
    got = F.run_scenarios_python(scs)
    with open(os.path.join(GOLD, "golden_security_fuzz.txt")) as f:
        gold = f.read().splitlines()
    assert len(got) >= 1000 and len(got) == len(gold)
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(got, gold)) if a != b]
    assert not bad, f"{len(bad)} divergences; first: {bad[:3]}"


def test_hashes_and_wraps_match_reference():
    """The quirks kept on purpose: the reference's FNV offset basis, the
    type-hash default, and the C-typed fields' wraparound."""
    for s in ("", "a", "acme/video/enc", "x" * 300):
        assert P.fnv1a64(s) == JP.fnv1a64(s)
    for meta in ('{"type_hash":"fnv64:deadBEEF"}', '{"domain":"x","version":2}',
                 '{"domain":"ext/cam/1","radius_m":4294967301}'):
        assert P.extract_build_from_meta(meta).type_hash == \
            JP.extract_build_from_meta(meta).type_hash
    assert P.Membership("a/", "", 2**32 + 5).local_radius_m == \
        JP.Membership("a/", "", 2**32 + 5).local_radius_m == 5


def test_prep_cache_window_expiry():
    """A PREP survives exactly one decide() round, then expires."""
    pol = make_pol()
    m_prep = ('{"domain":"ext/other/z","radius_m":50,"route_ttl":3,'
              '"route_phase":0}')
    m_acc = ('{"domain":"ext/other/z","radius_m":50,"route_ttl":3,'
             '"route_phase":1}')
    P.decide_ex(pol, m_prep)
    assert len(pol.prepared_cache) == 1
    P.decide_ex(pol, '{"domain":"acme/video/e","build_hash":"ab"}')
    assert P.decide_ex(pol, m_acc).next.should_redirect


def test_container_gate(tmp_path):
    pol = make_pol()
    approve = P.t3p_approve_with_policy(pol)
    assert approve('{"domain":"acme/video/x","build_hash":"ab99"}')
    assert not approve('{"domain":"evil/x"}')
    p = str(tmp_path / "sec.t3p")
    C.t3p_write(p, SubwordMode.S27, 2, 2, np.arange(4, dtype=np.uint32),
                '{"domain":"acme/video/x","build_hash":"abcd"}')
    assert len(C.t3p_read_payload(p, approve_meta=approve)) == 4
    p2 = str(tmp_path / "bad.t3p")
    C.t3p_write(p2, SubwordMode.S27, 2, 2, np.arange(4, dtype=np.uint32),
                '{"domain":"evil/x"}')
    with pytest.raises(C.ContainerError, match="not approved"):
        C.t3p_read_payload(p2, approve_meta=P.t3v_approve_with_policy(pol))
