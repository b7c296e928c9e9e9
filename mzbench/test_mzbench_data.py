"""The data generators and the Zipf draws: deterministic by seed, and the
records in their published schemas."""

import base64
import collections
import json
import re

import pytest
import torch

from mzbench import fields as F
from mzbench.data import gharchive_events, nyc_taxi_trips

GENERATORS = [nyc_taxi_trips, gharchive_events]
SEED = (1 << 31) + 977


def lines(gen, seed=SEED, n=256 << 10):
    text = bytes(gen.generate(seed, n, "cpu").numpy()).decode()
    return text.split("\n")[:-1]  # the last record is cut


@pytest.mark.parametrize("gen", GENERATORS, ids=lambda g: g.__name__)
def test_same_seed_same_bytes(gen):
    a = gen.generate(SEED, 64 << 10, "cpu")
    b = gen.generate(SEED, 64 << 10, "cpu")
    assert a.dtype == torch.uint8 and a.numel() == 64 << 10
    assert torch.equal(a, b)


@pytest.mark.parametrize("gen", GENERATORS, ids=lambda g: g.__name__)
def test_other_seed_other_bytes(gen):
    assert not torch.equal(gen.generate(SEED, 64 << 10, "cpu"),
                           gen.generate(SEED + 1, 64 << 10, "cpu"))


def test_taxi_rows_have_the_18_columns():
    stamp = re.compile(r"^2019-\d\d-\d\d \d\d:\d\d:\d\d$")
    rows = [r.split(",") for r in lines(nyc_taxi_trips)]
    assert len(rows) > 1000
    assert len(nyc_taxi_trips.COLUMNS) == 18
    last = ""
    for r in rows:
        assert len(r) == 18
        rec = dict(zip(nyc_taxi_trips.COLUMNS, r))
        assert rec["congestion_surcharge"] == ""
        assert stamp.match(rec["tpep_pickup_datetime"])
        assert rec["tpep_dropoff_datetime"] >= rec["tpep_pickup_datetime"]
        assert rec["tpep_pickup_datetime"] >= last
        last = rec["tpep_pickup_datetime"]
        assert 1 <= int(rec["PULocationID"]) <= 265
        assert 1 <= int(rec["DOLocationID"]) <= 265
        assert rec["VendorID"] in ("1", "2")
        assert rec["store_and_fwd_flag"] in ("N", "Y")
        assert re.match(r"^\d+\.\d\d$", rec["trip_distance"])
        parts = ("fare_amount", "extra", "mta_tax", "tip_amount",
                 "tolls_amount", "improvement_surcharge")
        cents = [round(float(rec[k]) * 100) for k in parts]
        assert sum(cents) == round(float(rec["total_amount"]) * 100)
        for k in parts + ("total_amount",):
            assert not re.search(r"\.\d*0$", rec[k]), rec[k]


def test_taxi_zones_are_skewed():
    counts = collections.Counter(r.split(",")[7]
                                 for r in lines(nyc_taxi_trips, n=1 << 20))
    top = counts.most_common()
    assert top[0][1] > 10 * top[len(top) // 2][1]


USER_FIELDS = ["login", "id", "node_id", "avatar_url", "gravatar_id", "url",
               "html_url", "followers_url", "following_url", "gists_url",
               "starred_url", "subscriptions_url", "organizations_url",
               "repos_url", "events_url", "received_events_url", "type",
               "site_admin"]


def check_user(u):
    assert list(u) == USER_FIELDS
    assert u["repos_url"] == f"https://api.github.com/users/{u['login']}/repos"
    assert base64.b64decode(u["node_id"]) == f"04:User{u['id']}".encode()


def check_repo(r):
    assert len(r) == 73 and r["full_name"].split("/")[0] == \
        r["owner"]["login"]
    assert r["url"] == "https://api.github.com/repos/" + r["full_name"]
    check_user(r["owner"])


def test_gharchive_events_have_the_public_schema():
    events = [json.loads(x) for x in lines(gharchive_events, n=2 << 20)]
    assert len(events) > 100
    last = ""
    sizes = collections.Counter()
    for e in events:
        assert list(e)[:7] == ["id", "type", "actor", "repo", "payload",
                               "public", "created_at"]
        assert set(e) - {"org"} == {"id", "type", "actor", "repo", "payload",
                                    "public", "created_at"}
        assert e["type"] in gharchive_events.TYPES
        assert set(e["actor"]) == {"id", "login", "display_login",
                                   "gravatar_id", "url", "avatar_url"}
        assert set(e["repo"]) == {"id", "name", "url"}
        assert e["repo"]["url"].endswith(e["repo"]["name"])
        assert e["created_at"] >= last
        last = e["created_at"]
        p = e["payload"]
        if e["type"] == "PushEvent":
            assert p["head"] == p["commits"][-1]["sha"]
            assert p["size"] == len(p["commits"])
            assert len(p["before"]) == 40
            sizes[p["size"]] += 1
        if "pull_request" in p and "head" in p["pull_request"]:
            pr = p["pull_request"]
            check_user(pr["user"])
            for side in ("head", "base"):
                check_user(pr[side]["user"])
                check_repo(pr[side]["repo"])
            assert pr["base"]["repo"]["full_name"] == e["repo"]["name"]
            assert set(pr["_links"]) == {"self", "html", "issue", "comments",
                                         "review_comments", "review_comment",
                                         "commits", "statuses"}
        if e["type"] == "ForkEvent":
            check_repo({k: v for k, v in p["forkee"].items()
                        if k != "public"})
        if e["type"] in ("IssuesEvent", "IssueCommentEvent"):
            check_user(p["issue"]["user"])
    types = collections.Counter(e["type"] for e in events)
    assert types.most_common(1)[0][0] == "PushEvent"
    assert types["PullRequestEvent"] and types["ForkEvent"]
    assert sizes[1] > sizes[2] > 0 and max(sizes) <= 20


def test_gharchive_events_fill_the_sources_two_days():
    """At the mean gap, two days of events are the source file's size."""
    data = gharchive_events.generate(SEED, 8 << 20, "cpu").numpy()
    per_event = len(data) / (data == ord("\n")).sum()
    two_days = 2 * 86400 / gharchive_events.MEAN_GAP_S * per_event
    assert abs(two_days / 6_273_951_764 - 1) < 0.1


@pytest.mark.parametrize("theta", [0.99, 1.2])
def test_zipf_ranks_follow_their_law(theta):
    gen = torch.Generator().manual_seed(5)
    n = 16
    ranks = F.zipf_ranks(gen, n, theta, 200_000, "cpu")
    counts = torch.bincount(ranks, minlength=n).double() / len(ranks)
    w = 1.0 / torch.arange(1, n + 1, dtype=torch.float64) ** theta
    assert torch.allclose(counts, w / w.sum(), atol=0.005)


def test_zipf_items_keep_the_popularity_order():
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(9))

    def hot(seed):
        gen = torch.Generator().manual_seed(seed)
        items = F.zipf_items(gen, perm, 1.0, 20_000)
        return int(torch.bincount(items, minlength=64).argmax())

    assert {hot(s) for s in range(8)} == {int(perm[0])}


def test_the_world_is_the_configurations():
    def top(seed):
        rows = [r.split(",") for r in lines(nyc_taxi_trips, seed, 1 << 20)]
        return collections.Counter(r[7] for r in rows).most_common(1)[0][0]

    assert top(SEED) == top(SEED + 12345)


def test_join_and_flatten_lay_fields_side_by_side():
    a = F.digits(torch.tensor([0, 7, 123456]), 8)
    b = F.const(",", 3, "cpu")
    c = F.decimal(torch.tensor([700, 50, 995]), trim=True)
    assert bytes(F.flatten(F.join([a, b, c])).numpy()) == \
        b"0,77,0.5123456,9.95"
