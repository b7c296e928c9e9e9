"""NYC TLC yellow-taxi trip records as CSV, in the 18 columns of the TLC's
monthly file for January 2019 (``yellow_tripdata_2019-01.csv``: the 17 of
the yellow trip record data dictionary and ``congestion_surcharge``, empty
that month, since the surcharge began in February), one trip a line, with
pickup times that rise through the month as in the monthly file.

The distributions are set here and listed under ``assumed`` in the
configuration.  The zones' popularity order is the city's, drawn once from
``WORLD_SEED``; the trips are drawn from the run's seed: vendor,
passengers, rate code, flag and payment type from fixed shares; pickup and
drop-off zones Zipf-skewed over the 265 taxi zones; trip distance
log-normal; fare from the metered rate; tips on card payments only;
amounts printed as the TLC prints them ("7", "0.5", "9.95").
"""

from __future__ import annotations

import datetime

import torch

from .. import fields as F

COLUMNS = ("VendorID", "tpep_pickup_datetime", "tpep_dropoff_datetime",
           "passenger_count", "trip_distance", "RatecodeID",
           "store_and_fwd_flag", "PULocationID", "DOLocationID",
           "payment_type", "fare_amount", "extra", "mta_tax", "tip_amount",
           "tolls_amount", "improvement_surcharge", "total_amount",
           "congestion_surcharge")
ZONES = 265
ZONE_THETA = 1.0
START = datetime.date(2019, 1, 1)
MEAN_GAP_S = 0.35  # about 7.6 million trips in a 31-day month
ROWS = 1 << 16  # records made a call
# The city is the configuration's: the zones' popularity order is drawn
# once from this seed, the trips from the run's.
WORLD_SEED = 20190101


def date_table(days: int, device) -> tuple:
    return F.table([(START + datetime.timedelta(d)).isoformat()
                    for d in range(days)], device)


def stamp(dates: tuple, secs: torch.Tensor, sep: str) -> tuple:
    """'YYYY-MM-DD<sep>HH:MM:SS' of whole seconds since ``START``."""
    rows = len(secs)
    dev = secs.device
    return F.join([F.pick(dates, secs // 86400), F.const(sep, rows, dev),
                   F.two(secs // 3600 % 24), F.const(":", rows, dev),
                   F.two(secs // 60 % 60), F.const(":", rows, dev),
                   F.two(secs % 60)])


def generate(seed: int, n_bytes: int, device) -> torch.Tensor:
    """``n_bytes`` of CSV text from ``seed``, as a uint8 tensor on
    ``device``."""
    world = torch.Generator(device=device)
    world.manual_seed(WORLD_SEED)
    zone_perm = torch.randperm(ZONES, generator=world, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 64) - 1))
    dates = date_table(400, device)
    clock = [0.0]  # seconds since START of the last pickup

    def chunk(rows):
        def u():
            return torch.rand(rows, generator=gen, device=device,
                              dtype=torch.float64)

        gaps = -torch.log1p(-u()) * MEAN_GAP_S
        t = clock[0] + torch.cumsum(gaps, 0)
        clock[0] = float(t[-1])
        pickup = t.to(torch.int64)
        dist = torch.exp(torch.randn(rows, generator=gen, device=device,
                                     dtype=torch.float64) * 0.85 + 0.45)
        dist_c = (dist.clamp(max=80.0) * 100).round().to(torch.int64)
        minutes = dist * (2.5 + 2.5 * u()) + 1.5 * u()
        dropoff = pickup + (minutes * 60).to(torch.int64)
        fare = ((2.5 + 2.5 * dist + 0.4 * minutes) * 2).round() * 50
        fare = fare.to(torch.int64)
        extra = F.choice(gen, [0.55, 0.3, 0.15], rows, device) * 50
        mta = torch.where(u() < 0.98, 50, 0)
        payment = F.choice(gen, [0.71, 0.275, 0.01, 0.005], rows, device) + 1
        tip = torch.where(payment == 1,
                          (fare * (0.12 + 0.14 * u())).round().to(torch.int64),
                          0)
        tolls = torch.where(u() < 0.06, 576, 0)
        surcharge = torch.full((rows,), 30, dtype=torch.int64, device=device)
        total = fare + extra + mta + tip + tolls + surcharge
        vendor = F.choice(gen, [0.38, 0.62], rows, device) + 1
        passengers = F.choice(gen, [0.01, 0.70, 0.14, 0.04, 0.02, 0.06, 0.03],
                              rows, device)
        rate = torch.tensor([1, 2, 3, 4, 5], device=device)[
            F.choice(gen, [0.972, 0.018, 0.002, 0.001, 0.007], rows, device)]
        flag = torch.where(u() < 0.99, ord("N"), ord("Y")).to(torch.uint8)
        pu = F.zipf_items(gen, zone_perm, ZONE_THETA, rows) + 1
        do = F.zipf_items(gen, zone_perm, ZONE_THETA, rows) + 1

        comma = F.const(",", rows, device)
        cols = [F.digits(vendor, 1),
                stamp(dates, pickup, " "), stamp(dates, dropoff, " "),
                F.digits(passengers, 1), F.decimal(dist_c, trim=False),
                F.digits(rate, 1),
                (flag[:, None], torch.ones_like(pickup)),
                F.digits(pu, 3), F.digits(do, 3), F.digits(payment, 1),
                F.decimal(fare, trim=True), F.decimal(extra, trim=True),
                F.decimal(mta, trim=True), F.decimal(tip, trim=True),
                F.decimal(tolls, trim=True), F.decimal(surcharge, trim=True),
                F.decimal(total, trim=True),
                F.const("", rows, device)]  # congestion_surcharge
        parts = []
        for c in cols:
            parts += [c, comma]
        parts[-1] = F.const("\n", rows, device)
        return F.flatten(F.join(parts))

    return F.generate(chunk, n_bytes, ROWS)
