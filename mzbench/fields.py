"""Text records built column by column in torch, on whatever device the
generator's tensors live on.

A field is a pair ``(bytes, lens)``: ``bytes`` is a ``[rows, W]`` uint8
tensor whose row r holds the field's text left-aligned in its first
``lens[r]`` bytes, and ``lens`` is ``[rows]`` int64.  ``join`` lays fields
side by side into one field; ``flatten`` turns a field into the records'
bytes, one row after the other.  Everything is a few large tensor
operations, so a generator makes hundreds of MiB a second on the card.
"""

from __future__ import annotations

import re

import torch

_POW10 = [10 ** k for k in range(19)]
_CONSTS = {}
_SLOT = re.compile(r"\$\{(\w+)\}")
_B64 = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"


def const(text: str, rows: int, device) -> tuple:
    """The same text on every row."""
    key = (text, str(device))
    raw = _CONSTS.get(key)
    if raw is None:
        raw = _CONSTS[key] = torch.tensor(list(text.encode()),
                                          dtype=torch.uint8, device=device)
    return (raw.expand(rows, len(raw)),
            torch.full((rows,), len(raw), dtype=torch.int64, device=device))


def template(text: str, rows: int, device, **fields) -> tuple:
    """``text`` with each ``${name}`` replaced by field ``name``, row by
    row."""
    parts, pos = [], 0
    for m in _SLOT.finditer(text):
        if m.start() > pos:
            parts.append(const(text[pos:m.start()], rows, device))
        parts.append(fields[m.group(1)])
        pos = m.end()
    if pos < len(text):
        parts.append(const(text[pos:], rows, device))
    return join(parts)


def either(mask: torch.Tensor, a: tuple, b: tuple) -> tuple:
    """Field ``a`` where ``mask`` holds, ``b`` elsewhere."""
    return join([keep(a, mask), keep(b, ~mask)])


def table(strings, device) -> tuple:
    """A field with one row per string: pick rows of it with ``pick``."""
    raw = [s.encode() for s in strings]
    width = max(1, max(len(r) for r in raw))
    buf = torch.zeros((len(raw), width), dtype=torch.uint8)
    for i, r in enumerate(raw):
        buf[i, :len(r)] = torch.tensor(list(r), dtype=torch.uint8)
    lens = torch.tensor([len(r) for r in raw], dtype=torch.int64)
    return buf.to(device), lens.to(device)


def pick(field: tuple, idx: torch.Tensor) -> tuple:
    """Rows ``idx`` of a field."""
    return field[0][idx], field[1][idx]


def keep(field: tuple, mask: torch.Tensor) -> tuple:
    """The field where ``mask`` holds, the empty string elsewhere."""
    return field[0], field[1] * mask.to(torch.int64)


def digits(v: torch.Tensor, width: int = 19) -> tuple:
    """Decimal text of non-negative int64 values of at most ``width``
    digits, without leading zeros."""
    v = v.to(torch.int64)
    pow10 = torch.tensor(_POW10[:width], dtype=torch.int64, device=v.device)
    n = 1 + (v[:, None] >= pow10[1:]).sum(1)
    e = n[:, None] - 1 - torch.arange(width, device=v.device)
    d = (v[:, None] // pow10[e.clamp(min=0)]) % 10
    return (d + 48).to(torch.uint8), n


def two(v: torch.Tensor) -> tuple:
    """Two decimal digits with a leading zero (00-99)."""
    v = v.to(torch.int64)
    d = torch.stack([v // 10 % 10, v % 10], 1)
    return ((d + 48).to(torch.uint8),
            torch.full_like(v, 2))


def decimal(cents: torch.Tensor, trim: bool) -> tuple:
    """Amounts in hundredths as text: "7.25", "0.50", "12.00"; with
    ``trim`` trailing zeros and a bare point go ("7.25", "0.5", "12"), as
    NYC TLC's CSV files print amounts."""
    cents = cents.to(torch.int64)
    whole = digits(cents // 100, 8)
    frac = two(cents % 100)
    point = const(".", len(cents), cents.device)
    if trim:
        nfrac = torch.where(cents % 100 == 0, 0,
                            torch.where(cents % 10 == 0, 1, 2))
        frac = (frac[0], nfrac)
        point = keep(point, nfrac > 0)
    return join([whole, point, frac])


def hexstr(gen: torch.Generator, rows: int, n: int, device) -> tuple:
    """``n`` random lowercase hex digits a row."""
    nib = torch.randint(0, 16, (rows, n), generator=gen, device=device)
    alphabet = torch.tensor(list(b"0123456789abcdef"), dtype=torch.uint8,
                            device=device)
    return alphabet[nib], torch.full((rows,), n, dtype=torch.int64,
                                     device=device)


def _pack(buf: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The bytes of each row of ``buf`` where ``mask`` holds, moved to the
    row's front; zeros after them."""
    width = buf.shape[1]
    pos = torch.cumsum(mask, 1) - 1
    # Bytes left out go to a spare column that is dropped.
    pos = torch.where(mask, pos, torch.full_like(pos, width))
    out = torch.zeros((buf.shape[0], width + 1), dtype=torch.uint8,
                      device=buf.device)
    out.scatter_(1, pos, buf)
    return out[:, :width]


def join(fields) -> tuple:
    """Lay the fields of each row side by side into one field."""
    buf = torch.cat([f[0] for f in fields], 1)
    cols = [torch.arange(f[0].shape[1], device=buf.device) for f in fields]
    mask = torch.cat([c[None, :] < f[1][:, None]
                      for c, f in zip(cols, fields)], 1)
    return _pack(buf, mask), sum(f[1] for f in fields)


def words(vocab: tuple, ids: torch.Tensor, k: torch.Tensor) -> tuple:
    """Row r: words ``ids[r, :k[r]]`` of the ``vocab`` field, separated by
    single spaces."""
    rows, n = ids.shape
    buf = torch.nn.functional.pad(vocab[0][ids], (0, 1))
    lens = vocab[1][ids]
    buf.scatter_(2, lens[:, :, None], 32)  # a space after each word
    used = torch.arange(n, device=ids.device)[None, :] < k[:, None]
    lens = torch.where(used, lens + 1, 0)
    mask = torch.arange(buf.shape[2], device=ids.device) < lens[:, :, None]
    total = lens.sum(1)
    return (_pack(buf.reshape(rows, -1), mask.reshape(rows, -1)),
            total - (total > 0).to(torch.int64))


def base64(field: tuple) -> tuple:
    """The base64 text (with ``=`` padding) of each row."""
    buf, lens = field
    rows, width = buf.shape
    width3 = -(-width // 3) * 3
    mask = torch.arange(width, device=buf.device)[None, :] < lens[:, None]
    raw = torch.nn.functional.pad(buf * mask, (0, width3 - width))
    tri = raw.reshape(rows, -1, 3).to(torch.int64)
    v = tri[:, :, 0] << 16 | tri[:, :, 1] << 8 | tri[:, :, 2]
    six = torch.stack([v >> 18, v >> 12 & 63, v >> 6 & 63, v & 63], 2)
    alphabet = const(_B64.decode(), 1, buf.device)[0][0]
    out = alphabet[six.reshape(rows, -1)]
    n = 4 * (-(-lens // 3))
    col = torch.arange(out.shape[1], device=buf.device)[None, :]
    pad = (3 - lens % 3) % 3
    out = torch.where((col >= (n - pad)[:, None]) & (col < n[:, None]),
                      61, out).to(torch.uint8)
    return out, n


def segments(flat: torch.Tensor, lens: torch.Tensor) -> tuple:
    """A field whose row r is the r-th of the back-to-back pieces of
    ``flat``, of lengths ``lens``."""
    width = max(1, int(lens.max())) if len(lens) else 1
    start = torch.cumsum(lens, 0) - lens
    col = torch.arange(width, device=flat.device)[None, :]
    idx = (start[:, None] + col).clamp(max=max(len(flat) - 1, 0))
    buf = flat[idx] if len(flat) else torch.zeros(
        (len(lens), width), dtype=torch.uint8, device=flat.device)
    return torch.where(col < lens[:, None], buf, 0).to(torch.uint8), lens


def merge(pieces, rows: int, device) -> torch.Tensor:
    """Records made in pieces, each ``(row indices, field)``, as one uint8
    tensor with the rows back in their order."""
    flats, starts, lens, where = [], [], [], []
    base = 0
    for idx, f in pieces:
        flat = flatten(f)
        starts.append(base + torch.cumsum(f[1], 0) - f[1])
        lens.append(f[1])
        where.append(idx)
        flats.append(flat)
        base += flat.numel()
    src = torch.cat(flats)
    idx = torch.cat(where)
    start = torch.zeros(rows, dtype=torch.int64, device=device)
    length = torch.zeros(rows, dtype=torch.int64, device=device)
    start[idx] = torch.cat(starts)
    length[idx] = torch.cat(lens)
    shift = start - (torch.cumsum(length, 0) - length)
    total = base
    pos = torch.arange(total, device=device) + torch.repeat_interleave(
        shift, length, output_size=total)
    return src[pos]


def flatten(field: tuple) -> torch.Tensor:
    """The rows' text back to back, as one uint8 tensor."""
    buf, lens = field
    mask = torch.arange(buf.shape[1], device=buf.device)[None, :] < lens[:, None]
    return buf[mask]


def zipf_ranks(gen: torch.Generator, n_items: int, theta: float, rows: int,
               device) -> torch.Tensor:
    """``rows`` draws of ranks 0..n_items-1, rank k with probability
    proportional to 1 / (k + 1) ** theta."""
    w = 1.0 / torch.arange(1, n_items + 1, dtype=torch.float64,
                           device=device) ** theta
    return torch.multinomial(w / w.sum(), rows, replacement=True,
                             generator=gen)


def zipf_items(gen: torch.Generator, perm: torch.Tensor, theta: float,
               rows: int) -> torch.Tensor:
    """As ``zipf_ranks``, with rank k mapped to item ``perm[k]``: the
    popularity order is the caller's (a deployment's), the draws
    ``gen``'s."""
    return perm[zipf_ranks(gen, len(perm), theta, rows, perm.device)]


def choice(gen: torch.Generator, weights, rows: int, device) -> torch.Tensor:
    """``rows`` draws of indices into ``weights`` (not normalised)."""
    w = torch.tensor(weights, dtype=torch.float64, device=device)
    return torch.multinomial(w / w.sum(), rows, replacement=True,
                             generator=gen)


def generate(make_chunk, n_bytes: int, rows: int) -> torch.Tensor:
    """Call ``make_chunk(rows)`` (records as one uint8 tensor) until
    ``n_bytes`` are made; the last record is cut at ``n_bytes``."""
    parts, have = [], 0
    while have < n_bytes:
        part = make_chunk(rows)
        parts.append(part)
        have += part.numel()
    return torch.cat(parts)[:n_bytes]
