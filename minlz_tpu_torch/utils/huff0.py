"""huff0: RFC 8878 (zstd) Huffman coding, 1X and 4X stream variants.

Used by the compressed search table chunk (0x46): bitmaps are entropy-coded
with huff0 4X streams (SPEC_SEARCH.md §2.2; the reference delegates to
github.com/klauspost/compress/huff0 — this is a clean-room implementation
from the RFC's format description).

Decoder: handles both weight-table representations (FSE-compressed,
headerByte < 128; direct 4-bit weights, headerByte >= 128).
Encoder: always emits direct weights (spec-legal; requires max symbol
<= 128 — callers fall back to raw storage otherwise).
"""

from __future__ import annotations

import heapq

MAX_BITS = 11  # huff0 maximum code length


class Huff0Error(ValueError):
    pass


# ---------------------------------------------------------------------------
# Bit IO
# ---------------------------------------------------------------------------

class _BackwardBitReader:
    """zstd bitstream: written forward LSB-first, read backward from the
    final sentinel 1 bit."""

    def __init__(self, data: bytes):
        if not data:
            raise Huff0Error("empty bitstream")
        last = data[-1]
        if last == 0:
            raise Huff0Error("corrupt bitstream: no sentinel bit")
        self.val = int.from_bytes(data, "little")
        # Total bits below the sentinel.
        self.pos = (len(data) - 1) * 8 + last.bit_length() - 1
        self.overflow = False

    def read(self, n: int) -> int:
        """Consume the top n bits (MSB-first relative to remaining)."""
        if n == 0:
            return 0
        self.pos -= n
        if self.pos < 0:
            self.overflow = True
            v = self.val << (-self.pos)  # zero-pad below the stream start
            self.pos_clamped = 0
            return (v >> 0) & ((1 << n) - 1) if n else 0
        return (self.val >> self.pos) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos - n
        if p < 0:
            return (self.val << -p) & ((1 << n) - 1)
        return (self.val >> p) & ((1 << n) - 1)

    def consume(self, n: int) -> None:
        self.pos -= n


# ---------------------------------------------------------------------------
# Weight table decode
# ---------------------------------------------------------------------------

def _highbit(v: int) -> int:
    return v.bit_length() - 1


def _fse_decode_weights(data: bytes):
    """Decode an FSE-compressed Huffman weight table (RFC 8878 §4.1.1,
    accuracy_log <= 6, two interleaved states).  Returns list of weights."""
    # --- FSE table description: forward bitstream, LSB-first ---
    bitpos = 0

    def fread(n):
        nonlocal bitpos
        byte0 = bitpos >> 3
        v = int.from_bytes(data[byte0 : byte0 + 3], "little")
        v = (v >> (bitpos & 7)) & ((1 << n) - 1)
        bitpos += n
        return v

    al = fread(4) + 5
    if al > 6:
        raise Huff0Error(f"FSE accuracy log {al} > 6 for weights")
    size = 1 << al
    remaining = size + 1
    freqs = []
    while remaining > 1 and len(freqs) < 256:
        bits = _highbit(remaining) + 1
        val = fread(bits)
        lower_mask = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - remaining
        if (val & lower_mask) < threshold:
            bitpos -= 1
            val &= lower_mask
        elif val > lower_mask:
            val -= threshold
        prob = val - 1
        freqs.append(prob)
        remaining -= 1 if prob < 0 else prob
        if prob == 0:
            rep = fread(2)
            while rep == 3:
                freqs.extend([0, 0, 0])
                rep = fread(2)
            freqs.extend([0] * rep)
    if remaining != 1:
        raise Huff0Error("FSE frequencies do not sum to table size")
    header_len = (bitpos + 7) >> 3

    # --- build FSE decode table ---
    symbols = [0] * size
    num_bits = [0] * size
    new_base = [0] * size
    state_desc = [max(f, 0) for f in freqs]
    high = size - 1
    for s, f in enumerate(freqs):
        if f == -1:
            symbols[high] = s
            state_desc[s] = 1
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, f in enumerate(freqs):
        for _ in range(max(f, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise Huff0Error("FSE table spread did not return to zero")
    for i in range(size):
        s = symbols[i]
        nsd = state_desc[s]
        state_desc[s] += 1
        num_bits[i] = al - _highbit(nsd)
        new_base[i] = (nsd << num_bits[i]) - size

    # --- two interleaved states over the backward bitstream ---
    br = _BackwardBitReader(data[header_len:])
    s1 = br.read(al)
    s2 = br.read(al)
    weights = []
    while True:
        weights.append(symbols[s1])
        s1 = new_base[s1] + br.read(num_bits[s1])
        if br.overflow:
            weights.append(symbols[s2])
            break
        weights.append(symbols[s2])
        s2 = new_base[s2] + br.read(num_bits[s2])
        if br.overflow:
            weights.append(symbols[s1])
            break
        if len(weights) > 255:
            raise Huff0Error("too many Huffman weights")
    return weights


def read_table(data: bytes):
    """Read a Huffman table description.  Returns (DTable, bytes_consumed).

    DTable: (table_log, sym[2^table_log], nbits[2^table_log])."""
    if not data:
        raise Huff0Error("empty table")
    hb = data[0]
    if hb >= 128:
        n = hb - 127
        nbytes = (n + 1) // 2
        if len(data) < 1 + nbytes:
            raise Huff0Error("truncated direct weights")
        weights = []
        for i in range(n):
            b = data[1 + i // 2]
            weights.append((b >> 4) if i % 2 == 0 else (b & 15))
        consumed = 1 + nbytes
    else:
        if len(data) < 1 + hb:
            raise Huff0Error("truncated FSE weights")
        weights = _fse_decode_weights(data[1 : 1 + hb])
        consumed = 1 + hb
    return _build_dtable(weights), consumed


def _build_dtable(weights):
    """Build the decode table from transmitted weights (last implied)."""
    total = sum((1 << (w - 1)) for w in weights if w > 0)
    if total == 0:
        raise Huff0Error("no Huffman weights")
    table_log = _highbit(total) + 1
    if table_log > MAX_BITS + 1:
        raise Huff0Error("Huffman table log too large")
    rest = (1 << table_log) - total
    if rest <= 0 or rest & (rest - 1):
        raise Huff0Error("invalid weight sum (implied weight not a power of 2)")
    last_w = _highbit(rest) + 1
    ws = list(weights) + [last_w]
    size = 1 << table_log
    sym = bytearray(size)
    nbits = bytearray(size)
    # Base position per weight: lower weights (longer codes) first.
    rank_count = [0] * (table_log + 2)
    for w in ws:
        if w > 0:
            rank_count[w] += 1
    rank_val = [0] * (table_log + 2)
    nxt = 0
    for w in range(1, table_log + 1):
        rank_val[w] = nxt
        nxt += rank_count[w] << (w - 1)
    for s, w in enumerate(ws):
        if w == 0:
            continue
        length = 1 << (w - 1)
        start = rank_val[w]
        for u in range(start, start + length):
            sym[u] = s
            nbits[u] = table_log + 1 - w
        rank_val[w] += length
    return table_log, bytes(sym), bytes(nbits)


# ---------------------------------------------------------------------------
# Stream decode
# ---------------------------------------------------------------------------

def _native():
    from ..native.build import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "minlz_huff0_decode_stream"):
        return None
    return lib


def _decode_stream(dtable, data: bytes, out_len: int) -> bytearray:
    table_log, sym, nbits = dtable
    lib = _native()
    if lib is not None and data:
        import ctypes

        out = ctypes.create_string_buffer(max(out_len, 1))
        rc = lib.minlz_huff0_decode_stream(
            bytes(data), len(data), sym, nbits, table_log, out, out_len
        )
        if rc < 0:
            raise Huff0Error("corrupt huff0 stream")
        return bytearray(out.raw[:out_len])
    br = _BackwardBitReader(data)
    out = bytearray(out_len)
    for i in range(out_len):
        idx = br.peek(table_log)
        out[i] = sym[idx]
        br.consume(nbits[idx])
    return out


def decompress_1x(data: bytes, out_len: int) -> bytes:
    dtable, consumed = read_table(data)
    return bytes(_decode_stream(dtable, data[consumed:], out_len))


def decompress_4x(data: bytes, out_len: int) -> bytes:
    """4 interleaved streams with a 6-byte jump table (RFC 8878 §4.2.2)."""
    dtable, consumed = read_table(data)
    body = data[consumed:]
    if len(body) < 6:
        raise Huff0Error("missing jump table")
    l1 = int.from_bytes(body[0:2], "little")
    l2 = int.from_bytes(body[2:4], "little")
    l3 = int.from_bytes(body[4:6], "little")
    s = 6
    seg = (out_len + 3) // 4
    sizes = [seg, seg, seg, out_len - 3 * seg]
    if sizes[3] < 0:
        raise Huff0Error("output shorter than 3 stream segments")
    lens = [l1, l2, l3, len(body) - 6 - l1 - l2 - l3]
    if lens[3] < 0:
        raise Huff0Error("jump table exceeds payload")
    out = bytearray()
    for ln, on in zip(lens, sizes):
        out += _decode_stream(dtable, body[s : s + ln], on)
        s += ln
    return bytes(out)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _code_lengths(counts):
    """Huffman code lengths (<= MAX_BITS) for symbols with counts > 0."""
    heap = [(c, s, None, None) for s, c in enumerate(counts) if c > 0]
    if len(heap) < 2:
        return None  # degenerate: RLE territory
    heapq.heapify(heap)
    nodes = []
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        nodes.append((a, b))
        heapq.heappush(heap, (a[0] + b[0], 256 + len(nodes), a, b))
    lengths = {}

    def walk(node, depth):
        if node[2] is None:
            lengths[node[1]] = max(depth, 1)
        else:
            walk(node[2], depth + 1)
            walk(node[3], depth + 1)

    walk(heap[0], 0)
    if max(lengths.values()) > MAX_BITS:
        _limit_lengths(lengths, MAX_BITS)
    return lengths


def _limit_lengths(lengths, max_bits):
    """Kraft repair: clamp to max_bits, then lengthen cheapest symbols
    until the Kraft sum is exactly 1 (keeps the code complete)."""
    for s in lengths:
        if lengths[s] > max_bits:
            lengths[s] = max_bits
    kraft = sum(1 << (max_bits - l) for l in lengths.values())
    full = 1 << max_bits
    # Demote symbols (shorten = increase kraft? no: lengthening reduces it).
    syms = sorted(lengths, key=lambda s: lengths[s])
    while kraft > full:
        for s in reversed(syms):
            if lengths[s] < max_bits:
                kraft -= 1 << (max_bits - lengths[s] - 1)
                lengths[s] += 1
                break
        else:
            raise Huff0Error("cannot repair Kraft inequality")
    # Absorb slack by shortening the most frequent symbol(s).
    while kraft < full:
        for s in syms:
            gain = 1 << (max_bits - lengths[s])
            if lengths[s] > 1 and kraft + gain <= full:
                kraft += gain
                lengths[s] -= 1
                break
        else:
            break
    if kraft != full:
        raise Huff0Error("incomplete Huffman code after repair")


def _build_ctable(lengths, max_sym):
    """(val, nbits) per symbol, zstd canonical order."""
    max_nb = max(lengths.values())
    nb_per_rank = [0] * (max_nb + 1)
    for l in lengths.values():
        nb_per_rank[l] += 1
    val_per_rank = [0] * (max_nb + 2)
    mn = 0
    for n in range(max_nb, 0, -1):
        val_per_rank[n] = mn
        mn += nb_per_rank[n]
        mn >>= 1
    ctable = {}
    for s in range(max_sym + 1):
        if s in lengths:
            l = lengths[s]
            ctable[s] = (val_per_rank[l], l)
            val_per_rank[l] += 1
    return ctable, max_nb


def _encode_stream(ctable, data: bytes) -> bytes:
    """Encode one stream: symbols pushed in reverse order, LSB-first bit
    accumulation, closed with a sentinel 1 bit."""
    lib = _native()
    if lib is not None and data:
        import ctypes

        vals = (ctypes.c_uint16 * 256)()
        lens = (ctypes.c_uint8 * 256)()
        for s, (v, n) in ctable.items():
            vals[s] = v
            lens[s] = n
        cap = len(data) * 2 + 16
        out = ctypes.create_string_buffer(cap)
        rc = lib.minlz_huff0_encode_stream(
            bytes(data), len(data), vals, lens, out, cap
        )
        if rc == -1:
            raise KeyError("symbol missing from huff0 table")
        if rc < 0:
            raise Huff0Error("huff0 encode overflow")
        return out.raw[:rc]
    acc = 0
    bits = 0
    out = bytearray()
    for b in reversed(data):
        val, n = ctable[b]
        acc |= val << bits
        bits += n
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8
    acc |= 1 << bits
    bits += 1
    while bits > 0:
        out.append(acc & 255)
        acc >>= 8
        bits -= 8
    return bytes(out)


class _ForwardBitWriter:
    def __init__(self):
        self.acc = 0
        self.bits = 0
        self.out = bytearray()

    def write(self, v: int, n: int):
        self.acc |= (v & ((1 << n) - 1)) << self.bits
        self.bits += n
        while self.bits >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.bits -= 8

    def close_sentinel(self) -> bytes:
        self.write(1, 1)
        if self.bits:
            self.out.append(self.acc & 255)
            self.acc = 0
            self.bits = 0
        return bytes(self.out)

    def close_padded(self) -> bytes:
        if self.bits:
            self.out.append(self.acc & 255)
            self.acc = 0
            self.bits = 0
        return bytes(self.out)


def _fse_encode_weights(weights):
    """FSE-compress a Huffman weight list (two interleaved states,
    accuracy_log 6).  Returns the compressed bytes or None."""
    n = len(weights)
    if n < 2:
        return None
    al = 6
    size = 1 << al
    max_sym = max(weights)
    counts = [0] * (max_sym + 1)
    for w in weights:
        counts[w] += 1
    # Normalize to `size` with every present symbol >= 1; cap at size/2 so
    # every table cell reads >= 1 bit (guarantees decoder termination).
    total = n
    freqs = [0] * (max_sym + 1)
    for s, c in enumerate(counts):
        if c:
            freqs[s] = max(1, min(size // 2, round(c * size / total)))
    diff = size - sum(freqs)
    order = sorted(range(max_sym + 1), key=lambda s: -freqs[s])
    i = 0
    while diff != 0:
        s = order[i % len(order)]
        if diff > 0 and freqs[s] and freqs[s] < size // 2:
            freqs[s] += 1
            diff -= 1
        elif diff < 0 and freqs[s] > 1:
            freqs[s] -= 1
            diff += 1
        i += 1
        if i > 4096:
            return None

    # --- header: AL + threshold-coded counts + zero-repeat flags ---
    hw = _ForwardBitWriter()
    hw.write(al - 5, 4)
    remaining = size + 1
    s = 0
    while s <= max_sym and remaining > 1:
        bits = _highbit(remaining) + 1
        lower_mask = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - remaining
        v = freqs[s] + 1
        if v < threshold:
            hw.write(v, bits - 1)
        elif v <= lower_mask:
            hw.write(v, bits)
        else:
            hw.write(v + threshold, bits)
        remaining -= freqs[s]
        if freqs[s] == 0:
            # Zero-repeat flags for runs of following zero-count symbols.
            z = 0
            while s + 1 + z <= max_sym and freqs[s + 1 + z] == 0 and (
                remaining > 1
            ):
                z += 1
            run = z
            while run >= 3:
                hw.write(3, 2)
                run -= 3
            hw.write(run, 2)
            s += z
        s += 1
    if remaining != 1:
        return None
    header = hw.close_padded()

    # --- encode table (zstd CTable layout) ---
    symbols = [0] * size
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for sym, f in enumerate(freqs):
        for _ in range(f):
            symbols[pos] = sym
            pos = (pos + step) & mask
    if pos != 0:
        return None
    cumul = [0] * (max_sym + 2)
    for sym in range(max_sym + 1):
        cumul[sym + 1] = cumul[sym] + freqs[sym]
    state_table = [0] * size
    cc = list(cumul)
    for i in range(size):
        sym = symbols[i]
        state_table[cc[sym]] = size + i
        cc[sym] += 1
    delta_nb = [0] * (max_sym + 1)
    delta_fs = [0] * (max_sym + 1)
    for sym, f in enumerate(freqs):
        if f == 0:
            continue
        max_bits_out = al - _highbit(f - 1) if f > 1 else al
        min_state_plus = f << max_bits_out
        delta_nb[sym] = (max_bits_out << 16) - min_state_plus
        delta_fs[sym] = cumul[sym] - f

    bw = _ForwardBitWriter()

    def init_state(sym):
        nbo = (delta_nb[sym] + (1 << 15)) >> 16
        st = (nbo << 16) - delta_nb[sym]
        return state_table[(st >> nbo) + delta_fs[sym]]

    def encode(state, sym):
        nbo = (state + delta_nb[sym]) >> 16
        bw.write(state, nbo)
        return state_table[(state >> nbo) + delta_fs[sym]]

    # Process in reverse; the first two processed (indices n-1, n-2) are
    # state inits.  Even indices ride state 1, odd state 2.
    s1 = s2 = None
    for i in range(n - 1, -1, -1):
        w = weights[i]
        if i % 2 == 0:
            s1 = init_state(w) if s1 is None else encode(s1, w)
        else:
            s2 = init_state(w) if s2 is None else encode(s2, w)
    if s2 is None:
        s2 = s1  # single-weight degenerate (n >= 2 prevents this)
    bw.write(s2 - size, al)
    bw.write(s1 - size, al)
    body = bw.close_sentinel()
    out = header + body
    return out if len(out) < 128 else None


def _marshal_weights(lengths, max_nb):
    """Weight table header: direct 4-bit representation when legal and
    shorter, else FSE-compressed (headerByte < 128)."""
    max_sym = max(lengths)
    weights = []
    for s in range(max_sym):  # last symbol's weight implied
        l = lengths.get(s, 0)
        weights.append(max_nb + 1 - l if l else 0)
    n = len(weights)
    direct = None
    if max_sym <= 128:
        out = bytearray([127 + n])
        for i in range(0, n, 2):
            hi = weights[i] << 4
            lo = weights[i + 1] if i + 1 < n else 0
            out.append(hi | lo)
        direct = bytes(out)
    fse = _fse_encode_weights(weights)
    if fse is not None and (direct is None or len(fse) + 1 < len(direct)):
        return bytes([len(fse)]) + fse
    return direct


def build_ctable(counts):
    """Build an encode table from symbol counts.  Returns
    (table_header_bytes, ctable) or None for degenerate alphabets."""
    lengths = _code_lengths(counts)
    if lengths is None:
        return None
    header = _marshal_weights(lengths, max(lengths.values()))
    if header is None:
        return None
    ctable, _ = _build_ctable(lengths, max(lengths))
    return header, ctable


def encode_4x(ctable, data: bytes):
    """4X streams + jump table for an externally built (shared) ctable.
    Returns the stream payload (no table header) or None on overflow."""
    seg = (len(data) + 3) // 4
    parts = [data[i * seg : (i + 1) * seg] for i in range(3)]
    parts.append(data[3 * seg :])
    try:
        streams = [_encode_stream(ctable, p) for p in parts]
    except KeyError:
        return None  # symbol missing from the shared table
    if any(len(s) > 0xFFFF for s in streams[:3]):
        return None
    jump = b"".join(len(s).to_bytes(2, "little") for s in streams[:3])
    return jump + b"".join(streams)


def decode_4x_body(dtable, body: bytes, out_len: int) -> bytes:
    """Decode a 4X stream payload (jump table + streams) with a shared
    decode table."""
    if len(body) < 6:
        raise Huff0Error("missing jump table")
    l1 = int.from_bytes(body[0:2], "little")
    l2 = int.from_bytes(body[2:4], "little")
    l3 = int.from_bytes(body[4:6], "little")
    s = 6
    seg = (out_len + 3) // 4
    sizes = [seg, seg, seg, out_len - 3 * seg]
    lens = [l1, l2, l3, len(body) - 6 - l1 - l2 - l3]
    if sizes[3] < 0 or lens[3] < 0:
        raise Huff0Error("bad 4X stream geometry")
    out = bytearray()
    for ln, on in zip(lens, sizes):
        out += _decode_stream(dtable, body[s : s + ln], on)
        s += ln
    return bytes(out)


def _count(data: bytes):
    import numpy as np

    return np.bincount(
        np.frombuffer(data, np.uint8), minlength=256
    ).tolist()


def compress_4x(data: bytes):
    """Compress with one table + 4 streams.  Returns the huff0 payload
    (table + jump table + streams) or None when not compressible."""
    if len(data) < 8:
        return None
    built = build_ctable(_count(data))
    if built is None:
        return None
    header, ctable = built
    body = encode_4x(ctable, data)
    if body is None:
        return None
    payload = header + body
    if len(payload) >= len(data):
        return None
    return payload


def compress_1x(data: bytes):
    if len(data) < 2:
        return None
    lengths = _code_lengths(_count(data))
    if lengths is None:
        return None
    header = _marshal_weights(lengths, max(lengths.values()))
    if header is None:
        return None
    ctable, _ = _build_ctable(lengths, max(lengths))
    payload = header + _encode_stream(ctable, data)
    if len(payload) >= len(data):
        return None
    return payload
