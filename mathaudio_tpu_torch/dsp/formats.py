"""PEQ exporters: EqualizerAPO, RME TotalMix (channel/room), Apple
AUNBandEQ aupreset (counterpart of mathaudio_tpu/dsp/formats.py;
math-iir-fir/src/iir.rs:1495,1907,2181,2320). Host strings, character for
character the reference's; the preamp gain (APO, AUPreset) is computed on
``device``."""

from __future__ import annotations

import base64
import struct
from typing import List, Tuple

from mathaudio_tpu_torch.dsp.iir import (
    DEFAULT_Q_HIGH_LOW_PASS,
    Biquad,
    BiquadFilterType,
    Peq,
    peq_preamp_gain,
    q2bw,
)

FT = BiquadFilterType


def peq_format_apo(comment: str, peq: Peq, *, device=None) -> str:
    """EqualizerAPO config text (iir.rs:1495)."""
    res = [comment, f"Preamp: {peq_preamp_gain(peq, device=device):.1f} dB", ""]
    sorted_peq = sorted(peq, key=lambda it: it[1].freq)
    for i, (_, bq) in enumerate(sorted_peq):
        n = i + 1
        t = bq.filter_type
        if t in (FT.PEAK, FT.NOTCH, FT.BANDPASS):
            res.append(
                f"Filter {n:2}: ON {t.short_name:2} Fc {int(bq.freq):5} Hz "
                f"Gain {bq.db_gain:+0.2f} dB Q {bq.q:0.2f}"
            )
        elif t in (FT.LOWPASS, FT.HIGHPASS):
            if abs(bq.q - DEFAULT_Q_HIGH_LOW_PASS) < 2.3e-16:
                res.append(f"Filter {n:2}: ON {t.short_name:2} Fc {int(bq.freq):5} Hz")
            else:
                res.append(
                    f"Filter {n:2}: ON {t.short_name:2}Q Fc {int(bq.freq):5} Hz Q {bq.q:0.2f}"
                )
        elif t in (FT.LOWSHELF, FT.HIGHSHELF):
            res.append(
                f"Filter {n:2}: ON {t.short_name:2} Fc {int(bq.freq):5} Hz "
                f"Gain {bq.db_gain:+0.2f} dB Q {bq.q:.2f}"
            )
        elif t == FT.HIGHPASS_VARIABLE_Q:
            res.append(f"Filter {n:2}: ON HPQ Fc {int(bq.freq):5} Hz Q {bq.q:0.2f}")
    res.append("")
    return "\n".join(res)


def _rme_type(filter_type: BiquadFilterType, pos: int) -> float:
    """RME band-type code; -1 = unsupported at this slot (iir.rs:1863)."""
    if filter_type == FT.PEAK:
        return 0.0
    if filter_type == FT.LOWPASS:
        return 3.0 if pos == 1 else (2.0 if pos in (3, 9) else -1.0)
    if filter_type in (FT.HIGHPASS, FT.HIGHPASS_VARIABLE_Q):
        return 2.0 if pos == 1 else (3.0 if pos in (3, 9) else -1.0)
    if filter_type in (FT.LOWSHELF, FT.HIGHSHELF):
        return 1.0 if pos in (1, 3, 9) else -1.0
    return -1.0


def peq_format_rme_channel(peq: Peq) -> str:
    """RME TotalMix channel EQ preset XML (iir.rs:1907)."""
    lines = [
        "<Preset>",
        "  <Equalizer>",
        "    <Params>",
        '\t<val e="LC Grade" v="1.00,"/>',
        '\t<val e="LC Freq" v="20.00,"/>',
    ]
    for i, (_, bq) in enumerate(peq):
        lines.append(f'      <val e="Band{i + 1} Freq" v="{bq.freq:7.2f},"/>')
        lines.append(f'      <val e="Band{i + 1} Q" v="{bq.q:4.2f},"/>')
        lines.append(f'        <val e="Band{i + 1} Gain" v="{bq.db_gain:4.2f},"/>')
    for i, (_, bq) in enumerate(peq):
        t = _rme_type(bq.filter_type, i + 1)
        if t >= 0.0:
            lines.append(f'        <val e="Band{i + 1} Type" v="{t:4.2f},"/>')
    lines += ["    </Params>", "  </Equalizer>", "</Preset>"]
    return "\n".join(lines)


def _neutral_pk() -> Tuple[float, Biquad]:
    return (1.0, Biquad(FT.PEAK, 1000.0, 48000.0, 1.0, 0.0))


def _enforce_rme_room_constraints(peq: Peq) -> Peq:
    """RME room EQ hardware slots (iir.rs:2055): exactly 9 bands;
    positions 2-8 are PK-only; position 1 takes the lowest-frequency
    non-PK filter (LS/HS/LP/HP) if any, position 9 the highest-frequency
    one if a second exists; unsupported types become PK; excess PK bands
    are dropped; missing slots pad with neutral PK at 1 kHz."""
    _NON_PK = (FT.LOWSHELF, FT.HIGHSHELF, FT.LOWPASS, FT.HIGHPASS, FT.HIGHPASS_VARIABLE_Q)
    pk: Peq = []
    non_pk: Peq = []
    for w, bq in peq:
        if bq.filter_type == FT.PEAK:
            pk.append((w, bq))
        elif bq.filter_type in _NON_PK:
            non_pk.append((w, bq))
        else:
            pk.append((w, Biquad(FT.PEAK, bq.freq, bq.srate, bq.q, bq.db_gain)))

    selected_low = selected_high = None
    if non_pk:
        by_freq = sorted(non_pk, key=lambda it: it[1].freq)
        selected_low = by_freq[0]
        if len(by_freq) > 1:
            selected_high = by_freq[-1]

    result: Peq = [selected_low or (pk.pop(0) if pk else _neutral_pk())]
    for _ in range(7):
        result.append(pk.pop(0) if pk else _neutral_pk())
    result.append(selected_high or (pk.pop(0) if pk else _neutral_pk()))
    return result


def peq_format_rme_room(left: Peq, right: Peq = ()) -> str:
    """RME TotalMix room EQ preset XML, L/R channels (iir.rs:2181)."""
    left_c = _enforce_rme_room_constraints(left)
    right_c = _enforce_rme_room_constraints(list(right)) if right else left_c

    def channel(peqs: Peq, lines: List[str]):
        for i, (_, bq) in enumerate(peqs):
            lines.append(f'        <val e="REQ Band{i + 1} Freq" v="{bq.freq:7.2f},"/>')
            lines.append(f'        <val e="REQ Band{i + 1} Q" v="{bq.q:4.2f},"/>')
            lines.append(f'        <val e="REQ Band{i + 1} Gain" v="{bq.db_gain:4.2f},"/>')
        for i, (_, bq) in enumerate(peqs):
            t = _rme_type(bq.filter_type, i + 1)
            if t >= 0.0:
                lines.append(f'        <val e="REQ Band{i + 1} Type" v="{t:4.2f},"/>')

    lines = ["<Preset>"]
    for name, ch in [("Room EQ L", left_c), ("Room EQ R", right_c)]:
        lines.append(f"  <{name}>")
        lines.append("    <Params>")
        lines.append('\t<val e="REQ Delay" v="0.00,"/>')
        channel(ch, lines)
        lines.append('\t<val e="REQ Chan Gain" v="0,"/>')
        lines.append("    </Params>")
        lines.append(f"  </{name}>")
    lines.append("</Preset>")
    return "\n".join(lines)


# Apple AUNBandEQ constants (iir.rs:2265-2283)
_AU_BYPASS, _AU_TYPE, _AU_FREQ, _AU_GAIN, _AU_BW = 1000, 2000, 3000, 4000, 5000
_AU_TYPES = {
    FT.PEAK: 0, FT.HIGHSHELF: 8, FT.LOWSHELF: 7,
    FT.HIGHPASS: 4, FT.HIGHPASS_VARIABLE_Q: 4, FT.LOWPASS: 3, FT.BANDPASS: 5,
}


def peq_format_aupreset(peq: Peq, name: str, *, device=None) -> str:
    """Apple AUNBandEQ plist with base64-packed parameters (iir.rs:2320)."""
    len_peq = min(len(peq), 16)
    preamp = peq_preamp_gain(peq, device=device)

    buf = struct.pack(">iiii f", 0, 0, 81, 0, preamp)
    params = {}
    for i, (_, bq) in enumerate(peq[:16]):
        params[_AU_BYPASS + i] = 0.0
        params[_AU_TYPE + i] = float(_AU_TYPES.get(bq.filter_type, -1))
        params[_AU_FREQ + i] = float(bq.freq)
        params[_AU_GAIN + i] = float(bq.db_gain)
        params[_AU_BW + i] = float(q2bw(bq.q))
    for i in range(len_peq, 16):
        params[_AU_BYPASS + i] = 1.0
        params[_AU_TYPE + i] = 0.0
        params[_AU_FREQ + i] = 0.0
        params[_AU_GAIN + i] = 0.0
        params[_AU_BW + i] = 0.0
    for pid in sorted(params):
        buf += struct.pack(">if", pid, params[pid])

    b64 = base64.standard_b64encode(buf).decode()
    data_section = "\n".join(f"\t{b64[i:i + 68]}" for i in range(0, len(b64), 68))

    return f"""<?xml version="1.0" encoding="UTF-8"?>
<!DOCTYPE plist PUBLIC "-//Apple//DTD PLIST 1.0//EN" "http://www.apple.com/DTDs/PropertyList-1.0.dtd">
<plist version="1.0">
<dict>
\t<key>ParametricType</key>
\t<integer>11</integer>
\t<key>data</key>
\t<data>
{data_section}
\t</data>
\t<key>manufacturer</key>
\t<integer>1634758764</integer>
\t<key>name</key>
\t<string>{name}</string>
\t<key>numberOfBands</key>
\t<integer>{len_peq}</integer>
\t<key>subtype</key>
\t<integer>1851942257</integer>
\t<key>type</key>
\t<integer>1635083896</integer>
\t<key>version</key>
\t<integer>0</integer>
</dict>
</plist>
"""
