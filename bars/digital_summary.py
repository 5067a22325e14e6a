"""The bars of the digital-link recipes, read from what ``bars/digital.sh``
(or, with ``--c4``, ``bars/c4_digital.sh``) wrote to OUT_DIR, each printed
with its reading and met or missed:

    python bars/digital_summary.py OUT_DIR [OUT_DIR ...]
    python bars/digital_summary.py --c4 OUT_DIR [OUT_DIR ...]

The bars are the JAX package's (``BASELINE.md``): c3_vq train mIoU >= 0.88
and code perplexity >= 48; its error-free ceiling (AWGN, >= 15 dB) within
0.012 of the analog c3's; soft-coded >= uncoded at every point <= 10 dB on
both kinds; Huffman symbols <= 0.75x fixed with mIoU within 0.002 of fixed
at >= 15 dB AWGN, and bits per token within 0.1 of the source entropy; the
BEV keep sweep monotone (each step >= the previous - 0.02) with full-rate
mIoU >= 0.86; c1_vq_prune scatter PSNR >= 21.4 at keep 0.25 and >= 19.7
at 0.125, full rate >= 22.4, monotone within 0.1 dB; UEP alpha 0.25 >=
uniform - 0.05 at every point (uncoded and soft-coded), water-filling >=
uniform + 0.4 at -5 and 0 dB AWGN; c1_vq held-out PSNR >= 23.5 and
perplexity >= 30. With ``--c4``: c4_digital's EMA greedy >= 95 over 256
episodes; HARQ's return >= soft FEC's + 5 at 0 dB; HARQ's symbols a step
<= 0.7x soft FEC's (constant: the camera's and the LiDAR's index bits
Hamming(7,4)-coded, over QPSK) at >= 15 dB; HARQ's symbols a step
non-increasing in the SNR. The fogged full-digital + V2X arm is reported
beside them (the JAX package read 95.21; no bar).
"""

import json
import os
import sys


def _json(out, name):
    with open(os.path.join(out, f"{name}.json")) as f:
        return json.load(f)


def _result(out, name):
    """The result JSON a trainer printed last."""
    with open(os.path.join(out, f"{name}.train.txt")) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def _bar(what, reading, met):
    print(f"  {'met   ' if met else 'MISSED'} {what}: {reading}")


def _curve(c, key):
    return [p[key] for p in c]


def summarize(out):
    print(out)
    c3, vq = _result(out, "c3"), _result(out, "c3_vq")
    _bar("c3_vq train mIoU >= 0.88", round(vq["miou"], 4), vq["miou"] >= 0.88)
    _bar("c3_vq perplexity >= 48", round(vq["lidar_code_perplexity"], 2),
         vq["lidar_code_perplexity"] >= 48)
    print(f"  (c3 analog: PSNR {c3['psnr']:.2f} mIoU {c3['miou']:.4f}; c3_vq "
          f"PSNR {vq['psnr']:.2f})")
    ana, unc = _json(out, "c3")["lidar"], _json(out, "c3_vq")["lidar"]
    soft = _json(out, "c3_vq_soft")["lidar"]
    gap = max(abs(a["miou"] - d["miou"]) for a, d in zip(ana["awgn"],
                                                          unc["awgn"])
              if a["snr_db"] >= 15)
    _bar("c3_vq ceiling within 0.012 of analog (AWGN >= 15 dB)",
         round(gap, 4), gap <= 0.012)
    worst = min(s["miou"] - u["miou"] for k in ("awgn", "rayleigh")
                for s, u in zip(soft[k], unc[k]) if s["snr_db"] <= 10)
    _bar("c3_vq soft-coded >= uncoded at <= 10 dB, both kinds (worst gap)",
         round(worst, 4), worst >= 0)
    for k in ("awgn", "rayleigh"):
        print(f"  c3 / c3_vq / soft mIoU {k}: "
              f"{[round(v, 3) for v in _curve(ana[k], 'miou')]} / "
              f"{[round(v, 3) for v in _curve(unc[k], 'miou')]} / "
              f"{[round(v, 3) for v in _curve(soft[k], 'miou')]}")
    ent = _json(out, "c3_vq_entropy")
    cal, rows = ent["calibration"], ent["awgn"]
    ratio = rows[0]["syms_vlc"] / rows[0]["syms_full"]
    _bar("VLC symbols <= 0.75x fixed", f"{rows[0]['syms_vlc']:.1f} of "
         f"{rows[0]['syms_full']:.0f} = {ratio:.4f}x", ratio <= 0.75)
    d = max(abs(r["miou_vlc"] - r["miou_full"]) for r in rows
            if r["snr_db"] >= 15)
    _bar("VLC mIoU within 0.002 of fixed at >= 15 dB AWGN", round(d, 4),
         d <= 0.002)
    d = cal["huffman_mean_bits_per_token"] - cal["entropy_bits_per_token"]
    _bar("VLC bits/token within 0.1 of the entropy",
         f"{cal['huffman_mean_bits_per_token']:.4f} vs "
         f"{cal['entropy_bits_per_token']:.4f}", abs(d) <= 0.1)
    print(f"  entropy AWGN mIoU full / vlc / fixed: " + "; ".join(
        f"{r['snr_db']:.0f} dB {r['miou_full']:.3f} / {r['miou_vlc']:.3f} / "
        f"{r['miou_fixed']:.3f}" for r in rows))
    keep = _json(out, "c3_vq_keep")
    for sel, c in keep.items():
        m = _curve(c, "miou")
        mono = all(b >= a - 0.02 for a, b in zip(m, m[1:]))
        _bar(f"BEV keep sweep ({sel}) monotone, full rate >= 0.86",
             [round(v, 4) for v in m], mono and m[-1] >= 0.86)
    p = _result(out, "c3_vq_prune")
    print(f"  (c3_vq_prune train mIoU {p['miou']:.4f}, perplexity "
          f"{p['lidar_code_perplexity']:.1f})")
    cam = _json(out, "c1_vq_keep")
    sc = dict(zip(_curve(cam["scatter"], "keep"),
                  _curve(cam["scatter"], "psnr")))
    _bar("c1_vq_prune scatter >= 21.4 at keep 0.25", round(sc[0.25], 3),
         sc[0.25] >= 21.4)
    _bar("c1_vq_prune scatter >= 19.7 at keep 0.125", round(sc[0.125], 3),
         sc[0.125] >= 19.7)
    _bar("c1_vq_prune full rate >= 22.4", round(sc[1.0], 3), sc[1.0] >= 22.4)
    for sel, c in cam.items():
        m = _curve(c, "psnr")
        print(f"  c1_vq_prune {sel}: {[round(v, 3) for v in m]}"
              f"{'' if all(b >= a - 0.1 for a, b in zip(m, m[1:])) else ' NOT monotone'}")
    c1, c1p = _result(out, "c1_vq"), _result(out, "c1_vq_prune")
    _bar("c1_vq held-out PSNR >= 23.5", round(c1["eval_psnr"], 3),
         c1["eval_psnr"] >= 23.5)
    _bar("c1_vq perplexity >= 30", round(c1["code_perplexity"], 2),
         c1["code_perplexity"] >= 30)
    print(f"  (c1_vq_prune held-out PSNR {c1p['eval_psnr']:.3f}, "
          f"perplexity {c1p['code_perplexity']:.2f})")
    for base, uep, what in (("c1_vq", "c1_vq_uep", "uncoded"),
                            ("c1_vq_soft", "c1_vq_uep_soft", "soft-coded")):
        u, a = _json(out, base), _json(out, uep)
        worst = min(x["psnr"] - y["psnr"] for k in ("awgn", "rayleigh")
                    for x, y in zip(a[k], u[k]))
        _bar(f"UEP alpha 0.25 >= uniform - 0.05 everywhere ({what}; worst)",
             round(worst, 3), worst >= -0.05)
    u, w = _json(out, "c1_vq")["awgn"], _json(out, "c1_vq_wf")["awgn"]
    gains = [round(x["psnr"] - y["psnr"], 3) for x, y in zip(w, u)]
    _bar("waterfill >= uniform + 0.4 at -5 and 0 dB AWGN",
         f"{gains[0]}, {gains[1]} (all: {gains})",
         gains[0] >= 0.4 and gains[1] >= 0.4)


def _fec_symbols_per_step():
    """Symbols a step of the full-digital c4 under soft FEC: every index
    bit of the camera's and the LiDAR's tokens Hamming(7,4)-coded (7 bits
    per 4), two bits a QPSK symbol."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from multimodal_sc_torch.channel.digital import index_bits
    from multimodal_sc_torch.config import get_preset

    cfg = get_preset("c4")
    cam, lid = cfg.camera, cfg.lidar
    bits = ((cam.image_hw[0] // 4) * (cam.image_hw[1] // 4)
            * index_bits(cam.vq_codes)
            + lid.bev_hw[0] * lid.bev_hw[1] * index_bits(lid.vq_codes))
    return bits * 7 // 4 // 2


def _eval(out, name):
    with open(os.path.join(out, f"{name}.txt")) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def summarize_c4(out):
    print(out)
    ema = _eval(out, "c4_digital_eval_ema")["episode_return_mean"]
    _bar("c4_digital EMA greedy >= 95 (256 episodes)", round(ema, 2),
         ema >= 95)
    unc, fec, harq = (_json(out, f"c4_digital_sweep{s}")["awgn"]
                      for s in ("", "_fec", "_harq"))
    at = {r["snr_db"]: r for r in harq}
    fec_at = {r["snr_db"]: r for r in fec}
    gain = at[0.0]["episode_return_mean"] - fec_at[0.0]["episode_return_mean"]
    _bar("HARQ return >= soft FEC + 5 at 0 dB", round(gain, 2), gain >= 5)
    fec_syms = _fec_symbols_per_step()
    worst = max(r["link_syms_per_step"] for r in harq if r["snr_db"] >= 15)
    _bar("HARQ syms/step <= 0.7x soft FEC's at >= 15 dB",
         f"{worst:.1f} of {fec_syms} = {worst / fec_syms:.4f}x",
         worst <= 0.7 * fec_syms)
    syms = _curve(harq, "link_syms_per_step")
    _bar("HARQ syms/step non-increasing in the SNR",
         [round(v, 1) for v in syms],
         all(b <= a for a, b in zip(syms, syms[1:])))
    for name, c in (("uncoded", unc), ("soft FEC", fec), ("HARQ", harq)):
        print(f"  {name} return: "
              f"{[round(v, 2) for v in _curve(c, 'episode_return_mean')]}")
    print(f"  HARQ mean rounds: "
          f"{[round(v, 3) for v in _curve(harq, 'harq_mean_rounds')]}; "
          "residual failures: "
          f"{[round(v, 4) for v in _curve(harq, 'harq_residual_fail_rate')]}")
    fog = _eval(out, "c4_fog_v2x_digital_eval_ema")["episode_return_mean"]
    print(f"  (fogged full-digital + V2X EMA greedy {fog:.2f}; the JAX "
          "package read 95.21, no bar)")


if __name__ == "__main__":
    args = sys.argv[1:]
    fn = summarize
    if args and args[0] == "--c4":
        fn, args = summarize_c4, args[1:]
    for path in args:
        fn(path)
