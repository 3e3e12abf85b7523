"""Synthetic COMAP Level-1 observation generator (a numpy copy of
``comapreduce_tpu/data/synthetic.py``).

Writes (or returns in memory) a physically-motivated Level-1 observation
in the COMAP schema with its ground truth. Physical model per (feed,
band, channel, sample)::

    P = G * T_total * (1 + dg(t)),   T_total =
        vane in beam:  T_rx + T_vane
        sky:           T_rx + T_cmb + T_atm * airmass(t) + T_sky(ra, dec)

with radiometer white noise of rms ``G*T_total/sqrt(dnu/fs)`` and a 1/f
gain fluctuation ``dg(t)`` of PSD ``(sigma_g^2/fs) (f_knee/f)^alpha``;
CES azimuth sweeps between vane events at both ends of the observation.
The draws follow the reference's order, so the same parameters give the
same bytes in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from comapreduce_tpu_torch.data.hdf5io import HDF5Store

__all__ = ["SyntheticObsParams", "generate_level1_file",
           "generate_level1_store", "one_over_f_noise",
           "gaussian_source_sky"]

SAMPLE_RATE = 50.0  # Hz, reference Level1Averaging.py:808
FEATURE_VANE = 13
FEATURE_SCAN = 5


def one_over_f_noise(rng: np.random.Generator, n: int, sigma: float,
                     fknee: float, alpha: float, fs: float = SAMPLE_RATE,
                     size: tuple = ()) -> np.ndarray:
    """Generate noise with PSD ``sigma^2/fs * (1 + (fknee/f)^alpha)``.

    Shaping white Gaussian noise in rFFT space — same construction as the
    reference's destriper self-test noise (``Destriper.py:361-370``), with an
    explicit knee frequency.
    """
    freqs = np.fft.rfftfreq(n, d=1.0 / fs)
    shape = np.ones_like(freqs)
    shape[1:] = np.sqrt(1.0 + (fknee / freqs[1:]) ** alpha)
    shape[0] = 0.0  # zero-mean
    w = rng.normal(size=size + (n,))
    W = np.fft.rfft(w, axis=-1)
    return np.fft.irfft(W * shape, n=n, axis=-1) * sigma


def gaussian_source_sky(ra, dec, ra0, dec0, amplitude, fwhm_deg):
    """Elliptically-symmetric Gaussian source brightness in K at (ra, dec)."""
    sig = fwhm_deg / 2.355
    dx = (np.asarray(ra) - ra0) * np.cos(np.radians(np.asarray(dec)))
    dy = np.asarray(dec) - dec0
    return amplitude * np.exp(-0.5 * (dx**2 + dy**2) / sig**2)


@dataclass
class SyntheticObsParams:
    """Knobs for one synthetic observation. Defaults are COMAP-plausible but
    sized for tests; scale n_* up for benchmarks."""

    obsid: int = 1_000_001
    source: str = "co2"           # field name; use 'TauA' for calibrator obs
    n_feeds: int = 2
    n_bands: int = 4
    n_channels: int = 64          # 1024 in production
    n_scans: int = 4
    scan_samples: int = 2_000     # per scan
    vane_samples: int = 300       # per vane event
    gap_samples: int = 100        # slew between scans
    mjd_start: float = 59620.0    # after the vane-thermometry epoch switch
    # physics
    t_rx: float = 20.0            # receiver temperature, K
    t_atm_zenith: float = 10.0    # zenith atmosphere, K
    t_cmb: float = 2.73
    t_vane: float = 290.0         # hot-load physical temperature, K
    gain_mean: float = 2.0e7      # counts per K
    gain_spread: float = 0.2      # fractional per-channel gain scatter
    passband_curvature: float = 0.3  # fractional Trx rise at band edges
    t_rx_scatter: float = 0.05    # per-channel receiver temp scatter
    fknee: float = 1.0            # gain-fluctuation knee, Hz
    alpha: float = 1.5
    sigma_g: float = 5.0e-4       # per-sample rms of dg at f >> fknee
    elevation: float = 55.0       # deg
    # peak-to-peak elevation drift across the observation (deg) — >0
    # simulates a sky-nod / sky-dip elevation sweep
    el_sweep: float = 0.0
    comment: str = "synthetic observation"
    az_centre: float = 180.0
    az_throw: float = 4.0         # deg, peak-to-peak/2
    ra0: float = 170.0
    dec0: float = 52.0
    source_amplitude_k: float = 0.0   # K; >0 injects a Gaussian source
    source_fwhm_deg: float = 0.075    # ~4.5 arcmin COMAP beam
    # additive per-feed atmospheric 1/f temperature fluctuation (K). Unlike
    # the multiplicative dg(t) gain stream — which gain correction removes —
    # this survives reduction and is what the destriper (and the quality
    # ledger's noise fits) actually see. >0 enables it.
    t_atm_sigma: float = 0.0
    t_atm_fknee: float = 0.1          # Hz
    t_atm_alpha: float = 1.5
    # fault mix: fraction of (feed, band, channel, sample) cells hit
    spike_rate: float = 0.0           # multiplied 100x (cosmic-ray spikes)
    nan_rate: float = 0.0             # set to NaN (dropped packets)
    # optional sky model callable (lon_deg, lat_deg, freq_GHz) -> K,
    # e.g. ``simulations.skymodel.SkyModel``; evaluated per (feed, band)
    # at the band-centre frequency and added to t_sky.
    sky_model: object = None
    seed: int = 1234
    truth: dict = field(default_factory=dict, repr=False)

    @property
    def n_samples(self) -> int:
        return (2 * self.vane_samples
                + self.n_scans * self.scan_samples
                + (self.n_scans + 1) * self.gap_samples)


def _band_frequencies(n_bands: int, n_channels: int) -> np.ndarray:
    """COMAP band plan: 26-34 GHz in four 2 GHz bands (B, C) in GHz."""
    edges = 26.0 + 2.0 * np.arange(n_bands + 1)
    freq = np.zeros((n_bands, n_channels))
    for b in range(n_bands):
        df = (edges[b + 1] - edges[b]) / n_channels
        freq[b] = edges[b] + df * (0.5 + np.arange(n_channels))
    return freq


def generate_level1_store(params: SyntheticObsParams | None = None
                          ) -> tuple[SyntheticObsParams, HDF5Store]:
    """Build a synthetic Level-1 observation as an in-memory ``HDF5Store``.

    Returns ``(params, store)`` with ``params.truth`` filled in (per-channel
    gain/tsys, dg time stream, scan edges, sky). The store can be written to
    disk (``generate_level1_file``) or served directly through the ingest
    payload path — both see the same arrays.

    Determinism contract: all randomness derives from ``params.seed``. The
    base observation draws from ``default_rng(seed)`` in a fixed order; the
    optional scenario extensions (atmospheric 1/f, faults) draw from
    *separate* ``default_rng([seed, k])`` streams so enabling them never
    perturbs the base draws, and files generated with default knobs are
    byte-identical across versions.
    """
    p = params or SyntheticObsParams()
    rng = np.random.default_rng(p.seed)
    F, B, C, T = p.n_feeds, p.n_bands, p.n_channels, p.n_samples
    fs = SAMPLE_RATE

    # -- timeline: [vane][gap][scan gap]*n_scans [vane] --------------------
    features = np.zeros(T, dtype=np.int64)
    scan_flag = np.zeros(T, dtype=bool)
    t = 0
    features[t:t + p.vane_samples] = 2 ** FEATURE_VANE
    t += p.vane_samples
    scan_edges = []
    for _ in range(p.n_scans):
        t += p.gap_samples
        scan_edges.append((t, t + p.scan_samples))
        scan_flag[t:t + p.scan_samples] = True
        features[t:t + p.scan_samples] = 2 ** FEATURE_SCAN
        t += p.scan_samples
    t += p.gap_samples
    features[t:t + p.vane_samples] = 2 ** FEATURE_VANE
    scan_edges = np.asarray(scan_edges, dtype=np.int64).reshape(-1, 2)
    vane_flag = features == 2 ** FEATURE_VANE

    mjd = p.mjd_start + np.arange(T) / fs / 86400.0

    # -- pointing: CES triangle az sweeps at fixed elevation ----------------
    phase = np.cumsum(scan_flag) / fs  # seconds of scanning
    # triangle sweep: full period covers 4 x az_throw of azimuth travel,
    # so the az rate is 4*throw/period = 0.5 deg/s
    sweep_period = 4 * p.az_throw / 0.5
    tri = 2.0 * np.abs((phase / sweep_period) % 1.0 - 0.5) * 2.0 - 1.0
    az = p.az_centre + tri * p.az_throw * scan_flag
    el = p.elevation + p.el_sweep * (np.arange(T) / T - 0.5)
    # small per-feed focal-plane offsets
    feed_dx = 0.05 * rng.normal(size=F)
    feed_dy = 0.05 * rng.normal(size=F)
    az_f = az[None, :] + feed_dx[:, None]
    el_f = el[None, :] + feed_dy[:, None]
    # simple sky mapping: the az sweep scans RA, slow drift scans Dec.
    drift = 0.4 * (np.arange(T) / T - 0.5)
    dec_f = p.dec0 + (el_f - p.elevation) + drift[None, :]
    ra_f = p.ra0 + (az_f - p.az_centre) / np.cos(np.radians(dec_f))

    airmass = 1.0 / np.sin(np.radians(el_f))  # (F, T)

    # -- per-channel instrument truth --------------------------------------
    freq = _band_frequencies(B, C)  # GHz
    gain = p.gain_mean * (1.0 + p.gain_spread * rng.normal(size=(F, B, C)))
    gain = np.abs(gain).astype(np.float64)
    # receiver temperature: band-edge rise + per-channel scatter (the real
    # instrument's Tsys varies strongly across a band, which is what makes
    # the gain templates 1/Tsys distinguishable from the constant mode)
    chan = np.linspace(-1, 1, C)
    t_rx = p.t_rx * (1.0 + p.passband_curvature * chan[None, None, :] ** 2
                     + p.t_rx_scatter * rng.normal(size=(F, B, C)))
    t_rx = np.maximum(t_rx, 0.2 * p.t_rx)

    # -- time streams -------------------------------------------------------
    dg = one_over_f_noise(rng, T, p.sigma_g, p.fknee, p.alpha, fs, size=(F,))
    sky = np.zeros((F, T))
    if p.source_amplitude_k > 0:
        sky = gaussian_source_sky(ra_f, dec_f, p.ra0, p.dec0,
                                  p.source_amplitude_k, p.source_fwhm_deg)

    # additive atmospheric 1/f: per-feed, common-mode across (band, channel),
    # present only on sky (not the vane load). Separate RNG stream keeps the
    # base observation bit-identical when disabled.
    t_atm = np.zeros((F, T))
    if p.t_atm_sigma > 0:
        rng_atm = np.random.default_rng([p.seed, 101])
        t_atm = one_over_f_noise(rng_atm, T, p.t_atm_sigma, p.t_atm_fknee,
                                 p.t_atm_alpha, fs, size=(F,))

    t_sky = (p.t_cmb + p.t_atm_zenith * airmass + sky + t_atm)  # (F, T)
    t_sky_b = t_sky[:, None, :]  # (F, B, T) broadcast slot
    if p.sky_model is not None:
        # per-band sky from the model at band-centre frequency
        nu_c = freq.mean(axis=1)  # (B,) GHz
        model = np.stack([np.asarray(p.sky_model(ra_f, dec_f, nu))
                          for nu in nu_c], axis=1)  # (F, B, T)
        t_sky_b = t_sky_b + model
    t_total = t_rx[..., None] + np.where(vane_flag[None, None, None, :],
                                         p.t_vane,
                                         t_sky_b[:, :, None, :])  # (F,B,C,T)
    dnu = 2.0e9 / C  # Hz per channel
    rms_frac = 1.0 / np.sqrt(dnu / fs)
    tod = gain[..., None] * t_total * (1.0 + dg[:, None, None, :])
    tod = tod * (1.0 + rms_frac * rng.normal(size=(F, B, C, T)))
    tod = tod.astype(np.float32)

    # fault mix: spikes (x100 cosmic-ray hits) and NaN cells (dropped
    # packets), confined to scan samples so vane calibration stays clean.
    n_spikes = n_nans = 0
    if p.spike_rate > 0 or p.nan_rate > 0:
        rng_fault = np.random.default_rng([p.seed, 202])
        scan_idx = np.flatnonzero(scan_flag)
        n_cells = F * B * C * scan_idx.size
        n_spikes = int(round(p.spike_rate * n_cells))
        n_nans = int(round(p.nan_rate * n_cells))
        for count, op in ((n_spikes, "spike"), (n_nans, "nan")):
            if count <= 0 or scan_idx.size == 0:
                continue
            ff = rng_fault.integers(0, F, size=count)
            bb = rng_fault.integers(0, B, size=count)
            cc = rng_fault.integers(0, C, size=count)
            tt = scan_idx[rng_fault.integers(0, scan_idx.size, size=count)]
            if op == "spike":
                tod[ff, bb, cc, tt] *= 100.0
            else:
                tod[ff, bb, cc, tt] = np.nan

    # -- housekeeping -------------------------------------------------------
    hk_n = max(T // 5, 2)  # ~10 Hz housekeeping
    hk_idx = np.linspace(0, T - 1, hk_n).astype(int)
    hk_utc = mjd[hk_idx]
    lissajous = scan_flag[hk_idx].astype(np.int64)
    # sensors store centi-Kelvin above 0 C (DataHandling.py:322-325)
    tvane_raw = np.full(hk_n, (p.t_vane - 273.15) * 100.0)
    tshroud_c = ((p.t_vane - 213.0) / 0.2702) - 273.15
    tshroud_raw = np.full(hk_n, tshroud_c * 100.0)

    store = HDF5Store(name="synthetic_level1")
    store["spectrometer/tod"] = tod
    store["spectrometer/MJD"] = mjd
    store["spectrometer/features"] = features
    store["spectrometer/feeds"] = np.arange(1, F + 1, dtype=np.int64)
    store["spectrometer/bands"] = np.arange(B, dtype=np.int64)
    store["spectrometer/frequency"] = freq
    store["spectrometer/pixel_pointing/pixel_ra"] = ra_f
    store["spectrometer/pixel_pointing/pixel_dec"] = dec_f
    store["spectrometer/pixel_pointing/pixel_az"] = az_f
    store["spectrometer/pixel_pointing/pixel_el"] = el_f
    store["hk/antenna0/deTracker/lissajous_status"] = lissajous
    store["hk/antenna0/deTracker/utc"] = hk_utc
    store["hk/antenna0/vane/Tvane"] = tvane_raw
    store["hk/antenna0/vane/Tshroud"] = tshroud_raw
    store.set_attrs("comap", "obsid", p.obsid)
    store.set_attrs("comap", "source", f"{p.source},sky")
    store.set_attrs("comap", "comment", p.comment)

    tsys_truth = t_rx + p.t_cmb + p.t_atm_zenith * np.mean(airmass)
    p.truth = dict(
        gain=gain,
        tsys=np.broadcast_to(tsys_truth, (F, B, C)).copy(),
        dg=dg,
        scan_edges=scan_edges,
        vane_flag=vane_flag,
        frequency=freq,
        ra=ra_f, dec=dec_f,
        sky=sky,
        t_vane=p.t_vane,
        t_atm=t_atm,
        noise=dict(rms_frac=rms_frac, sigma_g=p.sigma_g, fknee=p.fknee,
                   alpha=p.alpha, t_atm_sigma=p.t_atm_sigma,
                   t_atm_fknee=p.t_atm_fknee, t_atm_alpha=p.t_atm_alpha),
        n_spikes=n_spikes, n_nans=n_nans,
    )
    return p, store


def generate_level1_file(filename: str, params: SyntheticObsParams | None = None
                         ) -> SyntheticObsParams:
    """Write a synthetic Level-1 HDF5 file; returns params with ``truth``
    filled in (per-channel gain/tsys, dg time stream, scan edges, sky)."""
    p, store = generate_level1_store(params)
    store.write(filename)
    return p
